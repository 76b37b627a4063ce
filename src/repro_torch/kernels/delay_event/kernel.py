"""The delay_event engine's step as two CUDA kernel launches.

No counterpart in ``repro/kernels/``: the JAX package's delay is one
uniform ring of spikes.  :func:`delay_step` runs a step of
:class:`repro_torch.core.engines.delay_event.DelayEventEngine`:

============ ================================================= =============
kernel       does                                              CUDA source
============ ================================================= =============
pending_lif  the pending slot's read and zeroing, the count     delay_event.cu
             drive, the LIF step, the step's spike list
delay_deliver every spike's fan-out into the ring at each       delay_event.cu
             synapse's delay, int32 atomics
============ ================================================= =============

It takes the plain version (:mod:`.ref`) for tensors on the CPU and
launches the kernels for tensors on a CUDA device, or raises.  The
step's spike list and its counters (``[1 + 2B]`` int64: the list's
length, then each lane's drive events and synapse events) are made on the
device each step, so nothing waits on the host.  ``LAUNCHES`` counts
kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.core.neuron import LIFState
from repro_torch.kernels import build
from .ref import delay_step_ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "delay_event.cu")

#: Kernel launches per kernel (plain-version calls are not counted).
LAUNCHES = {"pending_lif": 0, "delay_deliver": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_LIF_ARGS = ([_I] + [_P] * 13 + [_I, _F] + [_P] * 3 + [_L, _L] + [_F] * 6
             + [_I] * 6 + [_P])
_DELIVER_ARGS = [_P] * 6 + [_L, _L] + [_I] * 5 + [_P]

_SMS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lanes(x, shape, dtype, dev):
    """A drive channel as a contiguous ``shape`` tensor (None when absent);
    a channel shared by the lanes is broadcast."""
    if x is None:
        return None
    return x.to(device=dev, dtype=dtype).expand(shape).contiguous()


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def delay_step(state, pending: torch.Tensor, ptr: int, lif: LIFState, drive,
               params, fixed_point: bool):
    """One step of the engine on ``pending`` ``[D, B, n]`` int32 (updated in
    place) -> ``(lif, spikes [B, n] bool, stats)``, ``stats`` the lanes'
    ``syn_events`` and ``drive_events`` (``[B]`` int64 each)."""
    dev = pending.device
    if dev.type == "cpu":
        return delay_step_ref(state.indptr, state.words, state.tgt_bits,
                              state.w_bits, pending, ptr, lif, drive, params,
                              fixed_point)
    if dev.type != "cuda":
        raise ValueError(f"delay_step: no kernel for {dev}")
    D, B, n = pending.shape
    total = B * n
    if total >= 1 << 31:
        raise ValueError(f"delay_step: {B} lanes x {n} neurons do not fit "
                         f"the spike list's int32 entries")
    build.check_tensor("pending", pending, torch.int32, (D, B, n), dev)
    sdt = torch.int32 if fixed_point else torch.float32
    for name, x, dt in (("v", lif.v, sdt), ("g", lif.g, sdt),
                        ("refrac", lif.refrac, torch.int32)):
        build.check_tensor(name, x, dt, (B, n), dev)
    out = LIFState(v=torch.empty_like(lif.v), g=torch.empty_like(lif.g),
                   refrac=torch.empty_like(lif.refrac))
    spikes = torch.empty((B, n), dtype=torch.bool, device=dev)
    spike_list = torch.empty(total, dtype=torch.int32, device=dev)
    scratch = torch.zeros(1 + 2 * B, dtype=torch.int64, device=dev)
    draw = drive.counts
    if draw is not None:
        build.check_tensor("bits", draw.bits, torch.int64, (B, n), dev)
        build.check_tensor("pop", draw.pop, torch.int32, (n,), dev)
        build.check_tensor("table", draw.table, torch.int64,
                           tuple(draw.table.shape), dev)
    p = params
    g_units, v_mv, force = (_lanes(x, (B, n), dt, dev) for x, dt in (
        (drive.g_units, torch.float32), (drive.v_mv, torch.float32),
        (drive.force, torch.bool)))
    stream = build.stream(dev)
    rc = build.function(SOURCE, "pending_lif_launch", _LIF_ARGS)(
        int(fixed_point), pending[ptr].data_ptr(), lif.v.data_ptr(),
        lif.g.data_ptr(), lif.refrac.data_ptr(), out.v.data_ptr(),
        out.g.data_ptr(), out.refrac.data_ptr(), spikes.data_ptr(),
        spike_list.data_ptr(), scratch.data_ptr(),
        0 if draw is None else draw.bits.data_ptr(),
        0 if draw is None else draw.pop.data_ptr(),
        0 if draw is None else draw.table.data_ptr(),
        0 if draw is None else draw.table.shape[1],
        0.0 if draw is None else draw.weight,
        _ptr(g_units), _ptr(v_mv), _ptr(force),
        n, total, p.w_scale, p.alpha_m, p.v0, p.decay_g, p.v_th, p.v_r,
        p.fx_v0, p.fx_alpha_m16, p.fx_gdecay16, p.fx_v_th, p.fx_v_r,
        p.ref_steps, stream)
    build.raise_on(rc, "pending_lif")
    LAUNCHES["pending_lif"] += 1
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    rc = build.function(SOURCE, "delay_deliver_launch", _DELIVER_ARGS)(
        spike_list.data_ptr(), scratch.data_ptr(),
        scratch[1 + B:].data_ptr(), state.indptr.data_ptr(),
        state.words.data_ptr(), pending.data_ptr(), n, total, D, ptr,
        state.tgt_bits, state.w_bits, sms, stream)
    build.raise_on(rc, "delay_deliver")
    LAUNCHES["delay_deliver"] += 1
    state_bytes = 2 * (4 + 4 + 4) + 2 * 4 + 1
    build.charge("pending_lif", 0.0, total * state_bytes)
    build.charge("delay_deliver", 0.0, 0.0)   # its bytes follow the spikes
    return out, spikes, {"syn_events": scratch[1 + B:],
                         "drive_events": scratch[1:1 + B]}


__all__ = ["LAUNCHES", "SOURCE", "delay_step",
           "reset_launches"]
