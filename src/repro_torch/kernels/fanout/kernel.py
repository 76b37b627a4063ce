"""The ``blocked_fused`` engine's local step as two CUDA kernel launches,
delivery per synapse.

Replaces, on the local (P = 1) path, ``repro/kernels/spike_prop/kernel.py::
fused_deliver_lif_pallas`` (the port's ``fused_deliver_lif``, which the
partitioned path keeps).  :func:`fanout_step` runs one step:

============== =============================================== ============
kernel         does                                            CUDA source
============== =============================================== ============
fanout_scatter every delayed spike's fan-out added into an      fanout.cu
               int32 ``[B, n]`` sum, int32 atomics; the lanes'
               synapse events counted
fanout_lif     the sum read and cleared, the drive and the      fanout.cu
               LIF step on the ``[B, n]`` state, the spikes
============== =============================================== ============

It takes the plain version (:mod:`.ref`) for tensors on the CPU and
launches the kernels for tensors on a CUDA device, or raises.  The sum
lives in an :class:`Accumulator` the caller keeps: all zero between steps,
so no step clears it whole.  ``LAUNCHES`` counts kernel launches per
kernel.
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.core.neuron import LIFState
from repro_torch.kernels import build
from .ref import fanout_step_ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "fanout.cu")
SOURCES = {"fanout_scatter": SOURCE, "fanout_lif": SOURCE}

#: Kernel launches per kernel (plain-version calls are not counted).
LAUNCHES = {name: 0 for name in SOURCES}

#: Lane-neurons a scatter block lists: its scan of their fan-out is int32.
SPAN = 4096

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SCATTER_ARGS = [_P, _I, _L, _I] + [_P] * 6
_LIF_ARGS = ([_I] + [_P] * 5 + [_L, _P, _L, _P, _L] + [_P] * 4 + [_I, _I]
             + [_F] * 6 + [_I] * 6 + [_P])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_fanout(indptr: torch.Tensor) -> None:
    """Raise unless every source's fan-out fits the scatter's int32 scan
    (:data:`SPAN` spikes of the widest fan-out below 2**31 synapses)."""
    if indptr.numel() > 1:
        widest = int((indptr[1:] - indptr[:-1]).max())
        if widest * SPAN >= 1 << 31:
            raise ValueError(f"a fan-out of {widest} synapses is wider than "
                             f"the scatter's int32 scan takes")


class Accumulator:
    """The scatter's int32 sums on the device: one buffer, all zero between
    steps (the LIF kernel clears what the scatter added), grown to the
    largest ``B * n`` asked for."""

    def __init__(self):
        self.buf: torch.Tensor | None = None

    def get(self, numel: int, dev) -> torch.Tensor:
        if (self.buf is None or self.buf.device != dev
                or self.buf.numel() < numel):
            self.buf = None
            self.buf = torch.zeros(numel, dtype=torch.int32, device=dev)
        return self.buf[:numel]


def _channel(x, B: int, n: int, dtype, dev):
    """A drive channel as ``(tensor, stride)``: a row shared by the lanes
    stride 0, ``[B, n]`` lanes stride n; ``(None, 0)`` when absent."""
    if x is None:
        return None, 0
    x = x.to(device=dev, dtype=dtype)
    if x.numel() == n and x.shape[-1] == n:
        return x.reshape(n).contiguous(), 0
    return x.expand(B, n).contiguous(), n


def fanout_step(indptr, tgt, w, spikes: torch.Tensor, lif: LIFState, drive,
                params, fixed_point: bool, acc: Accumulator | None = None):
    """One step of the ``blocked_fused`` engine on the local path: the
    spikes ``[B, n]`` bool through the source-major fan-out list
    (``indptr [n+1]`` int64, ``tgt [nnz]`` int32, ``w [nnz]`` int16), then
    the drive and the LIF step on the ``[B, n]`` state -> ``(lif, spikes
    [B, n] bool, syn_events [B] int64)``.  ``acc`` holds the sums on a
    CUDA device (the caller keeps it across steps)."""
    dev = spikes.device
    if dev.type == "cpu":
        return fanout_step_ref(indptr, tgt, w, spikes, lif, drive, params,
                               fixed_point)
    if dev.type != "cuda":
        raise ValueError(f"fanout_step: no kernel for {dev}")
    if acc is None:
        raise ValueError("fanout_step: a CUDA step needs its Accumulator")
    B, n = spikes.shape
    total = B * n
    if total >= 1 << 31:
        raise ValueError(f"fanout_step: {B} lanes x {n} neurons do not fit "
                         f"the scatter's int32 lists")
    build.check_tensor("spikes", spikes, torch.bool, (B, n), dev)
    build.check_tensor("indptr", indptr, torch.int64, (n + 1,), dev)
    build.check_tensor("tgt", tgt, torch.int32, tuple(tgt.shape), dev)
    build.check_tensor("w", w, torch.int16, tuple(tgt.shape), dev)
    sdt = torch.int32 if fixed_point else torch.float32
    for name, x, dt in (("v", lif.v, sdt), ("g", lif.g, sdt),
                        ("refrac", lif.refrac, torch.int32)):
        build.check_tensor(name, x, dt, (B, n), dev)
    (gs, gs_st), (vm, vm_st), (fo, fo_st) = (
        _channel(x, B, n, dt, dev) for x, dt in (
            (drive.g_units, torch.float32), (drive.v_mv, torch.float32),
            (drive.force, torch.bool)))
    sums = acc.get(total, dev)
    out = LIFState(v=torch.empty_like(lif.v), g=torch.empty_like(lif.g),
                   refrac=torch.empty_like(lif.refrac))
    out_spikes = torch.empty((B, n), dtype=torch.bool, device=dev)
    events = torch.zeros(B, dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    # the slot's bytes from a 16-byte boundary on: the scatter reads 16 at
    # a time and skips the `head` bytes before the slot
    head = spikes.data_ptr() % 16
    rc = build.function(SOURCE, "fanout_scatter_launch", _SCATTER_ARGS)(
        spikes.data_ptr() - head, head, total, n, indptr.data_ptr(),
        tgt.data_ptr(), w.data_ptr(), sums.data_ptr(), events.data_ptr(),
        stream)
    build.raise_on(rc, "fanout_scatter")
    LAUNCHES["fanout_scatter"] += 1
    p = params
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = build.function(SOURCE, "fanout_lif_launch", _LIF_ARGS)(
        int(fixed_point), sums.data_ptr(), lif.v.data_ptr(),
        lif.g.data_ptr(), lif.refrac.data_ptr(), ptr(gs), gs_st, ptr(vm),
        vm_st, ptr(fo), fo_st, out.v.data_ptr(), out.g.data_ptr(),
        out.refrac.data_ptr(), out_spikes.data_ptr(), B, n, p.w_scale,
        p.alpha_m, p.v0, p.decay_g, p.v_th, p.v_r, p.fx_v0, p.fx_alpha_m16,
        p.fx_gdecay16, p.fx_v_th, p.fx_v_r, p.ref_steps, stream)
    if rc != 0:
        sums.zero_()            # what the scatter added stays nowhere
    build.raise_on(rc, "fanout_lif")
    LAUNCHES["fanout_lif"] += 1
    chans = sum(x.element_size() * (n if st == 0 else total)
                for x, st in ((gs, gs_st), (vm, vm_st), (fo, fo_st))
                if x is not None)
    build.charge("fanout_scatter", 0.0, 0.0)   # its bytes follow the spikes
    build.charge("fanout_lif", 0.0, total * (4 + 2 * 3 * 4 + 1) + chans)
    return out, out_spikes, events


__all__ = ["Accumulator", "LAUNCHES", "SOURCE", "SOURCES", "SPAN",
           "check_fanout", "fanout_step", "reset_launches"]
