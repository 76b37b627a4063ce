"""Block-gated synaptic delivery, and fused delivery -> LIF, on Hopper.

Counterpart of ``repro/kernels/spike_prop/kernel.py``.  Each TPU kernel
there has here a hand-written CUDA kernel (``csrc/``, built by
:mod:`repro_torch.kernels.build`), a wrapper, and a plain PyTorch version
of the same function:

==================== ===================================== ==================
wrapper              replaces                              CUDA source
==================== ===================================== ==================
spike_deliver_tiles  spike_deliver_pallas (kernel.py:78)   spike_deliver.cu
fused_deliver_lif    fused_deliver_lif_pallas (:196)       fused_deliver_lif.cu
==================== ===================================== ==================

Both kernels compute the delivery with one device function,
``csrc/deliver.cuh``'s ``block_sum``.  A wrapper takes the plain version
for tensors on the CPU, and launches its kernel for tensors on a CUDA
device (or raises); there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
it went through the kernels.

The tile store is int16 and source-major, ``weights[tb, e, src, tgt]``
(the reference stores float32 ``[tb, e, tgt, src]``; ``repro_torch.convert``
transposes).  The synthetic weights are integers within int16, so both
layouts give the same float32 sums.
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.core.neuron import (LIFParams, LIFState, ftz, lif_step,
                                     lif_step_fx)
from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor as _check

TGT_BLK = 128
SRC_BLK = 128

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = {"spike_deliver": os.path.join(_CSRC, "spike_deliver.cu"),
           "fused_deliver_lif": os.path.join(_CSRC, "fused_deliver_lif.cu")}

#: Kernel launches per wrapper (plain-version calls are not counted).
LAUNCHES = {name: 0 for name in SOURCES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "spike_deliver": [_P] * 5 + [_I] * 3 + [_P],
    "fused_deliver_lif": [_P] * 14 + [_I] * 4 + [_F] * 6 + [_I] * 6 + [_P],
}


def _launcher(name: str):
    """The C launch function of kernel ``name``, built on first use."""
    return build.function(SOURCES[name], f"{name}_launch", _ARGTYPES[name])


def _check_store(blk_id, weights, spk_blocks, nspk):
    if blk_id.dim() != 2 or spk_blocks.dim() != 2:
        raise ValueError("blk_id must be [n_tb, E], spk_blocks [n_sb+1, 128]")
    n_tb, E = blk_id.shape
    dev = blk_id.device
    _check("blk_id", blk_id, torch.int32, (n_tb, E), dev)
    _check("weights", weights, torch.int16, (n_tb, E, SRC_BLK, TGT_BLK), dev)
    _check("spk_blocks", spk_blocks, torch.float32,
           (spk_blocks.shape[0], SRC_BLK), dev)
    _check("nspk", nspk, torch.int32, (spk_blocks.shape[0],), dev)
    return n_tb, E, dev


def _check_aligned(weights):
    if weights.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned (the kernels copy "
                         "tile rows 16 bytes at a time)")


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _gated_tile_sums(blk_id, weights, spk_blocks, live, chunk_bytes=1 << 28):
    """out[tb, t] = sum_e live[blk_id[tb,e]] * sum_c w[tb,e,c,t] *
    spk[blk_id[tb,e], c] in float32, walking target blocks in chunks so
    that the float32 copy of the tiles stays within ``chunk_bytes``."""
    n_tb, E = blk_id.shape
    out = torch.zeros((n_tb, TGT_BLK), dtype=torch.float32,
                      device=blk_id.device)
    gated = spk_blocks * live.to(torch.float32)[:, None]
    step = max(1, chunk_bytes // max(1, E * SRC_BLK * TGT_BLK * 4))
    for a in range(0, n_tb, step):
        b = min(n_tb, a + step)
        sv = gated[blk_id[a:b].long()].reshape(b - a, 1, E * SRC_BLK)
        w = weights[a:b].to(torch.float32).reshape(b - a, E * SRC_BLK,
                                                   TGT_BLK)
        out[a:b] = torch.bmm(sv, w).reshape(b - a, TGT_BLK)
    return out


def spike_deliver_plain(blk_id, weights, spk_blocks, nspk):
    """Plain PyTorch version of :func:`spike_deliver_tiles`."""
    return _gated_tile_sums(blk_id, weights, spk_blocks, nspk > 0)


def fused_deliver_lif_plain(blk_id, weights, spk_blocks, nspk, v, g, refrac,
                            gstim=None, vin=None, force=None, *,
                            params: LIFParams, fixed_point: bool):
    """Plain PyTorch version of :func:`fused_deliver_lif`: the gated sums,
    then the port's own ``lif_step`` / ``lif_step_fx`` on the rows."""
    g_units = _gated_tile_sums(blk_id, weights, spk_blocks, nspk > 0)
    if gstim is not None:
        g_units = ftz(ftz(g_units) + ftz(gstim))
    lif = LIFState(v=v.reshape(-1), g=g.reshape(-1), refrac=refrac.reshape(-1))
    vin = None if vin is None else vin.reshape(-1)
    force = None if force is None else force.reshape(-1) != 0
    if fixed_point:
        st, spikes = lif_step_fx(
            lif, torch.round(g_units).to(torch.int32).reshape(-1), params,
            vin, force)
    else:
        st, spikes = lif_step(lif, g_units.reshape(-1), params, vin, force)
    shape = v.shape
    return (st.v.reshape(shape), st.g.reshape(shape),
            st.refrac.reshape(shape), spikes.to(torch.int32).reshape(shape))


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def spike_deliver_tiles(blk_id, weights, spk_blocks, nspk):
    """Args:
      blk_id:     [n_tb, E] int32 source block per tile slot (pad slots
                  name the all-zero block n_sb).
      weights:    [n_tb, E, SRC_BLK, TGT_BLK] int16 source-major tiles.
      spk_blocks: [n_sb + 1, SRC_BLK] float32 spikes by source block.
      nspk:       [n_sb + 1] int32 spikes per source block (the gate).
    Returns: [n_tb, TGT_BLK] float32 drive in weight units.

    Each ``blk_id`` row must be ascending with its pad slots last: the
    kernel finds a live source block's slot by searching its row.  ``ops``
    checks that order once, where a store is built or carried over
    (:func:`~repro_torch.kernels.spike_prop.ops.check_row_order`).
    """
    n_tb, E, dev = _check_store(blk_id, weights, spk_blocks, nspk)
    if dev.type == "cpu":
        return spike_deliver_plain(blk_id, weights, spk_blocks, nspk)
    if dev.type != "cuda":
        raise ValueError(f"spike_deliver_tiles: no kernel for {dev}")
    _check_aligned(weights)
    out = torch.empty((n_tb, TGT_BLK), dtype=torch.float32, device=dev)
    rc = _launcher("spike_deliver")(
        blk_id.data_ptr(), weights.data_ptr(), spk_blocks.data_ptr(),
        nspk.data_ptr(), out.data_ptr(), n_tb, E, spk_blocks.shape[0] - 1,
        build.stream(dev))
    build.raise_on(rc, "spike_deliver")
    LAUNCHES["spike_deliver"] += 1
    return out


def fused_deliver_lif(blk_id, weights, spk_blocks, nspk, v, g, refrac,
                      gstim=None, vin=None, force=None, *, params: LIFParams,
                      fixed_point: bool):
    """One call = one timestep: gated delivery, then one LIF step per
    neuron, for [n_tb, TGT_BLK] row blocks.

    The store and the spikes are as for :func:`spike_deliver_tiles`, rows
    in the same ascending order: both kernels share one delivery.
    ``v``/``g`` are float32 (mV) or int32 (Q19.12) by ``fixed_point``;
    ``refrac`` int32.  Optional channels: ``gstim`` float32 weight units,
    ``vin`` float32 mV or, when ``fixed_point``, int32 weight units already
    rounded, ``force`` int32 0/1.  Returns ``(v, g, refrac, spikes int32)``.
    """
    n_tb, E, dev = _check_store(blk_id, weights, spk_blocks, nspk)
    sdt = torch.int32 if fixed_point else torch.float32
    rows = (n_tb, TGT_BLK)
    _check("v", v, sdt, rows, dev)
    _check("g", g, sdt, rows, dev)
    _check("refrac", refrac, torch.int32, rows, dev)
    for name, x, dt in (("gstim", gstim, torch.float32), ("vin", vin, sdt),
                        ("force", force, torch.int32)):
        if x is not None:
            _check(name, x, dt, rows, dev)
    if dev.type == "cpu":
        return fused_deliver_lif_plain(
            blk_id, weights, spk_blocks, nspk, v, g, refrac, gstim, vin,
            force, params=params, fixed_point=fixed_point)
    if dev.type != "cuda":
        raise ValueError(f"fused_deliver_lif: no kernel for {dev}")
    v_out, g_out = torch.empty_like(v), torch.empty_like(g)
    refrac_out = torch.empty_like(refrac)
    spk_out = torch.empty(rows, dtype=torch.int32, device=dev)
    p = params
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    _check_aligned(weights)
    rc = _launcher("fused_deliver_lif")(
        blk_id.data_ptr(), weights.data_ptr(), spk_blocks.data_ptr(),
        nspk.data_ptr(), v.data_ptr(), g.data_ptr(), refrac.data_ptr(),
        ptr(gstim), ptr(vin), ptr(force), v_out.data_ptr(), g_out.data_ptr(),
        refrac_out.data_ptr(), spk_out.data_ptr(), n_tb, E,
        spk_blocks.shape[0] - 1, int(fixed_point), p.w_scale, p.alpha_m,
        p.v0, p.decay_g, p.v_th, p.v_r, p.fx_v0, p.fx_alpha_m16,
        p.fx_gdecay16, p.fx_v_th, p.fx_v_r, p.ref_steps, build.stream(dev))
    build.raise_on(rc, "fused_deliver_lif")
    LAUNCHES["fused_deliver_lif"] += 1
    return v_out, g_out, refrac_out, spk_out


__all__ = ["LAUNCHES", "SOURCES", "SRC_BLK", "TGT_BLK", "fused_deliver_lif",
           "fused_deliver_lif_plain", "reset_launches", "spike_deliver_plain",
           "spike_deliver_tiles"]
