"""The LIF step as a CUDA kernel, in float32 and in int32 Q19.12.

Counterpart of ``repro/kernels/lif/kernel.py``:

================= ============================================ ==============
wrapper           replaces                                     CUDA source
================= ============================================ ==============
lif_update_f32    lif_update_f32 -> _pallas_lif (kernel.py:103) lif_update.cu
lif_update_fx32   lif_update_fx32 -> _pallas_lif (:115)          lif_update.cu
================= ============================================ ==============

The TPU kernel walks ``[rows, 128]`` tiles; here one thread owns one
neuron of a flat array and applies ``kernels/include/lif.cuh`` (the body
the fused delivery->LIF kernel also runs), so no padding is needed.  A
wrapper takes the plain version (:mod:`.ref`) for tensors on the CPU and
launches its kernel for tensors on a CUDA device, or raises.
``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.core.neuron import LIFParams
from repro_torch.kernels import build
from .ref import lif_update_fx_ref, lif_update_ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "lif_update.cu")
SOURCES = {"lif_update_f32": SOURCE, "lif_update_fx32": SOURCE}

#: Kernel launches per wrapper (plain-version calls are not counted).
LAUNCHES = {name: 0 for name in SOURCES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"lif_update_f32": [_P] * 10 + [_I] + [_F] * 5 + [_I, _P],
             "lif_update_fx32": [_P] * 10 + [_I] * 7 + [_P]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name, plain, v, g, refrac, g_in, v_in, force, params, sdt,
            scalars):
    dev = v.device
    for arg, x, dt in (("v", v, sdt), ("g", g, sdt), ("refrac", refrac,
                                                      torch.int32),
                       ("g_in", g_in, sdt), ("v_in", v_in, sdt),
                       ("force", force, torch.int32)):
        build.check_tensor(arg, x, dt, v.shape, dev)
    if dev.type == "cpu":
        return plain(v, g, refrac, g_in, v_in, force, params=params)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    outs = (torch.empty_like(v), torch.empty_like(g),
            torch.empty_like(refrac), torch.empty_like(refrac))
    rc = build.function(SOURCES[name], f"{name}_launch", _ARGTYPES[name])(
        v.data_ptr(), g.data_ptr(), refrac.data_ptr(), g_in.data_ptr(),
        v_in.data_ptr(), force.data_ptr(), *(o.data_ptr() for o in outs),
        v.numel(), *scalars, params.ref_steps, build.stream(dev))
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return outs


def lif_update_f32(v, g, refrac, g_in, v_in, force, *, params: LIFParams):
    """One float32 LIF step per element.  v, g, g_in, v_in float32 (mV);
    refrac, force int32; all of one shape, contiguous.  ``v_in`` is always
    added, as the reference kernel adds it (a zero still flushes a
    subnormal ``v``).  Returns ``(v, g, refrac, spikes int32)``."""
    p = params
    return _launch("lif_update_f32", lif_update_ref, v, g, refrac, g_in,
                   v_in, force, params, torch.float32,
                   (p.alpha_m, p.v0, p.decay_g, p.v_th, p.v_r))


def lif_update_fx32(v, g, refrac, g_in, v_in, force, *, params: LIFParams):
    """One Q19.12 LIF step per element.  v, g int32 Q19.12; g_in, v_in raw
    int32 weight units; refrac, force int32."""
    p = params
    return _launch("lif_update_fx32", lif_update_fx_ref, v, g, refrac, g_in,
                   v_in, force, params, torch.int32,
                   (p.fx_v0, p.fx_alpha_m16, p.fx_gdecay16, p.fx_v_th,
                    p.fx_v_r))


__all__ = ["LAUNCHES", "SOURCE", "SOURCES", "lif_update_f32",
           "lif_update_fx32", "reset_launches"]
