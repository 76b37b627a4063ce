"""Plain oracle for the LIF kernels: the port's own neuron math, on tensors
of any one shape.

Counterpart of ``repro/kernels/lif/ref.py``.  The reference's float kernel
takes ``g_in`` in mV and adds it; the port's ``lif_step`` takes weight units
and fuses ``g + g_units * w_scale``, so the oracle passes ``w_scale = 1``:
``fma(g_in, 1, g)`` rounds exactly as ``g + g_in`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.neuron import LIFParams, LIFState, lif_step, lif_step_fx


def _run(step, v, g, refrac, g_in, v_in, force, params):
    shape = v.shape
    st = LIFState(v=v.reshape(-1), g=g.reshape(-1), refrac=refrac.reshape(-1))
    new, spk = step(st, g_in.reshape(-1), params, v_in.reshape(-1),
                    force.reshape(-1) != 0)
    return (new.v.reshape(shape), new.g.reshape(shape),
            new.refrac.reshape(shape), spk.to(torch.int32).reshape(shape))


def lif_update_ref(v, g, refrac, g_in, v_in, force, *, params: LIFParams):
    """Float path: v, g, g_in (mV), v_in (mV) float32; refrac, force int32.
    Returns ``(v, g, refrac, spikes int32)``."""
    return _run(lif_step, v, g, refrac, g_in, v_in, force,
                dataclasses.replace(params, w_scale=1.0))


def lif_update_fx_ref(v, g, refrac, g_in, v_in, force, *, params: LIFParams):
    """Q19.12 path: v, g int32 Q19.12; g_in, v_in raw int32 weight units."""
    return _run(lif_step_fx, v, g, refrac, g_in, v_in, force, params)


__all__ = ["lif_update_fx_ref", "lif_update_ref"]
