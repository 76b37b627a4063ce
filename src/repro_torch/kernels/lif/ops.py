"""Public entry points of the LIF kernels on flat ``[n]`` state.

Counterpart of ``repro/kernels/lif/ops.py``: absent ``v_in`` and ``force``
become zeros (the reference kernel always reads both), and the float or the
Q19.12 kernel runs.  Unlike the reference, nothing is padded to
``[rows, 128]``: the CUDA kernel takes any ``n``.
"""

from __future__ import annotations

import torch

from repro_torch.core.neuron import LIFParams, LIFState
from .kernel import lif_update_f32, lif_update_fx32


def _args(state, g_in, v_in, force, sdt):
    dev = state.v.device
    cast = lambda x, dt: x.to(device=dev, dtype=dt).contiguous()  # noqa: E731
    zeros = torch.zeros(state.v.shape, dtype=sdt, device=dev)
    return (cast(state.v, sdt), cast(state.g, sdt),
            cast(state.refrac, torch.int32), cast(g_in, sdt),
            zeros if v_in is None else cast(v_in, sdt),
            torch.zeros(state.v.shape, dtype=torch.int32, device=dev)
            if force is None else cast(force, torch.int32))


def _result(out):
    v, g, refrac, spk = out
    return LIFState(v=v, g=g, refrac=refrac), spk != 0


def lif_update(state: LIFState, g_in, params: LIFParams, v_in=None,
               force=None) -> tuple[LIFState, torch.Tensor]:
    """Flat ``[n]`` float32 step (``g_in``, ``v_in`` in mV).  Returns
    ``(LIFState, spikes bool[n])``."""
    return _result(lif_update_f32(*_args(state, g_in, v_in, force,
                                         torch.float32), params=params))


def lif_update_fx(state: LIFState, g_in_units, params: LIFParams,
                  v_in_units=None, force=None
                  ) -> tuple[LIFState, torch.Tensor]:
    """Flat ``[n]`` int32 Q19.12 step (``g_in_units``, ``v_in_units`` raw
    weight units)."""
    return _result(lif_update_fx32(*_args(state, g_in_units, v_in_units,
                                          force, torch.int32),
                                   params=params))


__all__ = ["lif_update", "lif_update_fx"]
