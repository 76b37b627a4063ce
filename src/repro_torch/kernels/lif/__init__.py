"""The LIF step as its own kernel, in float32 and in int32 Q19.12 (CUDA,
sm_90a), with plain PyTorch versions beside it."""

from .ops import lif_update, lif_update_fx
from .ref import lif_update_fx_ref, lif_update_ref

__all__ = ["lif_update", "lif_update_fx", "lif_update_fx_ref",
           "lif_update_ref"]
