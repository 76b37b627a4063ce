"""Delivery-engine registry: one module per synaptic-delivery strategy.

======== ==================================================================
csr      flat scatter-add over all synapses (conventional baseline, exact
         yardstick)
blocked  block-gated CUDA kernel over 128x128 int16 tiles
blocked_fused  blocked delivery + LIF integration fused in one kernel
         (``integrates_lif`` capability)
======== ==================================================================

The reference's ``dense``, ``ell``, ``event`` and ``binned`` engines are
not ported yet; asking for them raises ``NotImplementedError``.
"""

from .base import (DeliveryEngine, NOT_PORTED, available_engines,
                   engine_integrates_lif, get_engine, quantized_in_weights,
                   register)
from . import blocked, blocked_fused, csr  # noqa: F401 (register)
from .blocked import BlockedEngine, BlockedState
from .blocked_fused import BlockedFusedEngine
from .csr import CsrEngine, CsrState

__all__ = [
    "BlockedEngine", "BlockedFusedEngine", "BlockedState", "CsrEngine",
    "CsrState", "DeliveryEngine", "NOT_PORTED", "available_engines",
    "engine_integrates_lif", "get_engine", "quantized_in_weights",
    "register",
]
