"""Delivery-engine registry: one module per synaptic-delivery strategy.

======== ==================================================================
csr      flat scatter-add over all synapses (conventional baseline, exact
         yardstick)
blocked  block-gated CUDA kernel over 128x128 int16 tiles
event    active-set compaction + bounded ragged gather (cost follows
         activity; overruns counted exactly in ``dropped``)
blocked_fused  blocked delivery + LIF integration fused in one kernel
         (``integrates_lif`` capability)
======== ==================================================================

The reference's ``dense``, ``ell`` and ``binned`` engines are not ported
yet; asking for them raises ``NotImplementedError``.
"""

from .base import (DeliveryEngine, NOT_PORTED, available_engines,
                   engine_integrates_lif, get_engine, quantized_in_weights,
                   register)
from . import blocked, blocked_fused, csr, event  # noqa: F401 (register)
from .blocked import BlockedEngine, BlockedState
from .blocked_fused import BlockedFusedEngine
from .csr import CsrEngine, CsrState
from .event import EventEngine, EventState, auto_capacity

__all__ = [
    "BlockedEngine", "BlockedFusedEngine", "BlockedState", "CsrEngine",
    "CsrState", "DeliveryEngine", "EventEngine", "EventState", "NOT_PORTED",
    "auto_capacity", "available_engines",
    "engine_integrates_lif", "get_engine", "quantized_in_weights",
    "register",
]
