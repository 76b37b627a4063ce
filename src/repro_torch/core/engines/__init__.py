"""Delivery-engine registry: one module per synaptic-delivery strategy.

Importing this package registers every engine of the reference:

======== ==================================================================
dense    W @ s over a [n, n] float32 matrix (test-scale oracle; 77.6 GB
         at full FlyWire, built on the device)
ell      target-major padded gather, SSD fan-in cap (paper §3.2.4)
csr      flat scatter-add over all synapses (conventional baseline, exact
         yardstick)
event    active-set compaction + bounded ragged gather (cost follows
         activity; overruns counted exactly in ``dropped``)
binned   SAR bin-compressed histogram delivery (paper §3.2.3)
blocked  block-gated CUDA kernel over 128x128 int16 tiles
blocked_fused  blocked delivery + LIF integration fused in one kernel
         (``integrates_lif`` capability)
======== ==================================================================
"""

from .base import (DeliveryEngine, available_engines, engine_integrates_lif,
                   get_engine, quantized_in_weights, register)
from . import (binned, blocked, blocked_fused, csr, dense, ell,  # noqa: F401
               event)
from .binned import BinnedEngine, BinnedState
from .blocked import BlockedEngine, BlockedState
from .blocked_fused import BlockedFusedEngine
from .csr import CsrEngine, CsrState
from .dense import DenseEngine, DenseState
from .ell import EllEngine, EllState, xla_row_sum
from .event import EventEngine, EventState, auto_capacity

__all__ = [
    "BinnedEngine", "BinnedState", "BlockedEngine", "BlockedFusedEngine",
    "BlockedState", "CsrEngine", "CsrState", "DeliveryEngine", "DenseEngine",
    "DenseState", "EllEngine", "EllState", "EventEngine", "EventState",
    "auto_capacity", "available_engines", "engine_integrates_lif",
    "get_engine", "quantized_in_weights", "register", "xla_row_sum",
]
