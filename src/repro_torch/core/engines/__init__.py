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
delay_event  a delay a synapse: source-major packed words, each spike's
         fan-out added into a ring of pending input at its synapses'
         delays (``per_synapse_delays`` capability; no JAX counterpart)
======== ==================================================================
"""

from .base import (DeliveryEngine, available_engines, engine_integrates_lif,
                   get_engine, pending_depth, per_synapse_delays,
                   quantized_in_weights, refuse_per_synapse_delays, register)
from . import (binned, blocked, blocked_fused, csr,  # noqa: F401
               delay_event, dense, ell, event)
from .binned import BinnedEngine, BinnedState
from .blocked import BlockedEngine, BlockedState
from .blocked_fused import BlockedFusedEngine
from .csr import CsrEngine, CsrState
from .delay_event import DelayEventEngine, DelayEventState
from .dense import DenseEngine, DenseState
from .ell import EllEngine, EllState, xla_row_sum
from .event import EventEngine, EventState, auto_capacity

__all__ = [
    "BinnedEngine", "BinnedState", "BlockedEngine", "BlockedFusedEngine",
    "BlockedState", "CsrEngine", "CsrState", "DelayEventEngine",
    "DelayEventState", "DeliveryEngine", "DenseEngine", "DenseState",
    "EllEngine", "EllState", "EventEngine", "EventState", "auto_capacity",
    "available_engines", "engine_integrates_lif", "get_engine",
    "pending_depth", "per_synapse_delays", "quantized_in_weights",
    "refuse_per_synapse_delays", "register", "xla_row_sum",
]
