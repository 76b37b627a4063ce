"""Exchange-scheme registry: one module per partition-communication strategy.

======== ==================================================================
local    degenerate P=1 scheme (no collective): the delivery-engine
         registry; the monolithic ``simulate()`` path
bitmap   all-gather of the per-partition spike bitmap (fixed volume,
         delivery follows the local nnz)
event    all-gather of K-slot compacted active-id lists (volume follows
         activity, delivery bounded by the synapse budget)
blocked  sharded int16 tile store: event exchange across the cut, the
         tile-gated delivery kernel inside each partition; with
         ``sim.engine="blocked_fused"`` the fused delivery->LIF kernel
faulty   any of the above with injected faults (dropped or corrupted
         payloads, partition failures, stragglers); see
         :func:`configure_faulty`
======== ==================================================================
"""

from .base import (ExchangeScheme, Topology, all_gather, all_gather_group,
                   available_schemes, get_scheme, memoized_build,
                   register_scheme)
from .arrays import DistArrays, build_dist_arrays, build_src_gfo
from . import bitmap, blocked, event, faulty, local  # noqa: F401 (register)
from .bitmap import BitmapExchange
from .blocked import BlockedExchange, ShardedBlockedState
from .event import EventExchange, gather_active_events
from .faulty import ExchangeFault, FaultSpec, FaultyExchange, configure_faulty
from .local import LocalExchange

__all__ = [
    "ExchangeScheme", "Topology", "all_gather", "all_gather_group",
    "available_schemes", "get_scheme", "memoized_build", "register_scheme",
    "DistArrays", "build_dist_arrays", "build_src_gfo",
    "BitmapExchange", "BlockedExchange", "EventExchange", "LocalExchange",
    "ShardedBlockedState", "gather_active_events",
    "ExchangeFault", "FaultSpec", "FaultyExchange", "configure_faulty",
]
