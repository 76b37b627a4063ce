"""Event scheme: all_gather of fixed-capacity compacted active-neuron lists.

Counterpart of ``repro/core/exchange/event.py``, the spike-message
analogue: the exchanged volume follows activity (K ids a partition a
step), delivery costs the events' local fan-out, bounded by a synapse
budget.  The compaction and the bounded ragged gather are the
:mod:`repro_torch.core.compaction` functions the monolithic ``event``
engine runs.  Drops (budget overruns, and spikes beyond the event
capacity) are counted exactly in synapse units through the global
fan-out table ``src_gfo``.
"""

from __future__ import annotations

import torch

from ..compaction import (derived_block_capacity, ragged_slots,
                          row_index_add, two_level_active)
from .arrays import build_dist_arrays
from .base import Topology, register_scheme


def gather_active_events(delayed: torch.Tensor, cap, topo: Topology):
    """The local half of the event exchange, shared by the ``event`` and
    sharded ``blocked`` schemes: compact this partition's delayed spikes.

    Returns ``(gid [..., K] global ids to all-gather, idx [..., K] local
    kept ids)``; pad slots are ``P*U`` and ``U``."""
    U, n_glob = topo.part_size, topo.n_global
    bcap = cap.block_capacity or derived_block_capacity(U, cap.spike_capacity)
    idx = two_level_active(delayed, cap.spike_capacity, bcap)
    gid = torch.where(idx < U, idx + topo.index * U, n_glob).to(torch.int32)
    return gid, idx


def capacity_overflow_fanout(delayed, idx, src_gfo, U: int) -> torch.Tensor:
    """Global fan-out of the spikes the bounded compaction could not keep:
    they enter no partition's event list, so their whole fan-out is
    dropped (requested minus kept, in synapse units; int32 [...])."""
    req_fo = torch.where(delayed, src_gfo, 0).sum(dim=-1)
    kept_fo = torch.where(idx < U, src_gfo[idx.clamp(max=U - 1).long()],
                          0).sum(dim=-1)
    return (req_fo - kept_fo).to(torch.int32)


def deliver_events(events: torch.Tensor, out_indptr, out_tgt, out_w,
                   U: int, n_glob: int, syn_budget: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """events: [..., E] global ids (pad = n_glob).  The bounded ragged
    gather against this partition's source-major local store, lane by
    lane -> (g [..., U], synapses dropped to the budget [...])."""
    syn_ix, ok, total = ragged_slots(
        events, out_indptr, syn_budget, invalid_from=n_glob,
        gather_size=out_tgt.shape[0])
    contrib = torch.where(ok, out_w[syn_ix], 0.0)
    tgt = torch.where(ok, out_tgt[syn_ix], U)
    g = row_index_add(U + 1, tgt, contrib)
    return g[..., :U], torch.clamp(total - syn_budget, min=0)


@register_scheme
class EventExchange:
    name = "event"

    def build(self, d, sim, cap, device, parts=None):
        return build_dist_arrays(d, device, parts)

    def init_stats(self) -> dict:
        return {}

    def exchange(self, state, delayed, cap, topo: Topology):
        return gather_active_events(delayed, cap, topo)

    def deliver(self, state, payload, delayed, sim, cap, topo: Topology):
        events, idx = payload
        U, n_glob = topo.part_size, topo.n_global
        g, drop = deliver_events(events, state.out_indptr, state.out_tgt,
                                 state.out_w, U, n_glob, cap.syn_budget)
        drop = drop.to(torch.int32) + capacity_overflow_fanout(
            delayed, idx, state.src_gfo, U)
        return g, drop, {}


__all__ = ["EventExchange", "capacity_overflow_fanout", "deliver_events",
           "gather_active_events"]
