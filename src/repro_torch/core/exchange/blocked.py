"""Sharded blocked scheme: the tile store partitioned over the partitions.

Counterpart of ``repro/core/exchange/blocked.py``.  Each partition owns
the 128 x 128 int16 tiles whose targets are local; the tiles' source
blocks stay global (:func:`repro_torch.kernels.spike_prop.ops.
build_blocked_sharded`).  Per step:

* the exchange is the ``event`` scheme's: compact the local delayed
  spikes, all-gather the K-slot global id lists;
* each partition scatters the gathered events into the global spike
  blocks, counts the spikes of each block (the kernels' gate), and runs
  the delivery kernel ``spike_deliver_tiles`` on its own slab of the store,
  skipping every tile whose source block is silent this step.

Delivery is exact (no synapse budget); the only drops are spikes beyond
the event capacity, counted in synapse units as the event scheme counts
them.  The scheme sums ``tiles_live`` / ``tiles_skipped`` into the run's
stats.  A trial batch's lanes (events ``[B, P*K]``) go to the kernel as
its lane axis, one launch a partition and step for all lanes, and the
counters are per lane.  With ``sim.engine = "blocked_fused"`` it reports
``fuses_lif``, and each partition's step is one launch of the fused
delivery->LIF kernel (``fused_deliver_lif``) instead; exchange, drops
and stats are unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from .arrays import build_src_gfo
from .base import Topology, memoized_build, register_scheme
from .event import capacity_overflow_fanout, gather_active_events


@dataclasses.dataclass(frozen=True)
class ShardedBlockedState:
    blk_id: torch.Tensor     # [P, n_tb, E] int32 global source block per tile
    weights: torch.Tensor    # [P, n_tb, E, SRC_BLK, TGT_BLK] int16
    src_gfo: torch.Tensor    # [P, U] int32 global fan-out of local sources
    n_sb: int = 0            # global source blocks
    tiles_stored: int = 0    # over the partitions built
    occupancy: float = 0.0


def event_spike_blocks(events: torch.Tensor, n_glob: int, n_sb: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathered events [..., P*K] (pad = ``n_glob``) -> the kernels'
    operands: ``[..., n_sb + 1, SRC_BLK]`` float32 spike blocks, the last
    the all-zero pad block, and their ``[..., n_sb + 1]`` int32 spike
    counts."""
    from repro_torch.kernels.spike_prop.kernel import SRC_BLK
    lead = events.shape[:-1]
    npad = (n_sb + 1) * SRC_BLK
    spk = torch.zeros(lead + (npad + 1,), dtype=torch.float32,
                      device=events.device)
    spk.scatter_(-1, torch.where(events < n_glob, events, npad).long(), 1.0)
    blocks = spk[..., :npad].reshape(lead + (n_sb + 1, SRC_BLK)).contiguous()
    return blocks, blocks.sum(dim=-1).to(torch.int32)


def tile_stats(blk_id: torch.Tensor, n_sb: int, nspk: torch.Tensor) -> dict:
    """Live and skipped stored tiles of one partition's [n_tb, E] rows
    this step, per lane of ``nspk`` [..., n_sb + 1] (``nspk[..., n_sb]``,
    the pad block, is always 0)."""
    stored = blk_id < n_sb
    live = (nspk[..., blk_id.long()] > 0).sum(dim=(-2, -1),
                                             dtype=torch.int32)
    return {"tiles_live": live,
            "tiles_skipped": stored.sum(dtype=torch.int32) - live}


@register_scheme
class BlockedExchange:
    name = "blocked"

    def build(self, d, sim, cap, device, parts=None) -> ShardedBlockedState:
        def build_state():
            from repro_torch.kernels.spike_prop.ops import (
                build_blocked_sharded)
            bs = build_blocked_sharded(d, device, parts)
            return ShardedBlockedState(
                blk_id=bs.blk_id, weights=bs.weights,
                src_gfo=build_src_gfo(d, device, parts), n_sb=bs.n_sb,
                tiles_stored=bs.tiles_stored, occupancy=bs.occupancy)
        key = "all" if parts is None else ",".join(map(str, parts))
        return memoized_build(
            d, f"blocked_state:{torch.device(device)}:{key}", build_state)

    def init_stats(self) -> dict:
        return {"tiles_live": 0, "tiles_skipped": 0}

    def exchange(self, state, delayed, cap, topo: Topology):
        return gather_active_events(delayed, cap, topo)

    def deliver(self, state, payload, delayed, sim, cap, topo: Topology):
        from repro_torch.kernels.spike_prop.kernel import spike_deliver_tiles
        events, idx = payload
        U = topo.part_size
        spk_pad, nspk = event_spike_blocks(events, topo.n_global, state.n_sb)
        out = spike_deliver_tiles(state.blk_id, state.weights, spk_pad, nspk)
        drop = capacity_overflow_fanout(delayed, idx, state.src_gfo, U)
        return (out.reshape(out.shape[:-2] + (-1,))[..., :U], drop,
                tile_stats(state.blk_id, state.n_sb, nspk))

    # -- fused-integration capability (sim.engine="blocked_fused") --

    def fuses_lif(self, sim) -> bool:
        from ..engines import engine_integrates_lif
        return engine_integrates_lif(sim.engine)

    def deliver_fused(self, state, payload, delayed, lif, drive, sim, cap,
                      topo: Topology):
        from repro_torch.kernels.spike_prop.ops import fused_step
        events, idx = payload
        U = topo.part_size
        spk_pad, nspk = event_spike_blocks(events, topo.n_global, state.n_sb)
        new_lif, spikes = fused_step(
            state.blk_id, state.weights, spk_pad, nspk, lif, drive, U,
            sim.params, sim.fixed_point)
        drop = capacity_overflow_fanout(delayed, idx, state.src_gfo, U)
        return (new_lif, spikes, drop,
                tile_stats(state.blk_id, state.n_sb, nspk))


__all__ = ["BlockedExchange", "ShardedBlockedState", "event_spike_blocks",
           "tile_stats"]
