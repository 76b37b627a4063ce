"""Hierarchical active-set compaction and the shared bounded ragged gather.

Counterpart of ``repro/core/compaction.py``.  The event-driven delivery
paths (the monolithic ``event`` engine and the partitioned ``event`` and
``blocked`` exchange schemes) reduce a boolean spike vector to a
fixed-capacity list of active indices, then gather those indices' fan-out
synapse runs into a bounded slot budget.

:func:`two_level_active` compacts in two levels, as the reference does:
the per-128-block any-spike mask first, then only the lanes of the first
``block_capacity`` active blocks.  Under overflow the kept set is the
hierarchical prefix (the first active blocks, then the first active
neurons within them), ascending, so drop accounting stays exact.

The reference's bounded ``jnp.where(mask, size=K, fill_value=f)`` is
:func:`compact`: an inclusive cumsum gives each set lane its rank, and
the lanes ranked below K are scattered into a ``[K]`` list prefilled with
``f``.  Unlike ``torch.nonzero`` it needs no read-back of the count to the
host, so a step never waits for the device here.
"""

from __future__ import annotations

import torch

BLOCK = 128   # compaction granularity; matches the blocked engine's tile


def n_blocks(n: int, block: int = BLOCK) -> int:
    """Number of ``block``-sized blocks covering ``n`` lanes (ceil div)."""
    return -(-n // block)


def derived_block_capacity(n: int, spike_capacity: int,
                           block: int = BLOCK) -> int:
    """Default block budget when a config leaves it 0: ``spike_capacity``
    blocks always suffice (capped at the total block count)."""
    return max(1, min(n_blocks(n, block), spike_capacity))


def compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The indices of the set lanes of ``mask`` [m], ascending, in a
    ``[size]`` int32 list: the first ``size`` of them, then ``fill``."""
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return out[:size]


def two_level_active(spikes: torch.Tensor, spike_capacity: int,
                     block_capacity: int, block: int = BLOCK) -> torch.Tensor:
    """Compact spiking indices into ``[spike_capacity]`` int32, ascending,
    with ``n`` marking unused slots; under overflow, the first
    ``block_capacity`` active blocks, then the first ``spike_capacity``
    active neurons within them."""
    n = spikes.shape[0]
    nb = n_blocks(n, block)
    spp = torch.zeros(nb * block, dtype=torch.bool, device=spikes.device)
    spp[:n] = spikes
    spp = spp.reshape(nb, block)
    bids = compact(spp.any(dim=1), block_capacity, nb)
    bvalid = bids < nb
    sub = spp[bids.clamp(max=nb - 1).long()] & bvalid[:, None]
    loc = compact(sub.reshape(-1), spike_capacity, block_capacity * block)
    lvalid = loc < block_capacity * block
    b = torch.clamp(loc // block, max=block_capacity - 1).long()
    gid = bids[b] * block + loc % block
    return torch.where(lvalid, gid, n).to(torch.int32)


def slot_owner(seg_end: torch.Tensor, syn_budget: int) -> torch.Tensor:
    """owner[s] = #{k : seg_end[k] <= s} for s in [0, syn_budget): a unit
    bump at each segment end, then an inclusive cumsum."""
    bump = torch.zeros(syn_budget + 1, dtype=torch.int32,
                       device=seg_end.device)
    bump.index_add_(0, seg_end.clamp(max=syn_budget).long(),
                    torch.ones_like(seg_end, dtype=torch.int32))
    return torch.cumsum(bump[:syn_budget], 0, dtype=torch.int32)


def ragged_slots(ids: torch.Tensor, indptr: torch.Tensor, syn_budget: int, *,
                 invalid_from: int, gather_size: int):
    """Assign the fan-out synapse runs of compacted ``ids`` [K] (values
    ``>= invalid_from`` are unused slots) to a bounded flat slot budget,
    against the CSR row pointers ``indptr`` [invalid_from + 1].

    Returns ``(syn_ix [S_cap] int64, ok [S_cap] bool, total int32)``:
    gather indices per slot, slot validity, and the synapse count the
    valid ids request (``total - sum(ok)`` were dropped to the budget).
    """
    k = ids.shape[0]
    valid = ids < invalid_from
    safe = ids.clamp(max=invalid_from - 1).long()
    starts = torch.where(valid, indptr[safe], 0)
    lens = torch.where(valid, indptr[safe + 1] - indptr[safe], 0)
    seg_end = torch.cumsum(lens, 0, dtype=torch.int32)
    total = seg_end[-1]
    owner_c = slot_owner(seg_end, syn_budget).clamp(max=k - 1).long()
    prev_end = torch.where(owner_c > 0, seg_end[(owner_c - 1).clamp(min=0)],
                           0)
    slot = torch.arange(syn_budget, dtype=torch.int32, device=ids.device)
    syn_ix = torch.clamp(starts[owner_c] + slot - prev_end, 0,
                         gather_size - 1).long()
    ok = slot < torch.clamp(total, max=syn_budget)
    return syn_ix, ok, total


def active_fanout_total(spikes: torch.Tensor, indptr: torch.Tensor
                        ) -> torch.Tensor:
    """Exact number of synapses the spike vector requests (int32): the
    drop-accounting ground truth, whatever the compaction kept."""
    fo = indptr[1:] - indptr[:-1]
    return torch.where(spikes, fo, 0).sum().to(torch.int32)


__all__ = ["BLOCK", "active_fanout_total", "compact",
           "derived_block_capacity", "n_blocks", "ragged_slots",
           "slot_owner", "two_level_active"]
