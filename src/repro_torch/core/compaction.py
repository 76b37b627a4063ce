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

Every function works row by row over leading axes: a trial batch's
``[B, n]`` spikes give ``[B, K]`` lists, each row what its lane alone
gives, as the reference's functions give under ``vmap``.  The row
pointers (``indptr``) are shared by all rows.
"""

from __future__ import annotations

import math

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
    """The indices of the set lanes of each row of ``mask`` [..., m],
    ascending, in a ``[..., size]`` int32 list: the first ``size`` of
    them, then ``fill``."""
    m = mask.shape[-1]
    rank = torch.cumsum(mask, -1) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full(mask.shape[:-1] + (size + 1,), fill, dtype=torch.int32,
                     device=mask.device)
    out.scatter_(-1, slot, torch.arange(m, dtype=torch.int32,
                                        device=mask.device).expand_as(slot))
    return out[..., :size]


def two_level_active(spikes: torch.Tensor, spike_capacity: int,
                     block_capacity: int, block: int = BLOCK) -> torch.Tensor:
    """Compact each row's spiking indices of ``spikes`` [..., n] into
    ``[..., spike_capacity]`` int32, ascending, with ``n`` marking unused
    slots; under overflow, the first ``block_capacity`` active blocks,
    then the first ``spike_capacity`` active neurons within them."""
    lead, n = spikes.shape[:-1], spikes.shape[-1]
    nb = n_blocks(n, block)
    spp = torch.zeros(lead + (nb * block,), dtype=torch.bool,
                      device=spikes.device)
    spp[..., :n] = spikes
    spp = spp.reshape(lead + (nb, block))
    bids = compact(spp.any(dim=-1), block_capacity, nb)
    bvalid = bids < nb
    sub = torch.take_along_dim(
        spp, bids.clamp(max=nb - 1).long()[..., None], dim=-2
    ) & bvalid[..., None]
    loc = compact(sub.reshape(lead + (-1,)), spike_capacity,
                  block_capacity * block)
    lvalid = loc < block_capacity * block
    b = torch.clamp(loc // block, max=block_capacity - 1).long()
    gid = torch.gather(bids, -1, b) * block + loc % block
    return torch.where(lvalid, gid, n).to(torch.int32)


def slot_owner(seg_end: torch.Tensor, syn_budget: int) -> torch.Tensor:
    """owner[..., s] = #{k : seg_end[..., k] <= s} for s in [0,
    syn_budget), per row: a unit bump at each segment end, then an
    inclusive cumsum."""
    bump = torch.zeros(seg_end.shape[:-1] + (syn_budget + 1,),
                       dtype=torch.int32, device=seg_end.device)
    bump.scatter_add_(-1, seg_end.clamp(max=syn_budget).long(),
                      torch.ones_like(seg_end, dtype=torch.int32))
    return torch.cumsum(bump[..., :syn_budget], -1, dtype=torch.int32)


def ragged_slots(ids: torch.Tensor, indptr: torch.Tensor, syn_budget: int, *,
                 invalid_from: int, gather_size: int):
    """Assign the fan-out synapse runs of compacted ``ids`` [..., K]
    (values ``>= invalid_from`` are unused slots) to a bounded flat slot
    budget per row, against the CSR row pointers ``indptr``
    [invalid_from + 1].

    Returns ``(syn_ix [..., S_cap] int64, ok [..., S_cap] bool, total
    [...] int32)``: gather indices per slot, slot validity, and the
    synapse count the valid ids request (``total - sum(ok)`` were dropped
    to the budget).
    """
    k = ids.shape[-1]
    valid = ids < invalid_from
    safe = ids.clamp(max=invalid_from - 1).long()
    starts = torch.where(valid, indptr[safe], 0)
    lens = torch.where(valid, indptr[safe + 1] - indptr[safe], 0)
    seg_end = torch.cumsum(lens, -1, dtype=torch.int32)
    total = seg_end[..., -1]
    owner_c = slot_owner(seg_end, syn_budget).clamp(max=k - 1).long()
    prev_end = torch.where(
        owner_c > 0,
        torch.gather(seg_end, -1, (owner_c - 1).clamp(min=0)), 0)
    slot = torch.arange(syn_budget, dtype=torch.int32, device=ids.device)
    syn_ix = torch.clamp(torch.gather(starts, -1, owner_c) + slot - prev_end,
                         0, gather_size - 1).long()
    ok = slot < torch.clamp(total, max=syn_budget)[..., None]
    return syn_ix, ok, total


def active_fanout_total(spikes: torch.Tensor, indptr: torch.Tensor
                        ) -> torch.Tensor:
    """Exact number of synapses each row of ``spikes`` [..., n] requests
    (int32 [...]): the drop-accounting ground truth, whatever the
    compaction kept."""
    fo = indptr[1:] - indptr[:-1]
    return torch.where(spikes, fo, 0).sum(dim=-1).to(torch.int32)


def row_index_add(size: int, idx: torch.Tensor, val: torch.Tensor
                  ) -> torch.Tensor:
    """``out[..., idx[..., s]] += val[..., s]`` into a zero float32
    ``[..., size]``, row by row: one ``index_add_`` over the flattened
    rows (the rows' offsets added to ``idx``)."""
    lead = idx.shape[:-1]
    rows = math.prod(lead)
    off = torch.arange(rows, dtype=torch.int64, device=idx.device) * size
    flat = (idx.reshape(rows, -1).long() + off[:, None]).reshape(-1)
    out = torch.zeros(rows * size, dtype=torch.float32, device=idx.device)
    out.index_add_(0, flat, val.reshape(-1))
    return out.reshape(lead + (size,))


__all__ = ["BLOCK", "active_fanout_total", "compact",
           "derived_block_capacity", "n_blocks", "ragged_slots",
           "row_index_add", "slot_owner", "two_level_active"]
