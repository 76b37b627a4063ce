"""Event engine: active-set event-driven delivery (the Loihi-like path).

Counterpart of ``repro/core/engines/event.py``.  Compacts the spiking
neurons into a fixed-capacity index list (:mod:`repro_torch.core.
compaction`), gathers their fan-out synapse runs into a bounded synapse
budget, and scatter-adds them into their targets: cost follows activity.

Capacity overruns are counted (``dropped``), never silent: spikes beyond
``spike_capacity``/``block_capacity`` and synapses beyond ``syn_budget``
alike, as requested minus delivered synapses.  The scatter-add is
``index_add_`` into an ``[n + 1]`` buffer whose last lane takes the
unused slots; on CUDA it sums with atomics in no fixed order, which is
still exact, because the weights are integers (see the ``csr`` engine).

A trial batch's spikes ``[B, n]`` are compacted and gathered row by row,
each lane with the whole of ``cfg.capacity`` (the budgets are per lane,
as under the reference's ``vmap``), and scatter-added in one
``index_add_`` over the flattened rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..capacity import CapacityConfig
from ..compaction import (BLOCK, active_fanout_total, derived_block_capacity,
                          n_blocks, ragged_slots, row_index_add,
                          two_level_active)
from ..compress import quantize_weights
from ..connectome import Connectome
from .base import register


@dataclasses.dataclass(frozen=True)
class EventState:
    out_indptr: torch.Tensor          # [n+1] int32 fan-out row pointers
    out_tgt: torch.Tensor             # [nnz] int32
    out_w: torch.Tensor               # [nnz] float32
    n: int = 0


def auto_capacity(c: Connectome, rate_hz: float, dt_ms: float = 0.1,
                  margin: float = 4.0, fanout: str = "p99.9",
                  block: int = BLOCK) -> CapacityConfig:
    """Provision the event path's budgets for an expected activity level
    from one spike level ``Kp = margin x expected spikes/step``:
    ``spike_capacity`` = Kp floored at 64; ``block_capacity`` = Kp blocks,
    floored at 32 and capped at the block count; ``syn_budget`` = Kp mean
    fan-outs + ``margin`` x sqrt(Kp) x std + a hub cushion chosen by
    ``fanout`` (a percentile like ``"p99.9"``, ``"max"``, or ``"mean"``
    for the legacy ``cap x mean x margin`` formula)."""
    exp_spikes = max(1.0, c.n * rate_hz * dt_ms * 1e-3)
    kp = margin * exp_spikes
    cap = int(max(64, min(c.n, kp)))
    fo = np.diff(c.out_indptr)
    if fanout == "mean":
        mean_fo = max(1.0, c.nnz / c.n)
        budget = int(max(4096, cap * mean_fo * margin))
    else:
        if fanout == "max":
            hub = float(fo.max()) if c.nnz else 0.0
        elif fanout.startswith("p"):
            hub = float(np.percentile(fo, float(fanout[1:]))) if c.nnz else 0.0
        else:
            raise ValueError(
                f"unknown fanout statistic {fanout!r} "
                "(want 'mean', 'max', or a percentile like 'p99.9')")
        budget = int(max(4096, kp * fo.mean()
                         + margin * np.sqrt(kp) * fo.std() + hub))
    budget = min(budget, max(4096, int(c.nnz)))
    bcap = max(1, min(n_blocks(c.n, block), max(32, int(np.ceil(kp)))))
    return CapacityConfig(spike_capacity=cap, syn_budget=budget,
                          block_capacity=bcap)


@register
class EventEngine:
    name = "event"

    def build(self, c: Connectome, cfg, device) -> EventState:
        ow = c.out_weights
        if cfg.quantize_bits is not None:
            ow = quantize_weights(ow, cfg.quantize_bits)
        t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        return EventState(out_indptr=t(c.out_indptr.astype(np.int32)),
                          out_tgt=t(c.out_indices.astype(np.int32)),
                          out_w=t(ow.astype(np.float32)), n=c.n)

    def deliver(self, state: EventState, spikes: torch.Tensor, cfg):
        """spikes [..., n] -> (g [..., n] float32, dropped [...] int32)."""
        n = state.n
        cap = cfg.capacity
        bcap = cap.block_capacity or derived_block_capacity(
            n, cap.spike_capacity)
        act_idx = two_level_active(spikes, cap.spike_capacity, bcap)
        syn_ix, ok, total = ragged_slots(
            act_idx, state.out_indptr, cap.syn_budget, invalid_from=n,
            gather_size=state.out_tgt.shape[0])
        contrib = torch.where(ok, state.out_w[syn_ix], 0.0)
        tgt = torch.where(ok, state.out_tgt[syn_ix], n)
        g = row_index_add(n + 1, tgt, contrib)
        requested = active_fanout_total(spikes, state.out_indptr)
        delivered = torch.clamp(total, max=cap.syn_budget)
        return g[..., :n], requested - delivered


__all__ = ["EventEngine", "EventState", "auto_capacity"]
