"""Bitmap scheme: all_gather of the per-partition spike bitmap.

Counterpart of ``repro/core/exchange/bitmap.py``: one aggregated message
per core pair, the paper's shared-synaptic-delivery analogue.  The
exchanged volume is fixed (P*U flags a step); delivery costs the local
nnz (a target-major gather and scatter-add against the partition's
in-CSR with global source ids).  Exact: nothing is ever dropped.
"""

from __future__ import annotations

import torch

from ..engines.csr import deliver_csr
from .arrays import build_dist_arrays
from .base import Topology, register_scheme


def deliver_bitmap(spk_global: torch.Tensor, arr_src, arr_tgt, arr_w,
                   U: int) -> torch.Tensor:
    """spk_global: [..., P*U] bool; local in-CSR gather + scatter-add ->
    [..., U] (pad synapses read a zero spike and land in a discarded
    row)."""
    lead, n = spk_global.shape[:-1], spk_global.shape[-1]
    spk_pad = torch.zeros(lead + (n + 1,), dtype=torch.bool,
                          device=spk_global.device)
    spk_pad[..., :n] = spk_global
    return deliver_csr(spk_pad, arr_src, arr_tgt, arr_w, U)


@register_scheme
class BitmapExchange:
    name = "bitmap"

    def build(self, d, sim, cap, device, parts=None):
        return build_dist_arrays(d, device, parts)

    def init_stats(self) -> dict:
        return {}

    def exchange(self, state, delayed, cap, topo: Topology):
        return delayed, None

    def deliver(self, state, payload, delayed, sim, cap, topo: Topology):
        g = deliver_bitmap(payload[0], state.syn_src, state.syn_tgt,
                           state.syn_w, topo.part_size)
        return g, torch.zeros(g.shape[:-1], dtype=torch.int32,
                              device=g.device), {}
