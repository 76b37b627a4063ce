"""SNN-dCSR: the partitioned intermediate representation (paper §3.1.1/§3.2.2).

STACS moves the network from "global and unified" (one big CSR) to "global
and distributed" (per-partition compact adjacency lists with a cumulative
neuron-distribution list, neuron ids renumbered to be sequential in partition
order).  From there, computing core-local routing structures is
straightforward.  We reproduce that exactly:

* neurons are renumbered so partition p owns the contiguous id range
  [p*U, p*U + U) where U = padded per-partition neuron count (TPU shards need
  uniform extents — the padding neurons have no synapses and never spike);
* per-partition synapse lists are stacked into uniform [P, S_max] arrays
  (target-local, source-global) — the shard_map runtime consumes these
  directly.

Counterpart of ``repro/core/dcsr.py``, copied as numpy: the input of the
partitioned simulator (:mod:`repro_torch.core.distributed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .compress import quantize_weights
from .connectome import Connectome
from .partition import Partitioning


@dataclasses.dataclass(frozen=True)
class DCSR:
    """Partitioned, renumbered, padded network snapshot."""

    n_orig: int
    n_parts: int                # P
    part_size: int              # U (uniform, padded)
    perm: np.ndarray            # [n_orig] orig id -> new global id
    inv_perm: np.ndarray        # [P*U] new global id -> orig id (or -1 for pad)
    # synapses, stacked per partition (pad slots: src = P*U, tgt_local = U, w=0)
    syn_src: np.ndarray         # [P, S_max] int32 source NEW-global id
    syn_tgt_local: np.ndarray   # [P, S_max] int32 target local id in [0, U)
    syn_w: np.ndarray           # [P, S_max] float32 weight (weight units)
    s_max: int
    cum_neurons: np.ndarray     # [P+1] cumulative ORIGINAL neurons per part

    @property
    def n_padded(self) -> int:
        return self.n_parts * self.part_size


def build_dcsr(c: Connectome, p: Partitioning,
               quantize_bits: int | None = None,
               lane_multiple: int = 8) -> DCSR:
    n, P = c.n, p.n_parts
    sizes = np.diff(p.offsets)
    U = int(sizes.max())
    U = ((U + lane_multiple - 1) // lane_multiple) * lane_multiple

    # renumbering: orig id i in partition p at local position (i - offsets[p])
    part = p.part_of_neuron.astype(np.int64)
    local = np.arange(n, dtype=np.int64) - p.offsets[part]
    perm = part * U + local
    inv_perm = np.full(P * U, -1, dtype=np.int64)
    inv_perm[perm] = np.arange(n)

    w = c.in_weights
    if quantize_bits is not None:
        w = quantize_weights(w, quantize_bits)

    # group synapses by target partition
    tgt = np.repeat(np.arange(n, dtype=np.int64), c.fan_in)
    src = c.in_indices.astype(np.int64)
    tgt_part = part[tgt]
    order = np.argsort(tgt_part, kind="stable")
    tgt_s, src_s, w_s, part_s = tgt[order], src[order], w[order], tgt_part[order]
    counts = np.bincount(part_s, minlength=P)
    S_max = int(counts.max()) if len(counts) else 1
    S_max = ((S_max + lane_multiple - 1) // lane_multiple) * lane_multiple

    syn_src = np.full((P, S_max), P * U, dtype=np.int32)
    syn_tgt = np.full((P, S_max), U, dtype=np.int32)
    syn_w = np.zeros((P, S_max), dtype=np.float32)
    starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for q in range(P):
        s, e = starts[q], starts[q + 1]
        m = e - s
        syn_src[q, :m] = perm[src_s[s:e]]
        syn_tgt[q, :m] = (perm[tgt_s[s:e]] - q * U)
        syn_w[q, :m] = w_s[s:e]

    cum = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(sizes, out=cum[1:])
    return DCSR(n_orig=n, n_parts=P, part_size=U, perm=perm, inv_perm=inv_perm,
                syn_src=syn_src, syn_tgt_local=syn_tgt, syn_w=syn_w,
                s_max=S_max, cum_neurons=cum)


def edge_cut(d: DCSR) -> dict:
    """Exchange-neighbourhood statistics: fraction of synapses whose source
    lives on a different partition (the halo the comm schemes must cover)."""
    P, U = d.n_parts, d.part_size
    src_part = np.clip(d.syn_src // U, 0, P - 1)
    valid = d.syn_src < P * U
    local = (src_part == np.arange(P)[:, None]) & valid
    n_valid = int(valid.sum())
    return {
        "n_synapses": n_valid,
        "frac_remote": 1.0 - float(local.sum()) / max(1, n_valid),
        "s_max": d.s_max,
        "part_size": d.part_size,
    }


__all__ = ["DCSR", "build_dcsr", "edge_cut"]
