"""CSR engine: flat scatter-add over all synapses.

Cost is proportional to nnz, independent of activity: the conventional
baseline of the paper's Table 1 and the exactness yardstick for every
other engine.  ``index_add_`` on CUDA sums with atomics, in a different
order on every run; the sums are still exact, because the weights are
integers and every partial sum of a neuron's drive stays below 2**24
(at full FlyWire size, 28,373 inputs x 256 with 9-bit weights), where
float32 holds integers exactly.

A trial batch's spikes ``[B, n]`` are gathered as one ``[nnz, B]``
matrix and scatter-added row-wise in one ``index_add_``: each lane's sum
is its own, and the synapse lists are read once for all lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..connectome import Connectome
from .base import quantized_in_weights, register


@dataclasses.dataclass(frozen=True)
class CsrState:
    src: torch.Tensor                 # [nnz] int32 source per synapse
    tgt: torch.Tensor                 # [nnz] int32 target per synapse
    w: torch.Tensor                   # [nnz] float32
    n: int = 0


@register
class CsrEngine:
    name = "csr"

    def build(self, c: Connectome, cfg, device) -> CsrState:
        w = quantized_in_weights(c, cfg)
        tgt = np.repeat(np.arange(c.n, dtype=np.int32), c.fan_in)
        return CsrState(
            src=torch.from_numpy(c.in_indices.astype(np.int32)).to(device),
            tgt=torch.from_numpy(tgt).to(device),
            w=torch.from_numpy(w.astype(np.float32)).to(device), n=c.n)

    def deliver(self, state: CsrState, spikes: torch.Tensor, cfg):
        """spikes [..., n] -> (g [..., n] float32, dropped [...] int32)."""
        return (deliver_csr(spikes, state.src, state.tgt, state.w, state.n),
                torch.zeros(spikes.shape[:-1], dtype=torch.int32,
                            device=spikes.device))


def deliver_csr(spikes: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                w: torch.Tensor, n_out: int) -> torch.Tensor:
    """``g[..., tgt[s]] += w[s] * spikes[..., src[s]]`` over the synapses
    s, into a zero ``[..., n_out]`` (a target ``n_out`` lands in a
    discarded row): the lanes side by side in one gather and one
    ``index_add_`` of ``[nnz, B]`` rows."""
    lead = spikes.shape[:-1]
    cols = spikes.reshape(-1, spikes.shape[-1]).T       # [n, B]
    contrib = w[:, None] * cols[src].to(torch.float32)
    g = torch.zeros((n_out + 1, cols.shape[1]), dtype=torch.float32,
                    device=spikes.device)
    g.index_add_(0, tgt, contrib)
    return g[:n_out].T.reshape(lead + (n_out,))
