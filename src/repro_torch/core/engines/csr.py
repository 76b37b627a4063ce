"""CSR engine: flat scatter-add over all synapses.

Cost is proportional to nnz, independent of activity: the conventional
baseline of the paper's Table 1 and the exactness yardstick for every
other engine.  ``index_add_`` on CUDA sums with atomics, in a different
order on every run; the sums are still exact, because the weights are
integers and every partial sum of a neuron's drive stays below 2**24
(at full FlyWire size, 28,373 inputs x 256 with 9-bit weights), where
float32 holds integers exactly.
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
        contrib = state.w * spikes[state.src].to(torch.float32)
        g = torch.zeros(state.n, dtype=torch.float32, device=spikes.device)
        g.index_add_(0, state.tgt, contrib)
        return g, torch.zeros((), dtype=torch.int32, device=spikes.device)
