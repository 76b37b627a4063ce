"""Dense engine: g = W @ spikes.

The naive matmul the paper calls "computationally wasteful when the
spiking activity is sparse": cost and memory are O(n^2) whatever the
activity, the test-scale oracle every other engine is held to.  At full
FlyWire W is 139,255^2 float32 = 77.57 GB, so it is built where it is
used: zeros on the run's device, then one ``index_put_`` of the
target-major CSR (never a host [n, n] array).  The sums are exact in any
order (integer weights, partial sums below 2**24), so cuBLAS's order is
the reference's result; TF32 must stay off, since the raw weights
exceed the integers TF32 holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..connectome import Connectome
from .base import quantized_in_weights, register


@dataclasses.dataclass(frozen=True)
class DenseState:
    w: torch.Tensor                   # [n, n] f32, W[target, source]
    n: int = 0


def dense_index(c: Connectome) -> np.ndarray:
    """Flat ``target * n + source`` of every synapse, in CSR order;
    raises unless each pair occurs once (``from_edges`` condenses
    duplicates, so a scatter's order cannot matter)."""
    tgt = np.repeat(np.arange(c.n, dtype=np.int64), c.fan_in)
    flat = tgt * c.n + c.in_indices
    if not (np.all(np.diff(flat) > 0)
            or np.unique(flat).size == flat.size):
        raise ValueError("the connectome repeats a (target, source) pair")
    return flat


@register
class DenseEngine:
    name = "dense"

    def build(self, c: Connectome, cfg, device) -> DenseState:
        w = quantized_in_weights(c, cfg)
        flat = torch.from_numpy(dense_index(c)).to(device)
        dense = torch.zeros((c.n, c.n), dtype=torch.float32, device=device)
        dense.view(-1).index_put_(
            (flat,), torch.from_numpy(w.astype(np.float32)).to(device))
        return DenseState(w=dense, n=c.n)

    def deliver(self, state: DenseState, spikes: torch.Tensor, cfg):
        """spikes [..., n] -> (g [..., n] float32, dropped [...] int32)."""
        if spikes.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the dense engine needs TF32 off: "
                               "torch.backends.cuda.matmul.allow_tf32")
        lead = spikes.shape[:-1]
        s = spikes.reshape(-1, state.n).to(torch.float32)
        g = (torch.mv(state.w, s[0])[None] if s.shape[0] == 1
             else (state.w @ s.T).T)
        return (g.reshape(lead + (state.n,)),
                torch.zeros(lead, dtype=torch.int32, device=spikes.device))
