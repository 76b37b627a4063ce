"""Oracles for the block-gated spike delivery kernel.

Counterpart of ``repro/kernels/spike_prop/ref.py``: two references that
check the delivery from outside, not ports of a kernel.

* :func:`spike_deliver_dense_ref` multiplies the dense [n, n] weight
  matrix of the connectome by the spikes (float32, TF32 off): it checks
  the blocked store's builder and the kernel together.
* :func:`spike_deliver_ref` sums the tiles of a blocked store with one
  einsum, written apart from :func:`repro_torch.kernels.spike_prop.
  kernel.spike_deliver_plain` (no gate, no chunks, no ``bmm``): it checks
  the kernel's mechanics and that plain version against the same store.

The port's tiles are source-major (``weights[tb, e]`` is ``[SRC_BLK,
TGT_BLK]``), the reference's target-major; both oracles give each
target's sum over its sources.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.connectome import Connectome
from repro_torch.core.engine import resolve_device

from .kernel import SRC_BLK


def spike_deliver_dense_ref(c: Connectome, spikes,
                            quantized: np.ndarray | None = None,
                            device=None) -> torch.Tensor:
    """Oracle 1: dense W @ s over the original connectome ([n] float32 on
    ``device``, default the CUDA device).  As in the reference, the
    matrix is filled by one numpy assignment (a repeated (target, source)
    pair keeps its last weight)."""
    device = resolve_device(device)
    w = quantized if quantized is not None else c.in_weights
    dense = np.zeros((c.n, c.n), np.float32)
    tgt = np.repeat(np.arange(c.n), c.fan_in)
    dense[tgt, c.in_indices] = w.astype(np.float32)
    s = torch.as_tensor(np.asarray(spikes.cpu() if torch.is_tensor(spikes)
                                   else spikes), dtype=torch.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.from_numpy(dense).to(device) @ s.to(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def spike_deliver_ref(bs, spikes) -> torch.Tensor:
    """Oracle 2: the tile sums of the blocked store ``bs``
    (:func:`repro_torch.kernels.spike_prop.ops.build_blocked`) as one
    einsum, on the store's device: [n] float32."""
    n, n_sb = bs.n, bs.n_sb
    dev = bs.weights.device
    spk = torch.as_tensor(spikes, dtype=torch.float32).reshape(-1).to(dev)
    spk = torch.nn.functional.pad(spk, (0, n_sb * SRC_BLK - n))
    blocks = torch.cat([spk.reshape(n_sb, SRC_BLK),
                        torch.zeros((1, SRC_BLK), device=dev)])
    sv = blocks[bs.blk_id.long()]                   # [n_tb, E, SRC_BLK]
    out = torch.einsum("tesb,tes->tb", bs.weights.to(torch.float32), sv)
    return out.reshape(-1)[:n]


__all__ = ["spike_deliver_dense_ref", "spike_deliver_ref"]
