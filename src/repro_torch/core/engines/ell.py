"""ELL engine: target-major padded gather (the SSD-capped format).

Each target row holds up to ``ell_width_cap`` (source, weight) slots; rows
over the cap keep a uniform sample, rescaled (paper §3.2.4, built by
:func:`repro_torch.core.compress.ell_entries`).  Cost follows n * width,
whatever the activity, but is regular.  The format is scattered onto the
device from its entries (31.6 GB at full FlyWire uncapped), and the
per-step gather ``spikes[idx] * w`` runs over row chunks, so that its
temporary stays near :data:`CHUNK_ELEMS` elements for every lane count;
a row's sum is never split.  A row within the cap holds integer
weights, whose sum is exact in any order: it is summed by ``torch.sum``
(a negative zero made +0, as XLA's reduction from +0 leaves it).  The
rows over the cap hold rescaled, non-integer weights: they are summed
again in the order of XLA's CPU reduction (:func:`xla_row_sum`), so their
sums are the reference's bits too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compress import ell_entries
from ..connectome import Connectome
from .base import register

#: Elements of one chunk's gather temporary (float32: 1 GiB).
CHUNK_ELEMS = 1 << 28

XLA_WINDOW = 32


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU code, which the
    reference's ``x.sum(axis=-1)`` compiles to: a row longer than 32 is
    cut into windows of 32 (padded with zeros, ``tot // 2`` of them
    before the row and the rest after it), each window summed left to
    right from 0, and the window sums reduced the same way until 32 or
    fewer remain, which are summed left to right from 0 (a single one is
    returned as it is, a negative zero kept).  On integer values every
    order gives the same sum; on the rescaled rows over the fan-in cap
    only this order gives the reference's float32 bits."""
    while x.shape[-1] > XLA_WINDOW:
        tot = -x.shape[-1] % XLA_WINDOW
        x = torch.nn.functional.pad(x, (tot // 2, tot - tot // 2))
        x = x.reshape(x.shape[:-1] + (-1, XLA_WINDOW))
        x = _left_to_right(x)
    return _left_to_right(x)


def _left_to_right(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] == 1:
        return x[..., 0].clone()
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc.add_(x[..., k])
    return acc


@dataclasses.dataclass(frozen=True)
class EllState:
    idx: torch.Tensor                 # [n, width] i32, pad = n
    w: torch.Tensor                   # [n, width] f32
    capped: torch.Tensor              # [n_capped] i64 rows over the cap
    n: int = 0
    n_capped: int = 0


@register
class EllEngine:
    name = "ell"

    def build(self, c: Connectome, cfg, device) -> EllState:
        width, n_capped, rows, slots, src, w = ell_entries(
            c, cfg.ell_width_cap, quantize_bits=cfg.quantize_bits)
        flat = torch.from_numpy(rows * width + slots).to(device)
        idx = torch.full((c.n, width), c.n, dtype=torch.int32, device=device)
        wgt = torch.zeros((c.n, width), dtype=torch.float32, device=device)
        idx.view(-1)[flat] = torch.from_numpy(src).to(device)
        wgt.view(-1)[flat] = torch.from_numpy(w).to(device)
        capped = torch.from_numpy(np.flatnonzero(c.fan_in > width)).to(device)
        return EllState(idx=idx, w=wgt, capped=capped, n=c.n,
                        n_capped=n_capped)

    def deliver(self, state: EllState, spikes: torch.Tensor, cfg):
        """spikes [..., n] -> (g [..., n] float32, dropped [...] int32)."""
        lead = spikes.shape[:-1]
        s = spikes.reshape(-1, state.n).to(torch.float32)
        spk_pad = torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=1)
        n, width = state.idx.shape
        rows = max(1, CHUNK_ELEMS // (width * s.shape[0]))
        g = torch.empty((s.shape[0], n), dtype=torch.float32,
                        device=spikes.device)
        for r in range(0, n, rows):
            # index_select takes the int32 indices as they are (advanced
            # indexing would first copy them to int64)
            idx = state.idx[r:r + rows]
            part = torch.index_select(spk_pad, 1, idx.reshape(-1)).view(
                -1, *idx.shape)                          # [B, rows, width]
            g[:, r:r + rows] = part.mul_(state.w[r:r + rows]).sum(dim=-1)
        g.add_(0.0)
        if state.n_capped:
            rc = state.capped
            g[:, rc] = xla_row_sum(spk_pad[:, state.idx[rc]] * state.w[rc])
        return (g.reshape(lead + (n,)),
                torch.zeros(lead, dtype=torch.int32, device=spikes.device))
