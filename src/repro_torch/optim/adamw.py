"""AdamW with a cosine schedule.

Counterpart of ``repro/optim/adamw.py``, term by term: a global-norm clip,
bias-corrected moments, ``mh / (sqrt(vh) + eps)``, decoupled weight decay
added to the step before the learning rate multiplies it, and moments
kept in ``state_dtype`` (bfloat16 moments are the memory-pressure
option).  It is written in plain tensor operations, one leaf at a time,
in the reference's order of roundings, and not with ``torch.optim.AdamW``,
which orders the same arithmetic otherwise and clips nothing.

Trees are what :func:`repro_torch.tree.named_tensors` reads: the
parameters an :class:`repro_torch.models.LMParams`, the gradients and
moments dicts keyed by its parameter names.  Unlike the reference, which
returns new trees, :meth:`AdamW.update` writes the new moments into the
state's tensors and :meth:`AdamW.apply_updates` adds the updates into the
parameters, in place: at full width a second copy of the moments or the
parameters would not fit beside the first.  ``update`` works through each
leaf in slices of :data:`CHUNK` elements, which bounds its scratch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import named_tensors

#: Elements per slice of a leaf in :meth:`AdamW.update`: the scratch of a
#: slice stays ~1 GB where a whole 778M-entry embedding would take ~16 GB.
CHUNK = 1 << 26


def _recip(x: float) -> float:
    """float32(1) / float32(x), float32-exact: XLA's CPU code divides by a
    constant as a multiply by its float32 reciprocal (ROADMAP finding 5)."""
    return float(np.float32(1) / np.float32(x))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """``lr(step)``: linear warm-up over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; a 0-d float32 tensor on
    ``step``'s device (a Python int gives a CPU tensor)."""
    r_warm = _recip(max(1.0, warmup))
    r_decay = _recip(max(1.0, total - warmup))

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step * r_warm
        prog = torch.clamp((step - warmup) * r_decay, 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(grads) -> torch.Tensor:
    """The 0-d float32 global norm of a name -> gradient dict (squares
    summed leaf by leaf, in the dict's order)."""
    return torch.sqrt(sum(g.float().square().sum()
                          for g in named_tensors(grads).values()))


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32: updates taken
    m: dict                 # name -> first moment, ``state_dtype``
    v: dict                 # name -> second moment, ``state_dtype``


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = torch.float32
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        leaves = named_tensors(params)

        def zeros():
            return {k: torch.zeros_like(p, dtype=self.state_dtype)
                    for k, p in leaves.items()}
        device = next(iter(leaves.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=zeros(), v=zeros())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, gnorm=None):
        """Returns ``(updates, state, gnorm)``: ``updates`` a name ->
        tensor dict in the parameters' dtypes, ``state`` the next state
        (its moments are ``state``'s tensors, written in place),
        ``gnorm`` the global gradient norm before clipping.  ``gnorm``
        given, it is the norm (a sharded step passes the whole gradient's
        :func:`global_norm` with its shards of the gradient, moments and
        parameters: every other term is elementwise)."""
        grads, leaves = named_tensors(grads), named_tensors(params)
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        gn = global_norm(grads) if gnorm is None else gnorm
        clip = torch.full_like(gn, self.grad_clip)   # scalar / t would
        scale = torch.clamp(clip / gn.clamp_min(1e-12), max=1.0)  # round twice
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        updates = {}
        for k, g in grads.items():
            m, v, p = state.m[k], state.v[k], leaves[k]
            u = torch.empty_like(p)
            # elementwise, so slices give the same bits with bounded scratch
            for g_, m_, v_, p_, u_ in zip(
                    g.reshape(-1).split(CHUNK), m.view(-1).split(CHUNK),
                    v.view(-1).split(CHUNK), p.reshape(-1).split(CHUNK),
                    u.view(-1).split(CHUNK)):
                g_ = g_.float() * scale
                m_new = self.b1 * m_.float() + (1 - self.b1) * g_
                v_new = self.b2 * v_.float() + (1 - self.b2) * g_ * g_
                m_.copy_(m_new)
                v_.copy_(v_new)
                delta = m_new.div_(bc1)
                delta.div_(v_new.div_(bc2).sqrt_().add_(self.eps))
                delta.add_(self.weight_decay * p_.float())
                u_.copy_(delta.mul_(lr).neg_())
            updates[k] = u
        return updates, AdamWState(step=step, m=state.m, v=state.v), gn

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates):
        """``params`` with ``updates`` added, in place; returns ``params``."""
        leaves = named_tensors(params)
        for k, u in updates.items():
            leaves[k].add_(u.to(leaves[k].dtype))
        return params


__all__ = ["AdamW", "AdamWState", "cosine_schedule", "global_norm"]
