"""The train step: the gradient of the loss, microbatched gradient
accumulation and AdamW, with optional int8 error-feedback gradient
compression.

Counterpart of ``repro/train/train_step.py``.  The reference's
``jax.value_and_grad`` is ``torch.autograd.grad`` of
:func:`repro_torch.models.loss_fn`, and its ``lax.scan`` over
microbatches a loop: the global batch is split into M microbatches whose
gradients are summed in float32 and divided by M (the loss likewise), so
live activation memory is that of one microbatch.  Error feedback is per
parameter.  Parameters and moments are updated in place
(:mod:`repro_torch.optim.adamw`): a step returns a :class:`TrainState`
holding the same tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import loss_fn
from repro_torch.optim import AdamW, error_feedback_update
from repro_torch.tree import named_tensors


class TrainState(NamedTuple):
    params: Any        # LMParams
    opt: Any           # AdamWState
    residual: Any      # name -> float32 error-feedback residual, or None


def init_train_state(params, optimizer: AdamW, compress: bool = False
                     ) -> TrainState:
    residual = ({k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for k, p in named_tensors(params).items()}
                if compress else None)
    return TrainState(params=params, opt=optimizer.init(params),
                      residual=residual)


def make_train_step(cfg, optimizer: AdamW, microbatches: int = 1,
                    compress_grads: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``; ``metrics`` are
    0-d float32 tensors ``loss``, ``grad_norm`` and ``lr``.

    batch leaves: [B, ...] with B divisible by ``microbatches``.
    """
    inv_m = float(np.float32(1) / np.float32(microbatches))

    def grads_of(params, batch):
        names, leaves = zip(*named_tensors(params).items())
        loss = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    def step(state: TrainState, batch):
        params = state.params
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            leaves = named_tensors(params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves["embed"].device)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in leaves.items()}
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                mb_loss, mb_grads = grads_of(params, mb)
                loss = loss + mb_loss
                for k, g in mb_grads.items():
                    grads[k].add_(g)
                del mb_grads
            # the reference's division by the constant M, as XLA does it
            loss = loss * inv_m
            for g in grads.values():
                g.mul_(inv_m)

        residual = state.residual
        if compress_grads:
            fed = {k: error_feedback_update(g, residual[k])
                   for k, g in grads.items()}
            grads = {k: f[0] for k, f in fed.items()}
            residual = {k: f[1] for k, f in fed.items()}
            del fed

        updates, opt, gnorm = optimizer.update(grads, state.opt, params)
        del grads
        AdamW.apply_updates(params, updates)
        lr = (optimizer.lr(opt.step) if callable(optimizer.lr)
              else torch.tensor(optimizer.lr, dtype=torch.float32,
                                device=loss.device))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=params, opt=opt, residual=residual), metrics

    return step


__all__ = ["TrainState", "init_train_state", "make_train_step"]
