"""The train step: the gradient of the loss, microbatched gradient
accumulation and AdamW, with optional int8 error-feedback gradient
compression; unsharded, or sharded over a mesh of ranks.

Counterpart of ``repro/train/train_step.py``.  The reference's
``jax.value_and_grad`` is ``torch.autograd.grad`` of
:func:`repro_torch.models.loss_fn`, and its ``lax.scan`` over
microbatches a loop: the global batch is split into M microbatches whose
gradients are summed in float32 and divided by M (the loss likewise), so
live activation memory is that of one microbatch.  Error feedback is per
parameter.  Parameters and moments are updated in place
(:mod:`repro_torch.optim.adamw`): a step returns a :class:`TrainState`
holding the same tensors.

**On a mesh** (``mesh=`` a :class:`repro_torch.launch.mesh.Mesh`) the
step is the port's counterpart of what GSPMD makes of the reference's
step on a mesh, in the same per-rank arithmetic:

* each rank keeps its shard of every parameter, of both AdamW moments
  and of the error-feedback residual, per
  :func:`repro_torch.parallel.make_param_shardings`' specs
  (:class:`ShardedParams`);
* a step gathers the full parameters, runs the unchanged gradient code
  on the rank's rows of the batch (:func:`~repro_torch.parallel.
  batch_spec`: the rows split over ``pod`` x ``data``; ranks along
  ``model`` share them), sums the gradients and the loss over the data
  axes and multiplies them by ``float32(1 / n_dp)``, takes the clip's
  global norm of the whole reduced gradient, and runs AdamW on the
  rank's shards (elementwise, so each shard's update is bitwise the
  slice of the whole update);
* a rank holds the full parameters and gradients only during a step,
  its shards between steps.

With ``data = 1`` the step is bitwise the unsharded one; with ``data >
1`` only the gradient's summation order differs.  Compute is repeated
along ``model``: a column / row split of the products (true tensor
parallelism) is later work.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import loss_fn
from repro_torch.models.model import module_param_axes
from repro_torch.optim import AdamW, error_feedback_update
from repro_torch.optim.adamw import AdamWState, global_norm
from repro_torch.parallel.sharding import (batch_spec, data_axis_size, gather,
                                           make_param_shardings, shard_of)
from repro_torch.tree import named_tensors


class TrainState(NamedTuple):
    params: Any        # LMParams, or ShardedParams on a mesh
    opt: Any           # AdamWState (on a mesh: moment shards)
    residual: Any      # name -> float32 error-feedback residual, or None


class ShardedParams(NamedTuple):
    """A rank's part of the parameters on a mesh: ``module`` is the
    :class:`repro_torch.models.LMParams` whose parameters hold the full
    values during a step only (empty between steps), ``shards`` the
    rank's blocks, ``specs`` their :class:`~repro_torch.parallel.
    sharding.Spec`."""
    module: Any
    shards: dict
    specs: dict
    mesh: Any


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _release(module) -> None:
    """Drop the full values of ``module``'s parameters (shapes kept in
    the specs); the module keeps its structure."""
    for p in module.parameters():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def _materialize(sp: ShardedParams, module) -> None:
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.data = gather(sp.shards[k], sp.specs[k], sp.mesh)


def _shard_params(params, mesh) -> ShardedParams:
    """This rank's blocks of ``params`` (the same on every rank) under
    their specs on ``mesh``; the full values' memory is released."""
    specs, _ = make_param_shardings(mesh, module_param_axes(params),
                                    named_tensors(params))
    shards = {k: shard_of(p.detach(), specs[k], mesh)
              for k, p in params.named_parameters()}
    _release(params)
    return ShardedParams(params, shards, specs, mesh)


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """An unsharded state (full parameters, moments and residual, the
    same on every rank) as this rank's shards on ``mesh``."""
    sp = _shard_params(state.params, mesh)

    def cut(tree):
        return (None if tree is None else
                {k: shard_of(t, sp.specs[k], mesh) for k, t in tree.items()})
    opt = state.opt
    return TrainState(params=sp, opt=AdamWState(step=opt.step, m=cut(opt.m),
                                                v=cut(opt.v)),
                      residual=cut(state.residual))


def unshard_train_state(state: TrainState) -> TrainState:
    """The whole state in the unsharded layout (a new module holding the
    full parameters, full moments and residual), gathered on every rank:
    what an unsharded run's checkpoint holds."""
    sp = state.params
    module = copy.deepcopy(sp.module)
    _materialize(sp, module)

    def whole(tree):
        return (None if tree is None else
                {k: gather(t, sp.specs[k], sp.mesh) for k, t in tree.items()})
    opt = state.opt
    return TrainState(params=module, opt=AdamWState(
        step=opt.step, m=whole(opt.m), v=whole(opt.v)),
        residual=whole(state.residual))


def init_train_state(params, optimizer: AdamW, compress: bool = False,
                     mesh=None) -> TrainState:
    """The state of a run from ``params``; on ``mesh`` (every rank passing
    the same ``params``) this rank's shards, the full parameters
    released."""
    if mesh is not None:
        sp = _shard_params(params, mesh)
        residual = ({k: torch.zeros_like(s, dtype=torch.float32)
                     for k, s in sp.shards.items()} if compress else None)
        return TrainState(params=sp, opt=optimizer.init(sp.shards),
                          residual=residual)
    residual = ({k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for k, p in named_tensors(params).items()}
                if compress else None)
    return TrainState(params=params, opt=optimizer.init(params),
                      residual=residual)


def make_train_step(cfg, optimizer: AdamW, microbatches: int = 1,
                    compress_grads: bool = False, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``; ``metrics`` are
    0-d float32 tensors ``loss``, ``grad_norm`` and ``lr``.

    batch leaves: [B, ...] with B divisible by ``microbatches`` (on a
    mesh: the global batch, the same on every rank, B divisible by the
    data axes' extent times ``microbatches``; a B that does not divide
    over the data axes is replicated, as the reference's layout does,
    each data rank running every row, B divisible by ``microbatches``).
    ``mesh``: the state is :func:`init_train_state`'s on the same mesh.
    """
    inv_m = float(np.float32(1) / np.float32(microbatches))

    def grads_of(params, batch):
        names, leaves = zip(*named_tensors(params).items())
        loss = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    def loss_and_grads(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
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
        return loss, grads

    def lr_of(opt, loss):
        return (optimizer.lr(opt.step) if callable(optimizer.lr)
                else torch.tensor(optimizer.lr, dtype=torch.float32,
                                  device=loss.device))

    def step(state: TrainState, batch):
        params = state.params
        loss, grads = loss_and_grads(params, batch)
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
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr_of(opt, loss)}
        return TrainState(params=params, opt=opt, residual=residual), metrics

    if mesh is None:
        return step

    dp = _dp_axes(mesh)
    n_dp = data_axis_size(mesh)
    inv_dp = float(np.float32(1) / np.float32(n_dp))

    def sharded_step(state: TrainState, batch):
        sp = state.params
        module, specs = sp.module, sp.specs
        _materialize(sp, module)
        rows = {k: shard_of(v, batch_spec(mesh, v.dim(),
                                          v.shape[0] % n_dp == 0), mesh)
                for k, v in batch.items()}
        loss, grads = loss_and_grads(module, rows)
        _release(module)
        if n_dp > 1:
            loss = mesh.all_reduce(loss, dp).mul_(inv_dp)
            for k in grads:
                grads[k] = mesh.all_reduce(grads[k], dp).mul_(inv_dp)
        residual = state.residual
        if compress_grads:
            new_res = {}
            for k, g in grads.items():
                r = gather(residual[k], specs[k], mesh)
                grads[k], r = error_feedback_update(g, r)
                new_res[k] = shard_of(r, specs[k], mesh)
            residual = new_res
        gnorm = global_norm(grads)
        g_shards = {}
        for k in list(grads):
            g_shards[k] = shard_of(grads.pop(k), specs[k], mesh)
        updates, opt, gnorm = optimizer.update(g_shards, state.opt,
                                               sp.shards, gnorm=gnorm)
        del g_shards
        AdamW.apply_updates(sp.shards, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr_of(opt, loss)}
        return TrainState(params=sp, opt=opt, residual=residual), metrics

    return sharded_step


__all__ = ["ShardedParams", "TrainState", "init_train_state",
           "make_train_step", "shard_train_state", "unshard_train_state"]
