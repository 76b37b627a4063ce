"""GPipe-style pipeline parallelism over a ``stage`` mesh axis.

Counterpart of ``repro/parallel/pipeline.py``.  Each stage owns its
params; M microbatches stream through S stages in M + S - 1 ticks (bubble
fraction (S - 1) / (M + S - 1)).  On every tick every stage runs
``stage_fn``, bubbles included: stage 0 on microbatch ``t`` (0 once
``t >= M``), stage s > 0 on what stage s - 1 produced the tick before
(zeros at first); the last stage's output of tick t >= S - 1 is
microbatch t - (S - 1)'s.

* :func:`pipeline_apply_emulated` runs the stages in one process: each
  tick computes every stage from the previous tick's hand-over, as the
  reference's ``vmap`` over a named axis does;
* :func:`pipeline_apply` runs one rank a stage along the mesh's
  ``stage`` axis (:func:`pipeline_schedule`): after each tick a stage
  sends its output to the next stage and receives the previous stage's
  (``batch_isend_irecv``; through host memory under ``gloo``), and the
  last stage's outputs are broadcast to every rank at the end.

Both give the same bits: the same ``stage_fn`` on the same inputs.  The
reference's real form sums the masked outputs over the stages instead of
broadcasting them, which differs only in the sign of a zero.
"""

from __future__ import annotations

import torch


def _stage_params(stage_params, s: int):
    """Stage ``s``'s params: ``stage_params[s]`` of a sequence or of a
    tensor stacked on a leading stage axis, or a dict of either."""
    if isinstance(stage_params, dict):
        return {k: _stage_params(v, s) for k, v in stage_params.items()}
    return stage_params[s]


def _ingest(xs, t: int):
    return xs[t if t < xs.shape[0] else 0]


def pipeline_schedule(stage_fn, params_local, xs, *, mesh, axis: str,
                      n_stages: int):
    """This rank's stage of the schedule.  ``params_local``: the stage's
    params; ``xs`` [M, ...]: the microbatches (only stage 0 reads them).
    Returns [M, ...] outputs: valid on the last stage, zeros elsewhere."""
    S, M = n_stages, xs.shape[0]
    if mesh.axis_size(axis) != S:
        raise ValueError(f"{S} stages on a {axis!r} axis of "
                         f"{mesh.axis_size(axis)}")
    stage = mesh.axis_index(axis)
    ranks = mesh.group_ranks(axis)
    nxt = ranks[stage + 1] if stage < S - 1 else None
    prv = ranks[stage - 1] if stage > 0 else None
    recv = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    ticks = M + S - 1
    for t in range(ticks):
        y = stage_fn(params_local, _ingest(xs, t) if stage == 0 else recv)
        if stage == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y
        if t < ticks - 1:           # the last tick's hand-over is unused
            got = mesh.exchange(y if nxt is not None else None, nxt,
                                y if prv is not None else None, prv)
            if got is not None:
                recv = got
    return outs


def pipeline_apply_emulated(stage_fn, stage_params, xs, n_stages: int):
    """The schedule of ``n_stages`` stages in one process;
    ``stage_params``: a sequence of per-stage params, or leaves stacked on
    a leading [S] axis.  Returns [M, ...] from the last stage."""
    S, M = n_stages, xs.shape[0]
    params = [_stage_params(stage_params, s) for s in range(S)]
    recv = [torch.zeros_like(xs[0]) for _ in range(S)]
    outs = torch.zeros_like(xs)
    for t in range(M + S - 1):
        ys = [stage_fn(params[s], _ingest(xs, t) if s == 0 else recv[s])
              for s in range(S)]
        if t >= S - 1:
            outs[t - (S - 1)] = ys[S - 1]
        recv = [ys[-1]] + ys[:-1]     # stage 0 ignores the wrap-around
    return outs


def pipeline_apply(stage_fn, stage_params, xs, mesh, n_stages: int,
                   axis: str = "stage"):
    """The schedule over the mesh's ``axis``, one rank a stage; a rank
    reads only its own entry of ``stage_params`` (the others may be None).
    Returns the [M, ...] outputs on every rank."""
    stage = mesh.axis_index(axis)
    outs = pipeline_schedule(stage_fn, _stage_params(stage_params, stage),
                             xs, mesh=mesh, axis=axis, n_stages=n_stages)
    return mesh.broadcast(outs, axis, src=n_stages - 1)


__all__ = ["pipeline_apply", "pipeline_apply_emulated", "pipeline_schedule"]
