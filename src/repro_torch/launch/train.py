"""End-to-end LM training program with fault tolerance, on the port.

    python -m repro_torch.launch.train --arch qwen2.5-14b --smoke \
        --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --ckpt-every 50
    python -m repro_torch.launch.train --smoke --steps 20 --device cpu

Counterpart of ``repro/launch/train.py``, with every flag of it and the
same ``[train] ...`` lines, plus ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs on the host).  Features:

  * periodic background checkpoints (every --ckpt-every steps, of the
    whole :class:`repro_torch.train.TrainState`),
  * restart/resume from the latest checkpoint (--resume),
  * injected node failures (--fail-at N) with supervisor restart
    (:func:`repro_torch.train.fault.run_with_recovery`),
  * injected stragglers (--straggle-at N) and z-score detection.

``--arch`` takes every architecture of :mod:`repro_torch.configs`; the
synthetic data holds tokens and labels only, as the reference's, so llava
trains on text and whisper, whose encoder needs ``frames``, raises
``KeyError`` at its first step, as the reference does (ROADMAP finding
13).

With ``--data D --model M`` (D x M > 1) under ``torchrun`` of D x M
ranks, the run is sharded over :func:`repro_torch.launch.mesh.
make_host_mesh` (``gloo``, which puts several ranks on one card): each
rank holds its shards of the parameters and AdamW moments and runs
:func:`repro_torch.train.make_train_step`'s sharded step; rank 0 prints
the ``[train]`` lines and, with ``--ckpt-dir``, writes the gathered state
in the unsharded layout, so a run restores onto any mesh, or none (the
elastic restore).  In a world of one process ``make_host_mesh`` raises
and the run is unsharded, as the reference's is on a host without the
mesh's devices; a ``torchrun`` of another number of ranks is refused
(its ranks would each run the whole job and write the same checkpoints).

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --data 2 --model 1

A pending background checkpoint is joined before a failure propagates,
so the restart finds it.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import MeshSizeError, make_host_mesh
from repro_torch.models import init_params
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import (FaultConfig, StragglerDetector, latest_step,
                               make_train_step, restore_checkpoint,
                               save_checkpoint, shard_train_state,
                               simulate_failures, unshard_train_state)
from repro_torch.train.fault import run_with_recovery
from repro_torch.train.train_step import init_train_state


def host_mesh(args):
    """The mesh of ``--data`` x ``--model`` ranks, or None: a 1 x 1 mesh,
    or a world of one process (``make_host_mesh`` raises), runs
    unsharded.  A world of several ranks that is not the mesh's raises
    :class:`~repro_torch.launch.mesh.MeshSizeError`, as does every other
    error of the mesh."""
    if args.data * args.model == 1:
        return None
    devices = (None if args.device == "cuda"
               else [args.device] * (args.data * args.model))
    try:
        return make_host_mesh(data=args.data, model=args.model,
                              devices=devices)
    except MeshSizeError as e:
        if e.have > 1:
            raise
        return None


def build(args, mesh=None):
    cfg = get_config(args.arch, smoke=args.smoke)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              mesh=mesh)
    return cfg, opt, step_fn


def _is_main() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def run(args, resume_signal=None, mesh=None) -> int:
    device = (mesh.device if mesh is not None else
              resolve_device(None if args.device == "cuda" else args.device))
    lead = _is_main()
    cfg, opt, step_fn = build(args, mesh)
    ds = SyntheticLM(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch,
                     seed=args.seed)
    params = init_params(args.seed, cfg, device)
    start = 0
    if (args.resume or resume_signal is not None) and args.ckpt_dir:
        start = latest_step(args.ckpt_dir) or 0
    if start:
        # the unsharded layout, whatever mesh wrote it
        state, _ = restore_checkpoint(args.ckpt_dir, start,
                                      init_train_state(params, opt))
        if mesh is not None:
            state = shard_train_state(state, mesh)
        if lead:
            print(f"[train] resumed from step {start}")
    else:
        state = init_train_state(params, opt, mesh=mesh)

    det = StragglerDetector(z_threshold=args.z_threshold)
    fcfg = FaultConfig(fail_at_steps=tuple(args.fail_at),
                       straggle_at_steps=tuple(args.straggle_at))
    pending_save = None
    try:
        for i in range(start, args.steps):
            t0 = time.time()
            simulate_failures(i, fcfg)
            state, metrics = step_fn(state, ds.batch_at(i, device))
            if lead and i % args.log_every == 0:
                print(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            dt = time.time() - t0
            if det.observe(i, dt) and lead:
                print(f"[train] STRAGGLER step {i}: {dt*1e3:.0f} ms")
            if (args.ckpt_dir and args.ckpt_every
                    and (i + 1) % args.ckpt_every == 0):
                if pending_save is not None:
                    pending_save.join()
                    pending_save = None
                # on a mesh every rank gathers, rank 0 writes
                whole = state if mesh is None else unshard_train_state(state)
                if lead:
                    pending_save = save_checkpoint(
                        args.ckpt_dir, i + 1, whole,
                        metadata={"arch": args.arch,
                                  "loss": float(metrics["loss"])},
                        async_save=True)
                del whole
    finally:
        if pending_save is not None:
            pending_save.join()
        if mesh is not None:
            mesh.barrier()      # the checkpoint is whole before a restart
    if det.flagged and lead:
        print(f"[train] stragglers flagged: {[s for s, _, _ in det.flagged]}")
    return args.steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train an LM of the port on synthetic data: unsharded "
                    "on one device, or sharded over a --data x --model mesh "
                    "of ranks under torchrun.")
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel mesh axis: ranks that split the "
                         "batch's rows (and shard 'embed')")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel mesh axis: ranks that shard the "
                         "heads, mlp, vocab and experts dims")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--straggle-at", type=int, nargs="*", default=[])
    ap.add_argument("--z-threshold", type=float, default=3.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="device of the run (default cuda, which needs a "
                         "card; cpu runs on the host)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    mesh = host_mesh(args)

    if args.fail_at:
        def attempt(resume):
            # after the first failure the injection list is cleared
            if resume is not None:
                args.fail_at = []
                args.resume = True
            return run(args, resume, mesh)

        final = run_with_recovery(attempt, max_restarts=args.max_restarts)
    else:
        final = run(args, mesh=mesh)
    if _is_main():
        print(f"[train] done at step {final}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
