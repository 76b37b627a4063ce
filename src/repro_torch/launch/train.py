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

The reference lays its state out over a host mesh of --data x --model
devices, or runs unsharded when the host lacks them.  The port runs
unsharded on one device; --data and --model are accepted and change
nothing (tensor and data parallelism wait for the port of ``parallel/``).
A pending background checkpoint is joined before a failure propagates, so
the restart finds it.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import (FaultConfig, StragglerDetector, latest_step,
                               make_train_step, restore_checkpoint,
                               save_checkpoint, simulate_failures)
from repro_torch.train.fault import run_with_recovery
from repro_torch.train.train_step import init_train_state


def build(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    return cfg, opt, step_fn


def run(args, resume_signal=None) -> int:
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg, opt, step_fn = build(args)
    ds = SyntheticLM(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch,
                     seed=args.seed)
    state = init_train_state(init_params(args.seed, cfg, device), opt)
    start = 0
    if (args.resume or resume_signal is not None) and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = restore_checkpoint(args.ckpt_dir, last, state)
            start = last
            print(f"[train] resumed from step {last}")

    det = StragglerDetector(z_threshold=args.z_threshold)
    fcfg = FaultConfig(fail_at_steps=tuple(args.fail_at),
                       straggle_at_steps=tuple(args.straggle_at))
    pending_save = None
    try:
        for i in range(start, args.steps):
            t0 = time.time()
            simulate_failures(i, fcfg)
            state, metrics = step_fn(state, ds.batch_at(i, device))
            if i % args.log_every == 0:
                print(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            dt = time.time() - t0
            if det.observe(i, dt):
                print(f"[train] STRAGGLER step {i}: {dt*1e3:.0f} ms")
            if (args.ckpt_dir and args.ckpt_every
                    and (i + 1) % args.ckpt_every == 0):
                if pending_save is not None:
                    pending_save.join()
                pending_save = save_checkpoint(
                    args.ckpt_dir, i + 1, state,
                    metadata={"arch": args.arch,
                              "loss": float(metrics["loss"])},
                    async_save=True)
    finally:
        if pending_save is not None:
            pending_save.join()
    if det.flagged:
        print(f"[train] stragglers flagged: {[s for s, _, _ in det.flagged]}")
    return args.steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train an LM of the port on synthetic data, unsharded "
                    "on one device.")
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
                    help="data-parallel mesh axis of the reference; the "
                         "port runs unsharded on one device and ignores it")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel mesh axis of the reference; "
                         "ignored, as --data")
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

    if args.fail_at:
        def attempt(resume):
            # after the first failure the injection list is cleared
            if resume is not None:
                args.fail_at = []
                args.resume = True
            return run(args, resume)

        final = run_with_recovery(attempt, max_restarts=args.max_restarts)
    else:
        final = run(args)
    print(f"[train] done at step {final}")


if __name__ == "__main__":
    main()
