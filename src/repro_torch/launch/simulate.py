"""FlyWire simulation CLI (the paper's workload as a program), on the port.

    python -m repro_torch.launch.simulate --scale smoke \
        --scenario sugar_feeding --engine event --trials 3
    python -m repro_torch.launch.simulate --scale full --fixed-point \
        --engine blocked_fused --t-ms 100 --chunk-steps 250 --digest
    python -m repro_torch.launch.simulate --distributed --emulate --cores 4
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.simulate --distributed --cores 4
    python -m repro_torch.launch.simulate --scale smoke --device cpu

Counterpart of ``repro/launch/simulate.py``, with every flag of it and the
same meaning, and the same ``[simulate] ...`` lines (``digest`` included:
for the same flags the port prints the reference's digest).  Two flags
more, where the reference reads ``JAX_PLATFORMS``: ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs the kernels' plain
PyTorch versions) and ``--dist-backend`` (``nccl``, the default, one GPU
a rank; ``gloo``, which can put several ranks on one card or on the
CPU).

--scenario selects a registered stimulus scenario
(:mod:`repro_torch.exp.scenarios`); --trials > 1 runs a batch of seeds
as the lanes of one run and reports trial-averaged rates (on the
partitioned path too).  --distributed partitions with the paper's greedy
capacity scheme and runs the partitioned simulator with the same
stimulus: with --emulate its partitions one after another on one device;
without it one partition a process, under ``torchrun`` (which sets
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; --cores must equal the world
size), every rank building the same partitioning and only rank 0
printing, its digest the emulated run's; --dist-scheme selects the
exchange scheme (bitmap | event | blocked).  The supervision flags
(--chunk-steps, --checkpoint-dir, --resume, --health, --max-drop-rate,
--inject-fail-at-chunk) drive :mod:`repro_torch.core.health`;
--telemetry streams the JSONL events of :mod:`repro_torch.obs` (check
them with ``python -m repro_torch.obs.check`` and summarize them with
``python -m repro_torch.obs.report``); --profile writes a
``torch.profiler`` trace into a directory.  Either opens a telemetry
session with the step-phase switch on (:mod:`repro_torch.obs.phases`): on
a card each chunk's steps are marked on the device stream, the chunk
events carry each phase's time, a ``[simulate] step phases`` line sums
them, and the profiler trace names the program's spans and phases.

:func:`main` takes an argument list, so tests and ``chip_smoke.py`` can
drive the CLI in process; its keyword ``async_checkpoint`` (no flag, as
in the reference) writes the checkpoints on a background thread.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.flywire import CONFIG, CONFIG_1MS, SMOKE
from repro_torch.core import (SimConfig, available_engines,
                              available_schemes, build_dcsr, greedy_partition,
                              pad_to_uniform, parity, resolve_device,
                              simulate, spike_rates_hz,
                              synthetic_flywire_cached)
from repro_torch.core.compress import CoreBudget
from repro_torch.core.distributed import (BACKENDS, DistConfig,
                                          make_core_mesh,
                                          simulate_distributed)
from repro_torch.core.health import HealthConfig
from repro_torch.core.partition import caps_from_budget
from repro_torch.exp import (ProbeSpec, available_scenarios, build_scenario,
                             get_scenario, run_dist_trials, run_trials)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.simulate",
        description="FlyWire simulation on the PyTorch/CUDA port")
    ap.add_argument("--scale", choices=["smoke", "bench", "full"],
                    default="bench")
    ap.add_argument("--engine", default="event", choices=available_engines())
    ap.add_argument("--scenario", default="sugar_feeding",
                    choices=available_scenarios())
    ap.add_argument("--dt", type=float, default=0.1, choices=[0.1, 1.0])
    ap.add_argument("--fixed-point", action="store_true",
                    help="run the int32 Q19.12 integration path (the "
                         "Loihi-faithful arithmetic)")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--t-ms", type=float, default=0.0)
    ap.add_argument("--background-hz", type=float, default=None,
                    help="override the scenario's background_hz param "
                         "(0 turns an always-on background off)")
    ap.add_argument("--parity", action="store_true",
                    help="compare against the float csr reference")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--emulate", action="store_true",
                    help="run the partitions one after another on one "
                         "device (without it --distributed runs one "
                         "partition a process, under torchrun)")
    ap.add_argument("--cores", type=int, default=4)
    ap.add_argument("--dist-scheme", default="event",
                    choices=sorted(set(available_schemes()) - {"local"}))
    ap.add_argument("--chunk-steps", type=int, default=0,
                    help="supervise the run in K-step chunks "
                         "(bitwise equal to one run; 0 = off)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint the carry at chunk boundaries")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--health", action="store_true",
                    help="enable the in-step health sentinels and the "
                         "chunk-boundary threshold checks")
    ap.add_argument("--max-drop-rate", type=float, default=None,
                    help="health threshold: dropped synapse events per "
                         "step (implies --health)")
    ap.add_argument("--inject-fail-at-chunk", type=int, default=0,
                    help="deterministic mid-run kill: run only N chunks "
                         "then exit (requires --chunk-steps and "
                         "--checkpoint-dir; resume with --resume)")
    ap.add_argument("--digest", action="store_true",
                    help="print a sha256 over raster+counts (enables the "
                         "raster probe; the kill-and-resume check)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="stream JSONL telemetry events to PATH (inspect "
                         "with python -m repro_torch.obs.report PATH); "
                         "on a card the steps' phases are timed on the "
                         "device stream")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the run in torch.profiler and write "
                         "DIR/trace.json (a Chrome trace), the program's "
                         "spans and step phases named in it")
    ap.add_argument("--device", default="cuda",
                    help="device of the run (default cuda, which needs a "
                         "card; cpu runs the kernels' plain versions)")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="torch.distributed backend of --distributed "
                         "without --emulate: nccl (one GPU a rank) or gloo "
                         "(several ranks a card, or the CPU)")
    return ap


def main(argv=None, *, async_checkpoint: bool = False) -> None:
    ap = parser()
    args = ap.parse_args(argv)

    supervised = bool(args.chunk_steps or args.checkpoint_dir or args.resume
                      or args.health or args.max_drop_rate is not None)
    if supervised and args.trials > 1:
        ap.error("chunked supervision flags require --trials 1")
    if args.inject_fail_at_chunk and not (args.chunk_steps
                                          and args.checkpoint_dir):
        ap.error("--inject-fail-at-chunk requires --chunk-steps and "
                 "--checkpoint-dir")
    mesh, owned = None, False
    if args.distributed and not args.emulate:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            ap.error("--distributed without --emulate runs the multi-device "
                     "path, one process a partition: launch it under "
                     "torchrun (python -m torch.distributed.run "
                     "--nproc-per-node P ...)")
        if int(os.environ["WORLD_SIZE"]) != args.cores:
            ap.error(f"--cores {args.cores} must equal the world size "
                     f"{os.environ['WORLD_SIZE']}")
        owned = not torch.distributed.is_initialized()
        mesh = make_core_mesh(
            args.cores, None if args.device == "cuda"
            else [args.device] * args.cores, backend=args.dist_backend)
        device = mesh.device
    else:
        device = (resolve_device() if args.device == "cuda"
                  else torch.device(args.device))
    lead = mesh is None or mesh.rank == 0

    try:
        with contextlib.ExitStack() as stack:
            if not lead:
                # only rank 0 prints, streams telemetry and writes a profile
                stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            session = None
            if (args.telemetry or args.profile) and lead:
                session = stack.enter_context(obs.telemetry(args.telemetry))
                session.phases = True
            stack.enter_context(obs.profile_trace(args.profile if lead
                                                  else None))
            _run(args, supervised, device, async_checkpoint, mesh)
            if session is not None:
                _print_phases(session)
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    if args.telemetry and lead:
        print(f"[simulate] telemetry stream: {args.telemetry} "
              f"(python -m repro_torch.obs.report {args.telemetry})")


def _print_phases(session) -> None:
    """The run's step phases (the session's ``step.<name>``
    observations): device-stream seconds and shares.  Nothing where no
    chunk was marked (a run on the CPU)."""
    totals = {k.removeprefix("step."): v["total"]
              for k, v in session.metrics.observations().items()
              if k.startswith("step.")}
    whole = sum(totals.values())
    if whole > 0:
        print("[simulate] step phases (device stream): " + ", ".join(
            f"{k} {v:.4f}s ({100 * v / whole:.1f}%)"
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])))


def _fmt_stats(stats: dict) -> str:
    """Render result stats for the run line; the telemetry compile-cache
    snapshot gets a compact hit/miss summary."""
    out = []
    for k, v in stats.items():
        if isinstance(v, dict):
            if k == "compile_cache":
                out.append(f" cache_hits={v['hits']}"
                           f"/{v['hits'] + v['misses']}")
            continue
        out.append(f" {k}={int(torch.as_tensor(v).sum())}")
    return "".join(out)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(args, supervised: bool, device: torch.device,
         async_checkpoint: bool, mesh=None):
    fw = {"smoke": SMOKE, "bench": dataclasses.replace(
        SMOKE, n_neurons=20_000, target_synapses=600_000, t_sim_ms=100.0),
        "full": (CONFIG if args.dt == 0.1 else CONFIG_1MS)}[args.scale]
    c = synthetic_flywire_cached(n=fw.n_neurons, seed=0,
                                 target_synapses=fw.target_synapses)
    print(f"[simulate] connectome: {c.stats()}")
    t_ms = args.t_ms or fw.t_sim_ms
    cfg = dataclasses.replace(fw.sim, engine=args.engine,
                              fixed_point=fw.sim.fixed_point
                              or args.fixed_point)
    if args.health or args.max_drop_rate is not None:
        cfg = dataclasses.replace(
            cfg, health=HealthConfig(max_drop_rate=args.max_drop_rate))
    t_steps = int(round(t_ms / cfg.params.dt))
    dt_ms = cfg.params.dt
    if args.inject_fail_at_chunk:
        # deterministic "kill": stop after N supervised chunks; the
        # checkpoints on disk are exactly what a SIGKILL would leave
        t_steps = min(t_steps, args.inject_fail_at_chunk * args.chunk_steps)
    probes = ProbeSpec(raster=True) if args.digest else None
    chunk_kw = dict(chunk_steps=args.chunk_steps or None,
                    checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                    async_checkpoint=async_checkpoint)

    scen = get_scenario(args.scenario)
    # FlyWireConfig stays the source of truth for the sugar population
    # wherever the scenario exposes the matching params
    overrides = {}
    if "n_sugar" in scen.defaults:
        overrides["n_sugar"] = fw.n_sugar
    if "rate_hz" in scen.defaults:
        overrides["rate_hz"] = fw.sugar_rate_hz
    if args.background_hz is not None:
        if "background_hz" in scen.defaults:
            overrides["background_hz"] = args.background_hz
        else:
            print(f"[simulate] note: scenario {scen.name!r} takes no "
                  f"background_hz; --background-hz ignored")
    stim = build_scenario(args.scenario, c, cfg, **overrides)
    print(f"[simulate] scenario {scen.name!r}: {scen.description}")

    if args.distributed:
        caps = caps_from_budget(CoreBudget.tpu_vmem(), "sar")
        p = greedy_partition(c, caps, scheme="sar")
        p = pad_to_uniform(p, args.cores, c.n)
        d = build_dcsr(c, p, quantize_bits=cfg.quantize_bits)
        print(f"[simulate] distributed over {d.n_parts} partitions "
              f"(U={d.part_size}, S_max={d.s_max}, "
              f"scheme={args.dist_scheme})")
        dcfg = DistConfig(sim=cfg, scheme=args.dist_scheme)
        t0 = time.time()
        raster = None
        if args.trials > 1:
            res = run_dist_trials(d, dcfg, t_steps, seeds=args.trials,
                                  emulate=mesh is None, stimulus=stim,
                                  device=device, mesh=mesh)
            mean_counts = _host(res.counts).astype(np.float64).mean(axis=0)
            dropped = int(_host(res.dropped).sum())
        else:
            res = simulate_distributed(d, dcfg, t_steps, seed=0,
                                       emulate=mesh is None, stimulus=stim,
                                       probes=probes, device=device,
                                       mesh=mesh, **chunk_kw)
            mean_counts = _host(res.counts).astype(np.float64)
            dropped = res.dropped
            raster = res.raster
        stats = _fmt_stats(res.stats)
        print(f"[simulate] {max(args.trials, 1)} trial(s) x {t_steps} steps "
              f"in {time.time()-t0:.2f}s (dropped={dropped}{stats})")
    elif supervised or (args.telemetry and args.trials == 1):
        # a single-trial telemetry run goes through simulate() so the
        # full run_start/chunk/run_end event stream exists
        t0 = time.time()
        res = simulate(c, cfg, t_steps, stimulus=stim, probes=probes,
                       seed=0, device=device, **chunk_kw)
        mean_counts = _host(res.counts).astype(np.float64)
        dropped = int(_host(res.dropped))
        raster = res.raster
        stats = _fmt_stats(res.stats)
        print(f"[simulate] 1 trial x {t_steps} supervised steps "
              f"(K={args.chunk_steps or t_steps}) in {time.time()-t0:.2f}s "
              f"(dropped={dropped}{stats})")
    else:
        t0 = time.time()
        raster = None
        res = run_trials(c, cfg, t_steps, stimulus=stim, seeds=args.trials,
                         probes=probes, device=device)
        mean_counts = _host(res.counts).astype(np.float64).mean(axis=0)
        dropped = int(_host(res.dropped).sum())
        print(f"[simulate] {args.trials} trial(s) x {t_steps} steps in "
              f"{time.time()-t0:.2f}s (dropped={dropped})")
    if args.inject_fail_at_chunk:
        print(f"[simulate] injected kill after chunk "
              f"{args.inject_fail_at_chunk} — checkpoints in "
              f"{args.checkpoint_dir}; rerun with --resume to continue")
        return
    if args.digest:
        h = hashlib.sha256()
        if raster is not None:
            h.update(np.ascontiguousarray(_host(raster)).tobytes())
        h.update(np.ascontiguousarray(
            mean_counts.astype(np.int64)).tobytes())
        print(f"[simulate] digest {h.hexdigest()}")

    rates = _host(spike_rates_hz(torch.from_numpy(mean_counts), t_steps,
                                 dt_ms))
    active = (rates > 0.5).sum()
    print(f"[simulate] mean total spikes {mean_counts.sum():.1f}, "
          f"active neurons {active} ({active/c.n:.2%}), "
          f"mean active rate {rates[rates>0.5].mean() if active else 0:.1f} Hz")

    if args.parity:
        ref_cfg = SimConfig(engine="csr", params=cfg.params,
                            poisson_to_v=True)
        ref_stim = build_scenario(args.scenario, c, ref_cfg, **overrides)
        ra = run_trials(c, ref_cfg, t_steps, stimulus=ref_stim,
                        seeds=[10 + i for i in range(args.trials)],
                        device=device).mean_rates_hz(t_steps, dt_ms)
        rb = run_trials(c, cfg, t_steps, stimulus=stim,
                        seeds=[20 + i for i in range(args.trials)],
                        device=device).mean_rates_hz(t_steps, dt_ms)
        print("[simulate] parity vs float reference:",
              parity(ra, rb).summary())


if __name__ == "__main__":
    main()
