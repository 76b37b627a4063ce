"""Simulation-serving program: a mixed fault-injected workload through
:class:`repro_torch.serving.SimServer`, with every terminal state
accounted for.

    python -m repro_torch.launch.serve --n 400 --requests 8 \\
        --inject-fault --poison --telemetry run.jsonl --device cpu
    python -m repro_torch.launch.serve --n 139255 --synapses 15000000 \\
        --engine blocked_fused --requests 8 --inject-fault --poison

Counterpart of ``repro/launch/serve.py``, with every flag of it and the
same ``[serve] ...`` lines.  One flag more: ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs the kernels' plain
PyTorch versions).  It builds a synthetic connectome, submits a workload
that mixes scenarios, seeds, priorities and probe specs (plus, on
request, one crash-injected and one poisoned request), drains it, and
prints one line per request with its terminal status.  It exits non-zero
if a submitted request did not reach a terminal state (completed /
rejected with a reason / quarantined), if a completed request has no
result, or if the terminal counts differ from the submissions.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch import obs
from repro_torch.core import (SimConfig, resolve_device,
                              synthetic_flywire_cached)
from repro_torch.core.exchange import FaultSpec, configure_faulty
from repro_torch.core.health import BackoffPolicy, HealthConfig
from repro_torch.exp import ProbeSpec
from repro_torch.serving import (TERMINAL, SimRequest, SimServeConfig,
                                 SimServer)


def build_workload(requests: int, t_steps: int, inject_fault: bool,
                   poison: bool) -> list[SimRequest]:
    """A mixed workload: two scenario tiers (batchable within each),
    alternating probe specs and priorities, distinct seeds; plus one
    crash-injected and one poisoned request when asked."""
    reqs: list[SimRequest] = []
    for i in range(requests):
        scenario = "sugar_feeding" if i % 2 == 0 else "step_response"
        probes = (ProbeSpec(pop_rate=True) if i % 3 else
                  ProbeSpec(pop_rate=True, drops=True))
        reqs.append(SimRequest(scenario=scenario, t_steps=t_steps, seed=i,
                               probes=probes, priority=i % 2))
    if inject_fault and reqs:
        # a host-side crash at the second chunk boundary, once, through
        # the faulty exchange scheme's supervision hook
        spec = FaultSpec(partition=0, fail_at=(t_steps // 3,))
        reqs[0].fault_hook = configure_faulty("event", spec).host_supervise
    if poison:
        reqs.append(SimRequest(scenario="step_response", t_steps=t_steps,
                               seed=len(reqs),
                               params={"amp": float("nan")}))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Simulation serving on the PyTorch/CUDA port")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--synapses", type=int, default=8_000)
    ap.add_argument("--t-ms", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--engine", default="csr")
    ap.add_argument("--fixed-point", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--chunk-steps", type=int, default=25)
    ap.add_argument("--inject-fault", action="store_true",
                    help="give one request a host-side crash hook "
                         "(exercises retry-with-backoff)")
    ap.add_argument("--poison", action="store_true",
                    help="add one NaN-stimulus request (exercises "
                         "per-lane health attribution and quarantine)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="stream serve_* JSONL events to PATH")
    ap.add_argument("--device", default="cuda",
                    help="device of the server (default cuda, which needs "
                         "a card; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = (resolve_device() if args.device == "cuda"
              else torch.device(args.device))

    c = synthetic_flywire_cached(n=args.n, seed=0,
                                 target_synapses=args.synapses)
    cfg = SimConfig(engine=args.engine, fixed_point=args.fixed_point,
                    health=HealthConfig())
    t_steps = int(round(args.t_ms / cfg.params.dt))
    serve = SimServeConfig(
        max_queue=args.max_queue, max_batch=args.max_batch,
        chunk_steps=args.chunk_steps,
        default_deadline_s=args.deadline_s,
        backoff=BackoffPolicy(base_s=0.05, cap_s=2.0))
    reqs = build_workload(args.requests, t_steps, args.inject_fault,
                          args.poison)
    print(f"[serve] n={c.n} engine={cfg.engine} t_steps={t_steps} "
          f"requests={len(reqs)} (fault={args.inject_fault} "
          f"poison={args.poison})")

    with contextlib.ExitStack() as stack:
        if args.telemetry:
            stack.enter_context(obs.telemetry(args.telemetry))
        server = SimServer(c, cfg, serve, device=device)
        t0 = time.monotonic()
        done = server.run(reqs)
        wall = time.monotonic() - t0

    bad = 0
    for r in done:
        spikes = (int(r.result.counts.sum()) if r.result is not None
                  else "-")
        print(f"[serve] rid={r.rid} {r.scenario}(seed={r.seed}) -> "
              f"{r.status}"
              + (f" ({r.reason})" if r.reason else "")
              + (f" [{type(r.error).__name__}]" if r.error else "")
              + f" spikes={spikes} wall={r.latency_s:.2f}s")
        if not r.terminal:
            print(f"[serve] ERROR rid={r.rid} non-terminal "
                  f"status {r.status!r}", file=sys.stderr)
            bad += 1
        if r.status == "completed" and r.result is None:
            print(f"[serve] ERROR rid={r.rid} completed without a result",
                  file=sys.stderr)
            bad += 1
    missing = set(id(r) for r in reqs) - set(id(r) for r in done)
    if missing:
        print(f"[serve] ERROR {len(missing)} submitted request(s) never "
              f"came back", file=sys.stderr)
        bad += len(missing)

    stats = server.stats()
    terminal_total = sum(stats[k] for k in TERMINAL)
    print(f"[serve] {stats['completed']} completed / "
          f"{stats['rejected']} rejected / "
          f"{stats['quarantined']} quarantined of {stats['submitted']} "
          f"in {wall:.2f}s ({stats['retries']} retries, "
          f"{stats['escalations']} escalations, {stats['shed']} shed)")
    if terminal_total != stats["submitted"]:
        print(f"[serve] ERROR terminal states ({terminal_total}) != "
              f"submitted ({stats['submitted']})", file=sys.stderr)
        bad += 1
    if stats["latency_p50_s"] is not None:
        print(f"[serve] request latency p50={stats['latency_p50_s']:.3f}s "
              f"p99={stats['latency_p99_s']:.3f}s")
    if args.telemetry:
        print(f"[serve] telemetry stream: {args.telemetry} "
              f"(python -m repro_torch.obs.report {args.telemetry})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
