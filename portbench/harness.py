"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

The cell's configuration names its model family
(``portbench/families/<family>.py``), which builds the network, sets the
program up and hands the harness one call: an experiment of T steps over
the lanes' seeds, chunked every K steps, each chunk announced to the
harness's callback as the program's ``chunk`` event once the program has
drained the device (for the FlyWire LIF family: the trial-batched
``repro_torch.exp.trials.run_trials``, in a telemetry session).  That is
a closed loop that reads the network every K steps.  Experiments run back
to back, each on the lanes' seeds, until the window's seconds are spent;
each chunk is timed on arrival.  The experiment running when the window
closes is stopped at its next boundary (a callback that raises), unless
no experiment has completed yet: then it runs to its end, its late
chunks not counted, so that every run has an answer to compare.

With ``trace`` the first experiment's middle chunks (``PROFILE_CHUNKS``
of them, from step T/2) run under ``torch.profiler`` recording the
device alone, started and stopped at their boundaries, and the
per-layer metrics are read from that stretch, the chunk timings and the
family's least-work count of the reference's per-step counts.  The
``NAMING_CHUNKS`` after it run with the host's operations recorded too,
which slows the host, only to name the idle gaps of the breakdown.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import warnings

import numpy as np
import torch

from portbench import check, devtrace, spec, yardstick

FORBIDDEN = ("flax", "jax", "jaxlib", "repro")
WARM_CHUNKS = 2
PROFILE_CHUNKS = 10
NAMING_CHUNKS = 2


class WindowClosed(Exception):
    """Raised from the chunk callback to end the experiment in flight."""


def forbidden_modules(names=None) -> list[str]:
    """Which of JAX, ``jaxlib``, ``flax`` and the JAX package ``repro`` the
    module names (default: this process's) hold, by whole top-level name:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(*args) -> None:
    print("[portbench]", *args, file=sys.stderr, flush=True)


def run(root: str, cell: str, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    """One run; returns the result line's object."""
    bench = spec.benchmark(root)
    wl = spec.workload(bench, cell)
    conf = spec.config(root, wl["config"])
    fam = spec.family(root, conf)
    traf = spec.traffic(root, wl["traffic"])
    device = torch.device(device)
    B, T, K = traf["lanes"], traf["t_steps"], traf["chunk_steps"]
    dt_s = fam.dt_ms(conf) * 1e-3
    seeds = spec.lane_seeds(seed, B)

    # ---- set-up: network, the program's store, one short experiment
    marks = [("start", time.perf_counter())]
    net = fam.network(conf["network"],
                      os.path.join(root, "build", "portbench"))
    marks.append(("network", time.perf_counter()))
    program = fam.program(conf, traf, net, device)
    _sync(device)
    marks.append(("store", time.perf_counter()))

    program(min(T, WARM_CHUNKS * K), seeds, K, lambda rec: None)
    a = max(K, (T // 2) // K * K)
    b = min(T, a + PROFILE_CHUNKS * K)
    e = min(T, b + NAMING_CHUNKS * K)
    stretch = naming = None
    if trace and a < b:
        # the start / stop warning concerns schedules, which this has none of
        warnings.filterwarnings("ignore", message=".*clears events")
        warm = devtrace.Stretch(device, host=True)  # the profiler's start-up
        warm.start()
        torch.ones(1, device=device).add_(1)
        _sync(device)
        warm.stop()
        stretch = devtrace.Stretch(device, host=False)
        if b < e:
            naming = devtrace.Stretch(device, host=True)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    _log("set-up: imports " + f"{marks[0][1] - t_start:.3f} s, " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s"
        for i, (name, t) in enumerate(marks[1:])))

    # ---- the window
    chunks: list = []       # (experiment, step, steps, arrival, latency, wall)
    completed: list = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    exp, res = 0, None
    while time.perf_counter() < deadline:
        last = [time.perf_counter()]

        def sink(rec, exp=exp, last=last):
            if rec.get("type") != "chunk":
                return
            now = time.perf_counter()
            chunks.append((exp, rec["step"], rec["steps"], now,
                           now - last[0], rec["wall_s"]))
            last[0] = now
            if stretch is not None and exp == 0:
                if rec["step"] == a:
                    stretch.start()
                elif rec["step"] == b:
                    stretch.stop()
                    if naming is not None:
                        naming.start()
                elif rec["step"] == e and naming is not None:
                    naming.stop()
            if now >= deadline and completed:
                raise WindowClosed

        try:
            res = program(T, seeds, K, sink)
        except WindowClosed:
            break
        completed.append(res)
        exp += 1
    t_close = time.perf_counter()

    counted = [ch for ch in chunks if ch[3] <= deadline]
    lat = np.array([ch[4] for ch in counted])
    bio_s_per_s = sum(B * ch[2] * dt_s for ch in counted) / seconds
    _log(f"{cell} seed {seed}: {len(completed)} experiments, "
         f"{len(counted)} chunks in {seconds} s (of {len(chunks)}), "
         f"chunk median {1e3 * float(np.median(lat)) if len(lat) else 0:.3f}"
         f" ms, closed {t_close - deadline:.3f} s late, set-up "
         f"{setup_s:.3f} s")

    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    del program, res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the comparison
    t_ref = time.perf_counter()
    lanes = spec.check_lanes(seed, B, check.CHECK_LANES)
    ref = fam.reference(net, conf, traf, [seeds[i] for i in lanes], T,
                        device, record=stretch is not None)
    _sync(device)
    fields: dict = {}
    numbers, failed = check.compare(completed, ref, fam.STATE, lanes, fields)
    correct, checks = check.verdict(numbers, len(completed))
    _log(f"reference: {time.perf_counter() - t_ref:.3f} s for {len(lanes)} "
         f"of {B} lanes x {T} steps; {int(ref.counts.sum())} spikes")
    if numbers["state_mismatch"]:
        _log("state mismatches by field: " + ", ".join(
            f"{k} {v}" for k, v in fields.items()))

    # ---- metrics
    if stretch is None:
        values = {"bio_s_per_s": bio_s_per_s, "setup_s": setup_s,
                  "chunk_ms_p95": (1e3 * float(np.percentile(lat, 95))
                                   if len(lat) else None)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, cell)
                   if values.get(m["name"]) is not None}
        summ = None
    else:
        summ = stretch.summary() if stretch.wall_s is not None else None
        least_s = None
        if summ is not None:
            nbytes, ops = fam.least_work(ref.stats, a, b,
                                         scale=B / len(lanes))
            least_s, bound = yardstick.least_seconds(nbytes, ops)
            _log(f"traced steps {a}..{b}: wall {summ['wall_s']:.6f} s, busy "
                 f"{summ['busy_s']:.6f} s, device {summ['device_s']:.6f} s "
                 f"over {summ['device_events']} activities; least "
                 f"{least_s:.9f} s by {bound} ({nbytes:.0f} B, {ops:.0f} "
                 f"ops)")
        if summ is not None and naming is not None:
            summ["idle_gaps"] = naming.summary()["idle_gaps"]
        rec = {"chunks": [(ch[4], ch[5]) for ch in counted
                          if not (ch[0] == 0 and a < ch[1] <= e + K)],
               "stretch": summ, "steps": b - a, "least_s": least_s}
        metrics = {}
        for m in spec.per_layer(bench, cell):
            v = spec.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(completed), "failed": failed,
           "metrics": metrics, "device": dev}
    if summ is not None:
        dev["busy_s"] = summ["busy_s"]
        dev["window_s"] = summ["wall_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in summ["device_ops"]],
                            "idle_gaps": [list(x) for x in summ["idle_gaps"]]}
    out["checks"] = checks
    _log(f"compared {len(completed)} experiments, {len(lanes)} of their "
         f"{B} lanes")
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    return out
