"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

The window drives ``repro_torch.exp.trials.run_trials`` (the trial-batched
path behind the simulation CLI's ``--trials`` and ``--chunk-steps``) inside
a telemetry session whose sink is the harness's callback, so the program
drains the device at every chunk boundary and emits a ``chunk`` event: a
closed loop that reads the network every K steps.  Experiments of T
steps run back to back, each a fresh ``run_trials`` call on the lanes'
seeds, until the window's seconds are spent; each chunk is timed on
arrival.  The experiment running when the window closes is stopped at
its next boundary (a callback that raises), unless no experiment has
completed yet: then it runs to its end, its late chunks not counted, so
that every run has an answer to compare.

With ``trace`` the first experiment's middle chunks (``PROFILE_CHUNKS``
of them, from step T/2) run under ``torch.profiler`` recording the
device alone, started and stopped at their boundaries, and the
per-layer metrics are read from that stretch, the chunk timings and the
reference's per-step counts.  The ``NAMING_CHUNKS`` after it run with
the host's operations recorded too, which slows the host, only to name
the idle gaps of the breakdown.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import warnings

import numpy as np
import torch

from portbench import check, devtrace, network, spec, yardstick
from portbench.reference import sim as reference

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


def program_config(conf: dict):
    """The program's ``SimConfig`` for a configuration file."""
    from repro_torch.core import LIFParams, SimConfig
    m = conf["model"]
    params = LIFParams(**{k: m[k] for k in (
        "tau_m", "tau_g", "tau_ref", "v0", "v_r", "v_th", "w_scale", "dt",
        "delay")})
    return SimConfig(params=params, engine=conf["engine"],
                     fixed_point=m["fixed_point"],
                     quantize_bits=m["weight_bits"], poisson_to_v=False)


def program_stimulus(traffic: dict, n: int):
    """The traffic's drive as the program's stimulus: its parts in order,
    each drawing from its own key of the step's split."""
    from repro_torch.exp import Background, Compose, PoissonDrive
    parts = []
    for p in traffic["drive"]:
        if p["kind"] == "poisson":
            idx = network.pick(n, p["pick"], p["pick_seed"])
            parts.append(PoissonDrive(
                idx=torch.from_numpy(idx.astype(np.int32)),
                rate_hz=p["rate_hz"], target=p.get("target", "g"),
                weight=p["weight"]))
        elif p["kind"] == "background":
            parts.append(Background(rate_hz=p["rate_hz"]))
        else:
            raise ValueError(f"unknown drive part {p['kind']!r}")
    return Compose(tuple(parts))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(*args) -> None:
    print("[portbench]", *args, file=sys.stderr, flush=True)


def run(root: str, cell: str, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    """One run; returns the result line's object."""
    from repro_torch import obs
    from repro_torch.core import Connectome, build_synapses
    from repro_torch.exp import trials

    bench = spec.benchmark(root)
    wl = spec.workload(bench, cell)
    conf = spec.config(root, wl["config"])
    traf = spec.traffic(root, wl["traffic"])
    device = torch.device(device)
    B, T, K = traf["lanes"], traf["t_steps"], traf["chunk_steps"]
    dt_s = conf["model"]["dt"] * 1e-3
    seeds = spec.lane_seeds(seed, B)

    # ---- set-up: network, tile store, stimulus, one short experiment
    marks = [("start", time.perf_counter())]
    net = network.load_network(conf["network"],
                               os.path.join(root, "build", "portbench"))
    marks.append(("network", time.perf_counter()))
    c = Connectome(n=net["n"], **{k: net[k] for k in network.ARRAYS})
    cfg = program_config(conf)
    syn = build_synapses(c, cfg, device)
    stim = program_stimulus(traf, c.n).to(device)
    _sync(device)
    marks.append(("store", time.perf_counter()))

    def experiment(t_steps, sink):
        with obs.telemetry(obs.CallbackSink(sink)):
            return trials.run_trials(c, cfg, t_steps, seeds=seeds, syn=syn,
                                     stimulus=stim, chunk_steps=K,
                                     device=device)

    experiment(min(T, WARM_CHUNKS * K), lambda rec: None)
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
            res = experiment(T, sink)
        except WindowClosed:
            break
        completed.append((res.counts, res.dropped, *res.state))
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
    del experiment, syn, stim, c, res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the comparison
    t_ref = time.perf_counter()
    lanes = spec.check_lanes(seed, B, check.CHECK_LANES)
    ref = reference.simulate(net, conf["model"], traf["drive"],
                             [seeds[i] for i in lanes], T, device,
                             record=stretch is not None)
    _sync(device)
    numbers, failed = check.compare(completed, ref, lanes)
    correct, checks = check.verdict(numbers, len(completed))
    _log(f"reference: {time.perf_counter() - t_ref:.3f} s for {len(lanes)} "
         f"of {B} lanes x {T} steps; {int(ref.counts.sum())} spikes")

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
            nbytes, ops = yardstick.least_work(ref.stats, a, b,
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
