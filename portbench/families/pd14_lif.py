"""The cortical microcircuit family: Potjans & Diesmann's model of 1 mm^2
of early sensory cortex (Cereb. Cortex 24:785, 2014, Tables 4-5; NEST's
``pynest/examples/Potjans_2014``), eight populations of current-based
LIF neurons with a delay a synapse, driven by a Poisson count of external
input on every neuron.

* :func:`network` draws the network from the configuration's ``network``
  entry and its seed, population pair by population pair as NEST's
  ``fixed_total_number`` rule does: ``K = round(ln(1 - p) / ln(1 - 1 /
  (N_pre N_post)))`` synapses a pair, sources and targets uniform with
  replacement (multapses kept apart), weights normal (relative s.d.
  ``w_rel_sd``; inhibitory ``g`` times the excitatory, L4E -> L2/3E
  doubled; a draw of the wrong sign redrawn) in whole weight quanta of
  ``w_scale`` mV, clipped to ``weight_bits`` bits, and delays normal
  (redrawn below ``dt``) in whole steps.  The synapses are laid out
  source-major by a counting sort: each pair's sources are drawn as the
  count a source of a multinomial, which is the same law as sorted
  uniform draws.  The arrays are cached under ``build/portbench/`` as
  uncompressed ``.npy`` in a directory named by the entry's numbers,
  written whole or not at all.
* :func:`program` runs the port: ``Connectome`` held source-major with
  its delays, the ``delay_event`` engine, the ``PoissonCount`` drive,
  ``run_trials`` chunked in a telemetry session.
* :func:`reference` is ``portbench/reference/pd14.py``.

A configuration holds ``network`` (above), ``model`` (the LIF constants,
``c_m_pf``, ``fixed_point``, ``weight_bits``), ``drive`` (``k_ext`` a
population, ``psc_ext_pa``) and ``engine``; its traffic's ``drive`` is one
``{"kind": "poisson_count", "rate_hz": r}`` part.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import check
from portbench.reference import pd14

#: The final state, in the program's order: membrane, conductance,
#: refractory countdown, and the ring of pending input ``[B, n, D]``.
STATE = ("v", "g", "refrac", "pending")

#: The CPU tests' size: every population's N scaled by this (NEST's
#: ``N_scaling``; K follows from the formula).
SMALL_SCALE = 0.02

ARRAYS = ("pop_bounds", "out_indptr", "out_indices", "out_weights",
          "out_delays")


def dt_ms(conf: dict) -> float:
    """The simulated milliseconds of one step."""
    return conf["model"]["dt"]


def sizes(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(N [P], K [P, P])``: each population's neurons at the entry's
    ``scale`` and each (target, source) pair's synapses."""
    N = np.round(np.asarray(spec["n_full"], np.float64)
                 * spec["scale"]).astype(np.int64)
    p = np.asarray(spec["conn_probs"], np.float64)
    K = np.zeros(p.shape, np.int64)
    for t, s in zip(*np.nonzero(p > 0)):
        K[t, s] = round(np.log(1.0 - p[t, s])
                        / np.log(1.0 - 1.0 / (N[s] * N[t])))
    return N, K


def _normal(rng, mean: float, sd: float, size: int, bad) -> np.ndarray:
    """Normal draws, each that ``bad`` flags drawn again."""
    x = rng.normal(mean, sd, size)
    m = bad(x)
    while m.any():
        x[m] = rng.normal(mean, sd, int(m.sum()))
        m = bad(x)
    return x


def generate(spec: dict) -> dict:
    """The network's arrays (module docstring)."""
    N, K = sizes(spec)
    P = len(N)
    bounds = np.zeros(P + 1, np.int64)
    np.cumsum(N, out=bounds[1:])
    n, nnz = int(bounds[-1]), int(K.sum())
    excit = [name.endswith("E") for name in spec["populations"]]
    unit = (spec["psc_e_pa"] * spec["tau_m"] / spec["c_m_pf"]
            / spec["w_scale"])                 # excitatory mean, quanta
    lo, hi = -(1 << (spec["weight_bits"] - 1)), \
        (1 << (spec["weight_bits"] - 1)) - 1
    indptr = np.zeros(n + 1, np.int64)
    tgt = np.empty(nnz, np.int32)
    w = np.empty(nnz, np.int16)
    dly = np.empty(nnz, np.int8)
    clipped, start = 0, 0
    for s in range(P):
        rngs, cnt = {}, np.zeros((P, N[s]), np.int64)
        for t in range(P):
            if K[t, s]:
                rngs[t] = np.random.default_rng([spec["seed"], t, s])
                cnt[t] = rngs[t].multinomial(K[t, s],
                                             np.full(N[s], 1.0 / N[s]))
        per_src = cnt.sum(axis=0)
        row = start + np.concatenate([[0], np.cumsum(per_src)[:-1]])
        indptr[bounds[s] + 1:bounds[s + 1] + 1] = start + np.cumsum(per_src)
        for t, rng in rngs.items():
            c, k = cnt[t], int(K[t, s])
            pos = np.repeat(row, c) + (np.arange(k)
                                       - np.repeat(np.cumsum(c) - c, c))
            row = row + c
            tgt[pos] = rng.integers(0, N[t], k) + bounds[t]
            mean = unit if excit[s] else spec["g"] * unit
            if spec["populations"][t] == "L23E" and \
                    spec["populations"][s] == "L4E":
                mean *= spec["l4e_to_l23e_factor"]
            x = np.rint(_normal(rng, mean, spec["w_rel_sd"] * abs(mean), k,
                                (lambda x: x < 0) if excit[s]
                                else (lambda x: x > 0)))
            clipped += int(((x < lo) | (x > hi)).sum())
            w[pos] = np.clip(x, lo, hi)
            dmean = spec["delay_e_ms"] if excit[s] else spec["delay_i_ms"]
            steps = np.rint(_normal(rng, dmean, spec["delay_rel_sd"] * dmean,
                                    k, lambda x: x < spec["dt"])
                            / spec["dt"])
            if steps.max() > np.iinfo(np.int8).max:
                raise ValueError("a delay of more than 127 steps")
            dly[pos] = steps
        start += int(per_src.sum())
    return {"n": n, "pop_bounds": bounds, "out_indptr": indptr,
            "out_indices": tgt, "out_weights": w, "out_delays": dly,
            "clipped": clipped}


def cache_name(spec: dict) -> str:
    """The cache directory's name: the neurons, the seed and a digest of
    every number of the entry."""
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                            ).hexdigest()[:12]
    N, _ = sizes(spec)
    return f"pd14_{int(N.sum())}_{spec['seed']}_{digest}"


def network(spec: dict, cache_dir: str) -> dict:
    """The arrays of the configuration's ``network`` entry, generated on
    first use (its seconds logged) and cached."""
    path = os.path.join(cache_dir, cache_name(spec))
    if not os.path.isdir(path):
        t0 = time.perf_counter()
        net = generate(spec)
        tmp = f"{path}.{os.getpid()}.tmp"
        os.makedirs(tmp, exist_ok=True)
        for k in ARRAYS:
            np.save(os.path.join(tmp, k + ".npy"), net[k])
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"n": net["n"], "clipped": net["clipped"],
                       "synapses": int(len(net["out_indices"]))}, f)
        os.replace(tmp, path)
        print(f"[portbench] pd14 network: {net['n']} neurons, "
              f"{len(net['out_indices'])} synapses, {net['clipped']} "
              f"weights clipped, generated in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    with open(os.path.join(path, "meta.json")) as f:
        net = json.load(f)
    for k in ARRAYS:
        net[k] = np.load(os.path.join(path, k + ".npy"))
    return net


def program_config(conf: dict):
    """The program's ``SimConfig`` for a configuration file."""
    from repro_torch.core import LIFParams, SimConfig
    m = conf["model"]
    params = LIFParams(**{k: m[k] for k in (
        "tau_m", "tau_g", "tau_ref", "v0", "v_r", "v_th", "w_scale", "dt")},
        delay=m["dt"])
    return SimConfig(params=params, engine=conf["engine"],
                     fixed_point=m["fixed_point"],
                     quantize_bits=m["weight_bits"], poisson_to_v=False)


def program_stimulus(conf: dict, traffic: dict, net: dict):
    """The traffic's count drive as the program's stimulus (each
    population's mean events a step, ``K_ext x rate x dt``)."""
    from repro_torch.exp import Compose, PoissonCount
    (part,) = traffic["drive"]
    if part["kind"] != "poisson_count":
        raise ValueError(f"unknown drive part {part['kind']!r}")
    bounds = np.asarray(net["pop_bounds"])
    pop = torch.from_numpy(np.repeat(np.arange(len(bounds) - 1),
                                     np.diff(bounds)).astype(np.int32))
    lam = tuple(k * part["rate_hz"] * conf["model"]["dt"] * 1e-3
                for k in conf["drive"]["k_ext"])
    return Compose((PoissonCount(pop=pop, lam=lam,
                                 weight=pd14.w_ext_units(conf)),))


def program(conf: dict, traffic: dict, net: dict, device):
    """Set-up: the network source-major with its delays, the engine's
    store and the stimulus on ``device``.  Returns ``run(t_steps, seeds,
    chunk_steps, sink) -> (counts, dropped, state)``: one experiment of
    ``run_trials`` over the lanes' seeds, chunked, in a telemetry session
    whose events go to ``sink`` (``run_trials`` is looked up at each call).
    The state's ring of pending input is 18.3 GB at 1,024 lanes."""
    from repro_torch import obs
    from repro_torch.core import build_synapses, from_fanout
    from repro_torch.exp import trials

    c = from_fanout(net["n"], net["out_indptr"], net["out_indices"],
                    net["out_weights"], net["out_delays"])
    cfg = program_config(conf)
    syn = build_synapses(c, cfg, device)
    stim = program_stimulus(conf, traffic, net).to(device)

    def run(t_steps, seeds, chunk_steps, sink):
        with obs.telemetry(obs.CallbackSink(sink)):
            res = trials.run_trials(c, cfg, t_steps, seeds=seeds, syn=syn,
                                    stimulus=stim, chunk_steps=chunk_steps,
                                    device=device)
        return res.counts, res.dropped, tuple(res.state)

    return run


def reference(net: dict, conf: dict, traffic: dict, seeds, t_steps: int,
              device, *, record: bool = False, control: bool = False
              ) -> check.Result:
    """The plain reference (``reference/pd14.py``) from rest; ``control``
    computes it a precision below the configuration's (Q23.8 for Q19.12,
    bfloat16 for float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = pd14.simulate(net, conf, traffic["drive"], seeds, t_steps, device,
                      record=record, control=control)
    return check.Result(counts=r.counts, dropped=r.dropped,
                        state=(r.v, r.g, r.refrac, r.pending), stats=r.stats)


#: Bytes of a changed v, g and refractory countdown, read and written.
BYTES_V, BYTES_G, BYTES_REFRAC, BYTES_PENDING = 4, 4, 1, 4
BYTES_SYNAPSE, BYTES_ADD = 4, 4
OPS_PER_DRAW, OPS_PER_V, OPS_PER_G = 70, 6, 4


def least_work(stats: dict, start: int, stop: int, scale: float = 1.0
               ) -> tuple[float, float]:
    """(bytes, operations) of steps ``start .. stop - 1``, from what the
    inputs need: a synapse event reads its packed 4-byte synapse and adds
    4 bytes; each changed field of a lane-neuron (v, g, the countdown, a
    pending slot read and zeroed) is read and written once at its least
    width; a threefry draw is 70 operations (``portbench/yardstick.py``),
    an event one add, a changed v six and a changed g four."""
    s = {k: scale * np.asarray(v[start:stop], np.float64)
         for k, v in stats.items()}
    nbytes = (2 * (BYTES_V * s["v_changed"].sum()
                   + BYTES_G * s["g_changed"].sum()
                   + BYTES_REFRAC * s["refrac_changed"].sum()
                   + BYTES_PENDING * s["pending_read"].sum())
              + (BYTES_SYNAPSE + BYTES_ADD) * s["syn_events"].sum())
    ops = (OPS_PER_DRAW * s["draws"].sum() + s["syn_events"].sum()
           + OPS_PER_V * s["v_changed"].sum()
           + OPS_PER_G * s["g_changed"].sum())
    return float(nbytes), float(ops)


def small(conf: dict) -> dict:
    """The configuration at ``SMALL_SCALE`` of its neurons (1,544 neurons,
    119,729 synapses)."""
    return {**conf, "network": {**conf["network"], "scale": SMALL_SCALE}}
