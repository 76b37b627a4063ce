"""The FlyWire LIF family: the current-based LIF network on a network of
FlyWire's statistics, driven by Poisson and background spikes, as the
paper's section 3 defines it.

It wires together what the benchmark already holds: the frozen network
generator and its cache (``portbench/network.py``), the plain reference
(``portbench/reference/sim.py``), the least-work count
(``portbench/yardstick.py``), and, for the program, the port's
``Connectome``, ``build_synapses`` and ``run_trials``.  The program is
imported inside :func:`program` alone, so that loading this file, the
network and the reference loads nothing of it.

A configuration of this family holds ``network`` (the generator's
``n_neurons``, ``target_synapses`` and ``seed``), ``model`` (the LIF
constants, ``fixed_point``, ``weight_bits``) and ``engine``; its traffic's
``drive`` is a list of ``poisson`` and ``background`` parts.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check, network as _network, yardstick
from portbench.reference import sim

#: The final state the program returns and the reference works out, in
#: the program's order: membrane, conductance, refractory countdown.
STATE = ("v", "g", "refrac")

#: The CPU tests' size of a network.
SMALL_NEURONS, SMALL_SYNAPSES = 2000, 60_000


def dt_ms(conf: dict) -> float:
    """The simulated milliseconds of one step."""
    return conf["model"]["dt"]


def network(spec: dict, cache_dir: str) -> dict:
    """The arrays of the configuration's ``network`` entry, cached as
    ``flywire_{n_neurons}_{target_synapses}_{seed}.npz``."""
    return _network.load_network(spec, cache_dir)


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
            idx = _network.pick(n, p["pick"], p["pick_seed"])
            parts.append(PoissonDrive(
                idx=torch.from_numpy(idx.astype(np.int32)),
                rate_hz=p["rate_hz"], target=p.get("target", "g"),
                weight=p["weight"]))
        elif p["kind"] == "background":
            parts.append(Background(rate_hz=p["rate_hz"]))
        else:
            raise ValueError(f"unknown drive part {p['kind']!r}")
    return Compose(tuple(parts))


def program(conf: dict, traffic: dict, net: dict, device):
    """Set-up: the ``Connectome``, the engine's synapse store and the
    stimulus on ``device``.  Returns ``run(t_steps, seeds, chunk_steps,
    sink) -> (counts, dropped, state)``: one experiment of ``run_trials``
    over the lanes' seeds, chunked, in a telemetry session whose events go
    to ``sink`` (``run_trials`` is looked up at each call)."""
    from repro_torch import obs
    from repro_torch.core import Connectome, build_synapses
    from repro_torch.exp import trials

    c = Connectome(n=net["n"], **{k: net[k] for k in _network.ARRAYS})
    cfg = program_config(conf)
    syn = build_synapses(c, cfg, device)
    stim = program_stimulus(traffic, c.n).to(device)

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
    """The plain reference (``reference/sim.py``) from rest; ``control``
    computes it a precision below the configuration's."""
    r = sim.simulate(net, conf["model"], traffic["drive"], seeds, t_steps,
                     device, record=record, control=control)
    return check.Result(counts=r.counts, dropped=r.dropped,
                        state=(r.v, r.g, r.refrac), stats=r.stats)


least_work = yardstick.least_work


def small(conf: dict) -> dict:
    """The configuration on a 2,000-neuron, 60,000-synapse network."""
    return {**conf, "network": {**conf["network"],
                                "n_neurons": SMALL_NEURONS,
                                "target_synapses": SMALL_SYNAPSES}}
