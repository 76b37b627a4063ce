"""Connectome LIF simulation over pluggable delivery engines.

Counterpart of ``repro/core/engine.py``.  :func:`simulate` builds the
engine's synaptic state on the device once, sets up the carry (LIF state,
a ring, the PRNG key, counters) and runs the step loop of
:mod:`repro_torch.core.step` through the P=1 ``local`` exchange scheme.
The ring is one of two (:class:`~repro_torch.core.step.SimCarry`): for
every engine of the JAX package, the bool ring of the spikes of the one
uniform delay (1.8 ms for FlyWire), ``[D, B, n]`` with D = ``delay_steps``;
for the ``delay_event`` engine, whose synapses each have a delay, the
int32 ring of pending input, ``[D, B, n]`` with D its longest delay + 1,
which the run's final state returns as ``[B, n, D]``.

The step runs a batch of lanes (the reference's ``vmap`` over trials,
written out as a leading axis): :func:`init_carry` makes a trial batch's
carry from a sequence of seeds, one PRNG stream per lane, and
:func:`run_steps` runs it to ``[B, T, ...]`` records (the counterpart of
the reference's ``_run_scan_trials``, which
:func:`repro_torch.exp.run_trials` calls).  A single run's carry, from
one seed, has no lane axis; :func:`run_steps` runs it as the batch of one
lane and takes the axis off again, so :func:`simulate` is the B = 1 case
of the same loop.

It runs on the CUDA device unless the caller names another device; with
no device named and no CUDA device present it raises, so a run never
lands on the CPU by accident.

Supervision (:mod:`repro_torch.core.health`): every run goes through
:func:`~repro_torch.core.health.run_chunked`, as one chunk when
``chunk_steps`` is None; ``chunk_steps``, ``checkpoint_dir`` / ``resume``
/ ``async_checkpoint`` and ``cfg.health`` split and supervise the same
steps, bitwise equal to the run in one chunk.  With a telemetry session
active (:mod:`repro_torch.obs`) the run emits ``run_start`` / ``chunk``
/ ``run_end`` events and spans, and ``SimResult.stats["compile_cache"]``
counts the step loop's signatures.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch import random as prng

from .capacity import MONOLITHIC_CAPACITY, CapacityConfig, merge_legacy_capacity
from .connectome import Connectome
from .engines import available_engines, get_engine, pending_depth
from .health import (HealthConfig, SimCheckpointer, carry_counters,
                     health_stats_init, run_chunked)
from .neuron import LIFParams, LIFState, f32, init_state
from .step import SimCarry, final_state, scan_steps


@dataclasses.dataclass(frozen=True)
class SimConfig:
    params: LIFParams = LIFParams()
    engine: str = "csr"             # see repro_torch.core.engines
    fixed_point: bool = False
    quantize_bits: Optional[int] = None   # 9 = Loihi; None = raw weights
    # Legacy stimulus fields: consumed by repro_torch.exp.legacy_stimulus
    # when simulate() is called without an explicit stimulus.
    poisson_to_v: bool = True       # True = Brian2 semantics; False = Loihi approx
    poisson_rate_hz: float = 150.0
    poisson_weight: float = 180.0   # weight units delivered per Poisson event
    background_rate_hz: float = 0.0  # scaling-study probabilistic spiking
    # Deprecated capacity shims -> capacity (CapacityConfig)
    spike_capacity: Optional[int] = None
    syn_budget: Optional[int] = None
    block_capacity: Optional[int] = None
    ell_width_cap: int = 4096        # SSD fan-in cap (the ell engine)
    collect_raster: bool = False     # deprecated: use ProbeSpec(raster=True)
    capacity: Optional[CapacityConfig] = None   # event-path static budgets
    health: Optional[HealthConfig] = None   # in-step sentinels + thresholds

    def __post_init__(self):
        cap = merge_legacy_capacity(
            self.capacity, self.spike_capacity, self.syn_budget,
            self.block_capacity, MONOLITHIC_CAPACITY, "SimConfig")
        object.__setattr__(self, "capacity", cap)
        for f in ("spike_capacity", "syn_budget", "block_capacity"):
            object.__setattr__(self, f, None)
        if self.collect_raster:
            warnings.warn(
                "SimConfig(collect_raster=True) is deprecated; pass "
                "probes=ProbeSpec(raster=True) instead",
                DeprecationWarning, stacklevel=3)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when none is named; raises when none
    is named and CUDA is absent (no silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: repro_torch runs on the GPU "
                           "unless a device is named (device='cpu' runs the "
                           "plain PyTorch versions of the kernels)")
    return torch.device("cuda")


def build_synapses(c: Connectome, cfg: SimConfig, device=None) -> Any:
    """Build the engine's synaptic state on ``device``; pass it back to
    :func:`simulate` via ``syn=`` to reuse it across runs.  For an engine
    with per-synapse delays the ``build`` span carries the store's
    ``store_bytes`` and its pending ring's ``depth``."""
    with obs.span("build", what="synapses", engine=cfg.engine) as sp:
        syn = get_engine(cfg.engine).build(c, cfg, resolve_device(device))
        if pending_depth(cfg, syn) is not None:
            sp.attrs.update(store_bytes=syn.nbytes, depth=syn.depth)
        return syn


class SimResult(NamedTuple):
    counts: torch.Tensor
    state: LIFState        # or a PendingState (per-synapse delays)
    dropped: torch.Tensor
    raster: torch.Tensor | None
    records: dict          # ProbeSpec-selected [T, ...] tensors
    stats: dict = {}       # health counters (repro_torch.core.health)


def init_carry(n: int, cfg: SimConfig, stimulus, seed, device,
               depth: Optional[int] = None) -> SimCarry:
    """The carry at step 0 of a run from ``seed``: an int gives a single
    run's carry (leaves ``[n]``, ring ``[D, n]``, key ``[2]``), a sequence
    of seeds a trial batch's in the step's lane layout (leaves ``[B, n]``,
    ring ``[D, B, n]``, keys ``[B, 2]``), lane b starting as a single run
    from ``seed[b]`` would.  ``depth`` (an engine with per-synapse delays:
    :func:`~repro_torch.core.engines.pending_depth`) gives the carry a
    zero pending ring of that many slots, and the engine's counters, in
    place of the ring of spikes."""
    if isinstance(seed, (int, np.integer)):
        return single_lane(init_carry(n, cfg, stimulus, [int(seed)], device,
                                      depth))
    keys = torch.stack([prng.PRNGKey(s, device=device) for s in seed])
    B = keys.shape[0]

    def lanes(x):
        return x.expand((B,) + x.shape).clone()
    stats = health_stats_init(cfg, B, device)
    ring = pending = None
    if depth is None:
        ring = torch.zeros((cfg.params.delay_steps, B, n), dtype=torch.bool,
                           device=device)
    else:
        pending = torch.zeros((depth, B, n), dtype=torch.int32,
                              device=device)
        stats.update(get_engine(cfg.engine).init_stats(B, device))
    return SimCarry(
        lif=LIFState(*(lanes(x) for x in init_state(
            n, cfg.params, cfg.fixed_point, device=device))),
        ring=ring,
        ptr=0,
        key=keys,
        counts=torch.zeros((B, n), dtype=torch.int32, device=device),
        dropped=torch.zeros(B, dtype=torch.int32, device=device),
        stim=stimulus.init_state(n),
        stats=stats,
        pending=pending,
    )


def _map_lanes(carry: SimCarry, fn, ring_fn) -> SimCarry:
    def rings(x):
        return None if x is None else ring_fn(x)
    return carry._replace(
        lif=LIFState(*(fn(x) for x in carry.lif)), ring=rings(carry.ring),
        key=fn(carry.key), counts=fn(carry.counts),
        dropped=fn(carry.dropped),
        stats={k: fn(v) for k, v in carry.stats.items()},
        pending=rings(carry.pending))


def lane_batch(carry: SimCarry) -> SimCarry:
    """A single run's carry as the batch of one lane (views, no copy)."""
    return _map_lanes(carry, lambda x: x.unsqueeze(0),
                      lambda r: r.unsqueeze(1))


def single_lane(carry: SimCarry) -> SimCarry:
    """The one lane of a batch of one, without its lane axis (views)."""
    return _map_lanes(carry, lambda x: x.squeeze(0), lambda r: r.squeeze(1))


def run_steps(syn, carry: SimCarry, stim, cfg: SimConfig, probes,
              t_steps: int, n: int, t0: int = 0,
              partitionable: bool = True) -> tuple[SimCarry, dict]:
    """Run ``t_steps`` steps from ``carry`` through the ``local`` scheme.
    A trial batch's carry (keys ``[B, 2]``) gives ``[B, T, ...]`` records,
    the counterpart of the reference's ``_run_scan_trials``; a single
    run's (key ``[2]``) runs as one lane and gives ``[T, ...]``, the
    counterpart of ``_run_scan``.  The given carry is not modified."""
    from .exchange import Topology, get_scheme
    single = carry.key.dim() == 1
    carry, records = scan_steps(
        get_scheme("local"), syn, lane_batch(carry) if single else carry,
        stim, cfg, cfg.capacity, Topology(1, n, axis=None), probes, t_steps,
        t0=t0, partitionable=partitionable)
    if single:
        carry = single_lane(carry)
        records = {k: v.squeeze(0) for k, v in records.items()}
    return carry, records


# Compile-cache accounting (repro_torch.obs): with a telemetry session
# active, calls count per signature (the config, probes, step count and
# neuron count by value, the tensors by shape), as the reference's
# InstrumentedJit keys its jitted scan; otherwise the plain call.
_run_steps = obs.InstrumentedCall(run_steps, "engine.run_scan",
                                  static_argnums=(3, 4, 5, 6))


def _resolve_stimulus(cfg: SimConfig, n: int, sugar_neurons, stimulus):
    if stimulus is not None:
        if sugar_neurons is not None:
            raise ValueError(
                "pass either sugar_neurons (legacy drive) or stimulus, "
                "not both — an explicit stimulus ignores sugar_neurons")
        return stimulus
    from repro_torch.exp.stimulus import legacy_stimulus
    sugar_idx = None
    if sugar_neurons is not None:
        warnings.warn(
            "sugar_neurons= is deprecated; pass stimulus= instead (e.g. "
            "repro_torch.exp.PoissonDrive(idx=...) or legacy_stimulus(cfg, "
            "n, sugar_idx))", DeprecationWarning, stacklevel=3)
        sugar_idx = np.asarray(sugar_neurons).astype(np.int32)
    return legacy_stimulus(cfg, n, sugar_idx)


def _resolve_probes(cfg: SimConfig, probes):
    if probes is not None:
        return probes
    from repro_torch.exp.probes import ProbeSpec
    return ProbeSpec(raster=cfg.collect_raster)


def simulate(
    c: Connectome,
    cfg: SimConfig,
    t_steps: int,
    sugar_neurons: np.ndarray | None = None,
    seed: int = 0,
    syn: Any | None = None,
    stimulus: Any | None = None,
    probes: Any | None = None,
    chunk_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    async_checkpoint: bool = False,
    *,
    device=None,
    partitionable: bool = True,
) -> SimResult:
    """Run ``t_steps`` of the network; returns per-neuron spike counts (the
    paper's validation statistic) plus any probe records.

    ``cfg.engine`` selects a registered delivery engine; ``syn``
    optionally supplies a state from :func:`build_synapses` (on
    ``device``).  ``stimulus`` is a stimulus of :mod:`repro_torch.exp`
    (default: the legacy drive reconstructed from ``cfg`` and
    ``sugar_neurons``); ``probes`` a :class:`repro_torch.exp.ProbeSpec`.
    ``device`` defaults to CUDA; ``partitionable`` is the threefry mode
    that ``seed``'s stream follows (JAX's ``jax_threefry_partitionable``).

    ``chunk_steps=K`` runs the same steps as ceil(T/K) chunks with the
    carry handed on between them, bitwise equal to one run; at each
    boundary the host checks ``cfg.health`` and (with
    ``checkpoint_dir``) checkpoints the carry, so a killed run restarted
    with ``resume=True`` reproduces the uninterrupted one bit for bit
    (see :mod:`repro_torch.core.health`).
    """
    tele = obs.active()
    with obs.span("simulate", engine=cfg.engine):
        device = resolve_device(device)
        n = c.n
        if syn is None:
            syn = build_synapses(c, cfg, device)
        stimulus = _resolve_stimulus(cfg, n, sugar_neurons,
                                     stimulus).to(device)
        probes = _resolve_probes(cfg, probes)
        carry = init_carry(n, cfg, stimulus, seed, device,
                           pending_depth(cfg, syn))
        if tele is not None:
            tele.emit("run_start", kind="simulate", engine=cfg.engine,
                      n=n, t_steps=t_steps, chunk_steps=chunk_steps,
                      fixed_point=cfg.fixed_point)
        t_run = time.monotonic()
        ckpt = (SimCheckpointer(checkpoint_dir, async_save=async_checkpoint)
                if checkpoint_dir is not None else None)

        def run_chunk(cy, s, k):
            return _run_steps(syn, cy, stimulus, cfg, probes, k, n, s,
                              partitionable=partitionable)

        carry, records = run_chunked(
            run_chunk, carry, t_steps, chunk_steps, time_axis=0,
            health=cfg.health, n=n, dt_ms=cfg.params.dt,
            checkpointer=ckpt, resume=resume)
        stats = dict(carry.stats)
        if tele is not None:
            tele.emit("run_end", steps=t_steps,
                      wall_s=round(time.monotonic() - t_run, 6),
                      counters=carry_counters(carry),
                      metrics=tele.metrics.counters())
            stats["compile_cache"] = tele.metrics.compile_snapshot()
    return SimResult(counts=carry.counts, state=final_state(carry),
                     dropped=carry.dropped, raster=records.get("raster"),
                     records=records, stats=stats)


def spike_rates_hz(counts: torch.Tensor, t_steps: int, dt_ms: float
                   ) -> torch.Tensor:
    return counts.to(torch.float32) / f32(t_steps * dt_ms * 1e-3, counts)


__all__ = ["SimCarry", "SimConfig", "SimResult", "available_engines",
           "build_synapses", "init_carry", "lane_batch", "resolve_device",
           "run_steps", "simulate", "single_lane", "spike_rates_hz"]
