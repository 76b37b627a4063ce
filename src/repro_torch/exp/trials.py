"""Trial batches: the paper's 10-trial statistic in one run of B lanes.

Counterpart of ``repro/exp/trials.py``.  The paper validates
implementations by comparing per-neuron spike rates averaged over 10
trials (Figs 6, 12, 14-15).  The reference vmaps its simulation scan over
a batch of seeds; here the trial axis is the step's lane axis
(:mod:`repro_torch.core.step`): every op of a step runs once for all B
lanes, and each delivery kernel launches once a step for all of them.
:func:`run_trials` is bitwise equal to a loop of
:func:`repro_torch.core.simulate` calls over the same seeds.
:func:`run_dist_trials` is the same batching on the partitioned path,
the trial axis inside each partition (``keys[p, b]``, as the reference
lays them out), bitwise equal to a loop of
:func:`repro_torch.core.simulate_distributed` calls.  ``mean_rates_hz``
feeds :func:`repro_torch.core.validate.parity` directly.

The synaptic state and the stimulus are shared by the lanes; each lane
has its own PRNG stream.  Both runners read nothing back to the host
while they run, unless :func:`run_trials` is supervised
(``chunk_steps``, through :func:`repro_torch.core.health.run_chunked`).
:func:`run_dist_trials` also runs on the multi-process path
(``emulate=False`` or a ``mesh``): the lanes lie inside each rank's
partition, as on the emulated path.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.connectome import Connectome
from repro_torch import obs
from repro_torch.core.engine import (SimConfig, _resolve_probes,
                                     _resolve_stimulus, build_synapses,
                                     init_carry, resolve_device, run_steps)
from repro_torch.core.engines import pending_depth, refuse_per_synapse_delays
from repro_torch.core.health import run_chunked
from repro_torch.core.neuron import LIFState
from repro_torch.core.step import PendingState, final_state


def _seed_tuple(seeds) -> tuple:
    if isinstance(seeds, (int, np.integer)):
        seeds = tuple(range(int(seeds)))
    else:
        seeds = tuple(int(s) for s in seeds)
    if not seeds:
        raise ValueError("need at least one seed")
    return seeds


def trial_carry(n: int, cfg: SimConfig, stimulus, seeds, device=None,
                depth=None):
    """Trial-batched carry: what ``simulate(..., seed=s)`` starts from, one
    lane per seed, in the step's lane layout.  ``seeds`` is a trial count
    B (seeds 0..B-1) or a sequence; ``depth`` the pending ring's slots of
    an engine with per-synapse delays.  Returns ``(carry, seeds)`` with
    ``seeds`` normalized to a tuple."""
    seeds = _seed_tuple(seeds)
    return init_carry(n, cfg, stimulus, seeds, resolve_device(device),
                      depth), seeds


# Compile-cache accounting with a telemetry session active, keyed as the
# reference's vmapped trials scan (repro_torch.obs).
_run_trial_steps = obs.InstrumentedCall(run_steps, "engine.run_trials",
                                        static_argnums=(3, 4, 5, 6))


def _rates_hz(counts: torch.Tensor, t_steps: int, dt_ms: float
              ) -> np.ndarray:
    return (np.asarray(counts.cpu(), np.float64)
            / (t_steps * dt_ms * 1e-3))


class TrialResult(NamedTuple):
    """A trial batch's result.  ``state`` is the final state: a
    :class:`LIFState` (v, g, refrac, ``[B, n]`` each) for every engine of
    the one uniform delay, whose ring of spikes is not returned; for an
    engine with per-synapse delays (``delay_event``) a
    :class:`~repro_torch.core.step.PendingState`, whose fourth field is the
    pending ring as ``[B, n, D]`` int32, a view of the carry's
    ``[D, B, n]`` ring (slot s: the input due at the steps t with
    t % D == s), not a copy."""
    counts: torch.Tensor   # [B, n] int32 per-trial spike counts
    dropped: torch.Tensor  # [B] int32
    state: LIFState | PendingState
    records: dict          # probe records, each [B, T, ...]
    seeds: tuple           # the seeds, in batch order

    def rates_hz(self, t_steps: int, dt_ms: float) -> np.ndarray:
        """[B, n] per-trial per-neuron rates (float64, on the host)."""
        return _rates_hz(self.counts, t_steps, dt_ms)

    def mean_rates_hz(self, t_steps: int, dt_ms: float) -> np.ndarray:
        """[n] trial-averaged rates: the parity-plot statistic."""
        return self.rates_hz(t_steps, dt_ms).mean(axis=0)


def run_trials(
    c: Connectome,
    cfg: SimConfig,
    t_steps: int,
    sugar_neurons: np.ndarray | None = None,
    seeds: int | Sequence[int] = 10,
    syn: Any | None = None,
    stimulus: Any | None = None,
    probes: Any | None = None,
    chunk_steps: int | None = None,
    *,
    device=None,
    partitionable: bool = True,
) -> TrialResult:
    """Run one trial per seed as one batch of lanes.

    ``seeds`` is either a trial count B (seeds 0..B-1) or an explicit
    sequence.  Synaptic state and the stimulus are shared across trials;
    each trial gets its own PRNG stream, exactly as ``simulate(...,
    seed=s)`` would.  ``device`` defaults to CUDA and raises without it;
    ``partitionable`` is the threefry mode (JAX's
    ``jax_threefry_partitionable``).

    ``chunk_steps=K`` supervises the batch as ``simulate()`` does
    (:func:`repro_torch.core.health.run_chunked`), bitwise equal to one
    run, with ``cfg.health`` checked at chunk boundaries against the
    counters summed over the whole batch.
    """
    device = resolve_device(device)
    n = c.n
    if syn is None:
        syn = build_synapses(c, cfg, device)
    stimulus = _resolve_stimulus(cfg, n, sugar_neurons, stimulus).to(device)
    probes = _resolve_probes(cfg, probes)
    carry, seeds = trial_carry(n, cfg, stimulus, seeds, device,
                               pending_depth(cfg, syn))

    def run_chunk(cy, s, k):
        return _run_trial_steps(syn, cy, stimulus, cfg, probes, k, n, s,
                                partitionable=partitionable)

    # records are [B, T, ...] -> time axis 1; the rate envelope
    # normalizes by the batch-summed neuron count
    carry, records = run_chunked(
        run_chunk, carry, t_steps, chunk_steps, time_axis=1,
        health=cfg.health, n=n * len(seeds), dt_ms=cfg.params.dt)
    return TrialResult(counts=carry.counts, dropped=carry.dropped,
                       state=final_state(carry), records=records,
                       seeds=seeds)


class DistTrialResult(NamedTuple):
    """Trial-batched distributed run; per-neuron data in original ids."""
    counts: torch.Tensor   # [B, n_orig] int64 per-trial spike counts
    dropped: torch.Tensor  # [B] int64, summed over the partitions
    state: LIFState        # leaves [B, n_orig]
    records: dict          # probe records, each [B, T, ...] (original ids)
    stats: dict            # scheme counters, each [B]
    seeds: tuple

    def rates_hz(self, t_steps: int, dt_ms: float) -> np.ndarray:
        """[B, n] per-trial per-neuron rates (float64, on the host)."""
        return _rates_hz(self.counts, t_steps, dt_ms)

    def mean_rates_hz(self, t_steps: int, dt_ms: float) -> np.ndarray:
        """[n] trial-averaged rates: the parity-plot statistic."""
        return self.rates_hz(t_steps, dt_ms).mean(axis=0)


def run_dist_trials(
    d,
    cfg,
    t_steps: int,
    sugar_neurons: np.ndarray | None = None,
    seeds: int | Sequence[int] = 10,
    stimulus: Any | None = None,
    probes: Any | None = None,
    mesh=None,
    emulate: bool = True,
    *,
    device=None,
    partitionable: bool = True,
) -> DistTrialResult:
    """Distributed counterpart of :func:`run_trials`: the partitions
    emulated on one device, or one a process (``emulate=False`` or a
    ``mesh``, as :func:`repro_torch.core.simulate_distributed` takes
    them), each running every lane of the seed batch, bitwise equal to a
    loop of :func:`repro_torch.core.simulate_distributed` over the same
    seeds.  ``d`` is a :class:`repro_torch.core.dcsr.DCSR`, ``cfg`` a
    :class:`repro_torch.core.distributed.DistConfig`."""
    from repro_torch.core.distributed import (_assemble, _mesh_for,
                                              run_partitioned)
    refuse_per_synapse_delays(cfg.sim.engine, "run_dist_trials")
    mesh = _mesh_for(d, emulate, mesh, device)
    seeds = _seed_tuple(seeds)
    device = mesh.device if mesh is not None else resolve_device(device)
    # keys[p, b] = what simulate_distributed(seed=seeds[b]) hands part p
    keys = torch.stack(
        [prng.split(prng.PRNGKey(s, device=device), d.n_parts,
                    partitionable=partitionable) for s in seeds],
        dim=1)                                           # [P, B, 2]
    carries, records, owner = run_partitioned(
        d, cfg, t_steps, keys, sugar_neurons, stimulus, probes, device,
        partitionable, mesh=mesh)
    counts, dropped, state, recs, stats = _assemble(d, carries, records,
                                                    owner)
    return DistTrialResult(counts=counts, dropped=dropped, state=state,
                           records=recs, stats=stats, seeds=seeds)


__all__ = ["DistTrialResult", "TrialResult", "run_dist_trials", "run_trials",
           "trial_carry"]
