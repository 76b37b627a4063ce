"""Partitioned multi-core SNN simulation (paper §3.2.2-3.2.3), emulated.

Counterpart of ``repro/core/distributed.py``.  A DCSR snapshot's P
partitions each run the step of :mod:`repro_torch.core.step` through a
registered exchange scheme (``bitmap``, ``event``, ``blocked``, or the
``faulty`` wrapper of one of them); the only contact between partitions
is the scheme's collective.

The reference runs the partitions as one program, vmapped with a named
axis on one device (``emulate=True``) or sharded over a device mesh.
Here ``emulate=True`` runs them on one device, one after another: each
step, every partition's exchange half, then the emulated ``all_gather``
of their contributions in partition order, then every partition's rest
of the step (:func:`_run_emulated`).  Each step's exchange sees the
absolute step index, so the ``faulty`` scheme's injections fire at the
same steps in a resumed run as in an unbroken one.  The PRNG streams
are per partition and independent, so the order of the partitions
changes no result.  The real multi-device path (``emulate=False``,
``torch.distributed`` over several GPUs) is not ported: it raises
``NotImplementedError``.

Supervision (``chunk_steps``, checkpoints, ``sim.health``) and telemetry
go through :func:`repro_torch.core.health.run_chunked` as on the
monolithic path, with the list of per-partition carries as the carry
and the records stacked over the partitions; as in the reference, the
trial-batched path (:func:`repro_torch.exp.run_dist_trials`) rejects
supervision.

Records and counts come back in original neuron ids through ``inv_perm``;
pad neurons never spike (the step's pad mask) and never appear in any
record or count.

Each partition's carry is in the step's lane layout (:class:`~repro_torch.
core.step.SimCarry`): a trial batch's B lanes lie inside each partition,
as the reference's trial axis does (``keys[p, b]``), and every op of a
partition's step runs once for all of them.  :func:`simulate_distributed`
is the batch of one lane, with the lane axis taken off before the
mapping back to original ids; :func:`repro_torch.exp.run_dist_trials`
keeps it.
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
from repro_torch.tree import map_tensors

from .capacity import DISTRIBUTED_CAPACITY, CapacityConfig, merge_legacy_capacity
from .dcsr import DCSR
from .engine import SimConfig, resolve_device, single_lane
from .exchange import Topology, all_gather, get_scheme
from .health import (SimCheckpointer, carry_counters, health_stats_init,
                     run_chunked)
from .neuron import LIFState, init_state
from .step import SimCarry, step_exchange, step_finish

AXIS = "cores"


@dataclasses.dataclass(frozen=True)
class DistConfig:
    sim: SimConfig
    scheme: str = "event"        # see repro_torch.core.exchange
    # Deprecated capacity shims -> capacity (CapacityConfig)
    spike_capacity: Optional[int] = None
    syn_budget: Optional[int] = None
    block_capacity: Optional[int] = None
    capacity: Optional[CapacityConfig] = None

    def __post_init__(self):
        cap = merge_legacy_capacity(
            self.capacity, self.spike_capacity, self.syn_budget,
            self.block_capacity, DISTRIBUTED_CAPACITY, "DistConfig")
        object.__setattr__(self, "capacity", cap)
        for f in ("spike_capacity", "syn_budget", "block_capacity"):
            object.__setattr__(self, f, None)


class DistResult(NamedTuple):
    """``SimResult``-shaped result in original neuron ids."""
    counts: torch.Tensor          # [n_orig] int64 spike counts
    dropped: int
    state: LIFState               # leaves [n_orig]
    raster: torch.Tensor | None   # [T, n_orig] (iff the raster probe is on)
    records: dict                 # ProbeSpec records, leading axis T
    stats: dict                   # scheme counters (blocked: tiles_*)


def make_core_mesh(n_cores: int, devices=None):
    raise NotImplementedError(
        "the multi-device path (one partition per GPU over "
        "torch.distributed) is not ported; use emulate=True")


def _resolve_dist_stimulus(d: DCSR, sc: SimConfig, sugar_neurons, stimulus):
    from repro_torch.exp.stimulus import legacy_stimulus, shard_stimulus
    if stimulus is None:
        if sugar_neurons is not None:
            warnings.warn(
                "sugar_neurons= is deprecated; pass stimulus= instead "
                "(e.g. repro_torch.exp.PoissonDrive(mask=...) or "
                "legacy_stimulus(cfg, n, sugar_idx, masked=True))",
                DeprecationWarning, stacklevel=4)
        stimulus = legacy_stimulus(sc, d.n_orig, sugar_idx=sugar_neurons,
                                   masked=True)
    elif sugar_neurons is not None:
        raise ValueError(
            "pass either sugar_neurons (legacy drive) or stimulus, "
            "not both — an explicit stimulus ignores sugar_neurons")
    return shard_stimulus(stimulus, d)


def _resolve_dist_probes(d: DCSR, sc: SimConfig, probes):
    """The probe spec, and the per-partition voltage-row remap:
    ``rows[p, i]`` is probe id i's local row on partition p (0 where p
    does not own it; the assembly keeps the owner's trace)."""
    if probes is None:
        from repro_torch.exp.probes import ProbeSpec
        probes = ProbeSpec(raster=sc.collect_raster)
    P_, U = d.n_parts, d.part_size
    ids = np.asarray(probes.voltage, dtype=np.int64)
    bad = ids[(ids < 0) | (ids >= d.n_orig)]
    if bad.size:
        raise ValueError(f"voltage probe ids {bad.tolist()} out of range "
                         f"for n={d.n_orig}")
    gid = d.perm[ids] if ids.size else ids
    owner, local = gid // U, gid % U
    rows = np.where(owner[None, :] == np.arange(P_)[:, None], local[None, :],
                    0)                                      # [P, n_probe]
    return probes, rows, owner.astype(np.int64)


def _init_dist_carry(d: DCSR, cfg: DistConfig, stim, scheme, keys,
                     device) -> list[SimCarry]:
    """One carry per partition, in the step's lane layout; ``keys`` is
    [P, B, 2]: ``keys[p, b]`` is lane b's key on partition p."""
    P_, U = d.n_parts, d.part_size
    B = keys.shape[1]
    sc = cfg.sim
    lif0 = init_state(P_ * U, sc.params, sc.fixed_point, device=device)
    carries = []
    for p in range(P_):
        carries.append(SimCarry(
            lif=LIFState(*(x.reshape(P_, U)[p].expand(B, U).clone()
                           for x in lif0)),
            ring=torch.zeros((sc.params.delay_steps, B, U), dtype=torch.bool,
                             device=device),
            ptr=0, key=keys[p],
            counts=torch.zeros((B, U), dtype=torch.int32, device=device),
            dropped=torch.zeros(B, dtype=torch.int32, device=device),
            stim=stim.init_state(U),
            stats={**{k: torch.zeros(B, dtype=torch.int32, device=device)
                      for k in scheme.init_stats()},
                   **health_stats_init(sc, B, device)}))
    return carries


def _run_emulated(scheme, states, carries, stims, pads, vrows,
                  cfg: DistConfig, probes, t_steps: int, topo: Topology,
                  partitionable: bool, t0: int = 0):
    """The partitions' steps on one device, from the absolute step
    ``t0``: per step, every partition's exchange half, the emulated
    all_gather, every partition's finish.  Returns the final carries and
    each partition's records, ``[B, T, ...]`` per name.  The given list
    and its carries are not modified (each ring is copied once, then
    written in place)."""
    P_ = len(carries)
    carries = [c._replace(ring=c.ring.clone()) for c in carries]
    topos = [topo._replace(index=p) for p in range(P_)]
    common = dict(scheme=scheme, cap=cfg.capacity, partitionable=partitionable)
    records: list[dict[str, list]] = [{} for _ in range(P_)]
    for t in range(t0, t0 + t_steps):
        exs = [step_exchange(carries[p], t, state=states[p], stim=stims[p],
                             topo=topos[p], **common) for p in range(P_)]
        gathered = all_gather([ex.sent for ex in exs])
        for p in range(P_):
            carries[p], rec = step_finish(
                carries[p], exs[p], gathered, t, state=states[p],
                stim=stims[p], sim=cfg.sim, topo=topos[p], probes=probes,
                pad_mask=pads[p], voltage_rows=vrows[p], **common)
            for k, v in rec.items():
                records[p].setdefault(k, []).append(v)
    return carries, [{k: torch.stack(v, dim=1) for k, v in r.items()}
                     for r in records]


def _to_orig(d: DCSR, arr: torch.Tensor, dtype=None) -> torch.Tensor:
    """[P, *mid, U] partition-stacked -> [*mid, n_orig] in original ids;
    pad slots are dropped."""
    mid = tuple(arr.shape[1:-1])
    flat = torch.movedim(arr, 0, -2).reshape(mid + (d.n_parts * d.part_size,))
    out = torch.zeros(mid + (d.n_orig,), dtype=dtype or arr.dtype,
                      device=arr.device)
    valid = d.inv_perm >= 0
    src = torch.from_numpy(np.flatnonzero(valid)).to(arr.device)
    dst = torch.from_numpy(d.inv_perm[valid]).to(arr.device)
    out[..., dst] = flat[..., src].to(out.dtype)
    return out


def _assemble_records(d: DCSR, records: list[dict], owner) -> dict:
    """Per-partition records ``[*lanes, T, ...]`` -> records in original
    neuron ids, with the same leading axes."""
    out = {}
    for name in records[0] if records else ():
        arr = torch.stack([r[name] for r in records])      # [P, T, ...]
        if name == "raster":
            out[name] = _to_orig(d, arr)
        elif name == "v":
            # every partition traced every probe id against its own rows;
            # keep the owning partition's trace per id
            out[name] = torch.stack(
                [arr[int(owner[i]), ..., i] for i in range(arr.shape[-1])],
                dim=-1)
        elif name == "pop_rate_hz":
            # per-partition mean over U (pads included) -> the mean over
            # the n_orig real neurons, in float64 as the reference's host
            # code does it
            out[name] = arr.double().sum(dim=0) * (d.part_size / d.n_orig)
        else:                                   # "dropped" and the rest
            out[name] = arr.sum(dim=0)
    return out


def _assemble(d: DCSR, carries: list[SimCarry], records: list[dict],
              owner):
    """The partitions' final carries and records (with or without the lane
    axis) -> ``(counts int64, dropped, state, records, stats)`` in
    original neuron ids, dropped and each stats counter summed over the
    partitions (``[B]`` with the lane axis, scalars without)."""
    counts = _to_orig(d, torch.stack([c.counts for c in carries]),
                      dtype=torch.int64)
    lif = LIFState(*(_to_orig(d, torch.stack(x)) for x in
                     zip(*(c.lif for c in carries))))
    recs = _assemble_records(d, records, owner)
    stats = {k: torch.stack([c.stats[k] for c in carries]).sum(dim=0)
             for k in carries[0].stats}
    dropped = torch.stack([c.dropped.long() for c in carries]).sum(dim=0)
    return counts, dropped, lif, recs, stats


# Compile-cache accounting (repro_torch.obs), keyed as the reference's
# emulated program: the config, probes and step count by value, the
# scheme by its type.
_run_emulated_call = obs.InstrumentedCall(
    _run_emulated, "distributed.run_emulated", static_argnums=(6, 7, 8))


def run_partitioned(d: DCSR, cfg: DistConfig, t_steps: int, keys,
                    sugar_neurons, stimulus, probes, device,
                    partitionable: bool, trials: bool = True,
                    chunk_steps: Optional[int] = None,
                    checkpoint_dir: Optional[str] = None,
                    resume: bool = False, async_checkpoint: bool = False):
    """Build the scheme's state, shard the stimulus and run the partitions
    from ``keys`` [P, B, 2] (emulated on ``device``); returns the final
    carries, each partition's ``[B, T, ...]`` records and the probe owners.
    Shared by :func:`simulate_distributed` and
    :func:`repro_torch.exp.run_dist_trials` (``trials``).  Both go through
    the chunk loop (one chunk when ``chunk_steps`` is None); the trial
    path rejects supervision, as the reference's does."""
    if cfg.scheme == "local":
        raise ValueError("the 'local' scheme is the monolithic simulate(); "
                         "pick a partitioned exchange scheme")
    if trials and (chunk_steps is not None or checkpoint_dir is not None
                   or cfg.sim.health is not None):
        raise ValueError(
            "chunked supervision (chunk_steps / checkpoint_dir / "
            "health) is not supported on the trial-batched path; "
            "supervise seeds as separate simulate_distributed runs")
    scheme = get_scheme(cfg.scheme)
    P_, U = d.n_parts, d.part_size
    with obs.span("build", what="scheme_state", scheme=cfg.scheme):
        state = scheme.build(d, cfg.sim, cfg.capacity, device)
    stim = _resolve_dist_stimulus(d, cfg.sim, sugar_neurons,
                                  stimulus).to(device)
    probes, rows, owner = _resolve_dist_probes(d, cfg.sim, probes)
    pad = torch.from_numpy(d.inv_perm.reshape(P_, U) >= 0).to(device)
    rows = torch.from_numpy(rows).to(device)
    carries = _init_dist_carry(d, cfg, stim, scheme, keys, device)

    def part(x, p):
        return map_tensors(lambda a: a[p], x)
    states = [part(state, p) for p in range(P_)]
    stims = [part(stim, p) for p in range(P_)]
    vrows = rows if probes.voltage else [None] * P_
    topo = Topology(P_, U, axis=AXIS)

    def run(cs, k, t0):
        return _run_emulated_call(scheme, states, cs, stims, pad, vrows,
                                  cfg, probes, k, topo, partitionable, t0)

    ckpt = (SimCheckpointer(checkpoint_dir, async_save=async_checkpoint)
            if checkpoint_dir is not None else None)

    def run_chunk(cs, s, k):
        # records stacked over the partitions, [P, B, K, ...]
        cs, recs = run(cs, k, s)
        return cs, {name: torch.stack([r[name] for r in recs])
                    for name in (recs[0] if recs else ())}

    carries, stacked = run_chunked(
        run_chunk, carries, t_steps, chunk_steps, time_axis=2,
        health=cfg.sim.health, n=d.n_orig, dt_ms=cfg.sim.params.dt,
        checkpointer=ckpt, resume=resume,
        host_hook=getattr(scheme, "host_supervise", None))
    records = [{name: v[p] for name, v in stacked.items()}
               for p in range(P_)]
    return carries, records, owner


def simulate_distributed(
    d: DCSR,
    cfg: DistConfig,
    t_steps: int,
    sugar_neurons: np.ndarray | None = None,
    seed: int = 0,
    mesh: Any = None,
    emulate: bool = True,
    stimulus=None,
    probes=None,
    chunk_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    async_checkpoint: bool = False,
    *,
    device=None,
    partitionable: bool = True,
) -> DistResult:
    """Run the partitioned network, its partitions emulated on one device.

    ``cfg.scheme`` selects a registered exchange scheme other than
    ``local``.  ``stimulus`` is a stateless stimulus of
    :mod:`repro_torch.exp` addressed in original neuron ids (sharded onto
    the partitioning here; default: the legacy masked drive from
    ``cfg.sim`` and ``sugar_neurons``); ``probes`` a ``ProbeSpec``, whose
    records come back in original ids as :func:`simulate`'s do.
    ``device`` defaults to CUDA and raises without it; ``partitionable``
    is the threefry mode of ``seed``'s stream.  Each partition's key is
    ``split(PRNGKey(seed), P)[p]``, as in the reference.

    ``chunk_steps`` / ``checkpoint_dir`` / ``resume`` /
    ``async_checkpoint`` mirror :func:`repro_torch.core.simulate`'s
    chunked supervision on the partitioned path, and with a telemetry
    session active the run emits the same event stream.
    """
    if not emulate or mesh is not None:
        make_core_mesh(d.n_parts)
    tele = obs.active()
    with obs.span("simulate_distributed", scheme=cfg.scheme):
        device = resolve_device(device)
        if tele is not None:
            tele.emit("run_start", kind="simulate_distributed",
                      scheme=cfg.scheme, n=d.n_orig, t_steps=t_steps,
                      chunk_steps=chunk_steps,
                      fixed_point=cfg.sim.fixed_point)
        t_run = time.monotonic()
        keys = prng.split(prng.PRNGKey(seed, device=device), d.n_parts,
                          partitionable=partitionable)
        carries, records, owner = run_partitioned(
            d, cfg, t_steps, keys[:, None], sugar_neurons, stimulus, probes,
            device, partitionable, trials=False, chunk_steps=chunk_steps,
            checkpoint_dir=checkpoint_dir, resume=resume,
            async_checkpoint=async_checkpoint)
        # the one lane, its axis taken off before the mapping to original
        # ids
        carries = [single_lane(c) for c in carries]
        records = [{k: v.squeeze(0) for k, v in r.items()} for r in records]
        counts, dropped, lif, recs, stats = _assemble(d, carries, records,
                                                      owner)
        if tele is not None:
            tele.emit("run_end", steps=t_steps,
                      wall_s=round(time.monotonic() - t_run, 6),
                      counters=carry_counters(carries),
                      metrics=tele.metrics.counters())
            stats["compile_cache"] = tele.metrics.compile_snapshot()
    return DistResult(counts=counts, dropped=int(dropped), state=lif,
                      raster=recs.get("raster"), records=recs, stats=stats)


__all__ = ["AXIS", "DistConfig", "DistResult", "make_core_mesh",
           "run_partitioned", "simulate_distributed"]
