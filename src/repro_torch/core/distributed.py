"""Partitioned multi-core SNN simulation (paper §3.2.2-3.2.3).

Counterpart of ``repro/core/distributed.py``.  A DCSR snapshot's P
partitions each run the step of :mod:`repro_torch.core.step` through a
registered exchange scheme (``bitmap``, ``event``, ``blocked``, or the
``faulty`` wrapper of one of them); the only contact between partitions
is the scheme's collective.

The reference runs the partitions as one program, vmapped with a named
axis on one device (``emulate=True``) or under ``shard_map`` with one
partition per device of a mesh.  Here:

* ``emulate=True`` runs them on one device, one after another: each
  step, every partition's exchange half, then the emulated
  ``all_gather`` of their contributions in partition order, then every
  partition's rest of the step (:func:`_run_parts`);
* ``emulate=False`` (or a ``mesh``) is PyTorch's form of ``shard_map``:
  SPMD, one process a partition (``torchrun``, or
  ``torch.multiprocessing``), rank p running partition p
  (:func:`make_core_mesh`, :class:`CoreMesh`).  Every rank holds the
  same DCSR (the host code is deterministic; the ranks check a digest
  of ``perm``) and builds only its own partition's scheme state,
  stimulus shard, pad mask, voltage rows and carry on its own device.
  Each step is the same two halves with the process-group
  ``all_gather`` between them (:func:`_run_parts` on the rank's one
  partition); at the end every
  rank gathers every partition's carry and records and maps them back,
  so every rank returns the same :class:`DistResult`, bitwise the
  emulated run's.

Each step's exchange sees the absolute step index, so the ``faulty``
scheme's injections fire at the same steps in a resumed run as in an
unbroken one.  The PRNG streams are per partition and independent, so
the order of the partitions changes no result.

Supervision (``chunk_steps``, checkpoints, ``sim.health``) and telemetry
go through :func:`repro_torch.core.health.run_chunked` as on the
monolithic path, with the list of per-partition carries as the carry
and the records stacked over the partitions; as in the reference, the
trial-batched path (:func:`repro_torch.exp.run_dist_trials`) rejects
supervision.  On the multi-process path a rank's list is its own
partition's carry; the health checks sum the counters over the ranks,
and rank 0 writes each checkpoint in the emulated path's layout (every
partition's carry, gathered), from which every rank resumes its own
partition: an emulated checkpoint resumes a multi-process run, and the
reverse.  ``faulty``'s ``host_supervise`` runs on every rank from the
same host-side plan.

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
import functools
import hashlib
import os
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
from .engines import refuse_per_synapse_delays
from .exchange import Topology, all_gather, all_gather_group, get_scheme
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


BACKENDS = ("nccl", "gloo")


def host_buffer(like: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty payload buffer shaped as ``like``: in pinned host memory
    when the payload is staged (PyTorch's caching host allocator reuses
    it from call to call), else beside ``like``."""
    if staged:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def send_buffer(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """``x`` as a payload: a copy in pinned host memory when staged, else
    ``x`` itself (contiguous)."""
    return host_buffer(x, True).copy_(x) if staged else x.contiguous()


def staged_all_gather(x: torch.Tensor, peers: list[int], rank: int,
                      backend: str) -> list[torch.Tensor]:
    """Every rank's ``x`` of ``peers`` (global ranks, this one among them;
    the same shape and dtype on each), in the order of ``peers``, each a
    new tensor on ``x``'s device.  One send to and one receive from each
    peer, all at once (``batch_isend_irecv``).  Under ``gloo`` a payload
    on the card crosses host memory: copied into pinned host memory
    before the sends and back to the device after the receives (gloo has
    no CUDA collectives or send/recv; its ``all_gather`` would also copy
    every payload into one flat buffer and out again).  Bool tensors
    travel as their uint8 bytes."""
    import torch.distributed as dist
    if len(peers) == 1:
        return [x.clone()]
    is_bool = x.dtype == torch.bool
    payload = x.view(torch.uint8) if is_bool else x
    staged = backend == "gloo" and x.device.type != "cpu"
    send = send_buffer(payload, staged)
    got, ops = {}, []
    for r in peers:
        if r != rank:
            got[r] = host_buffer(send, staged)
            ops += [dist.P2POp(dist.isend, send, r),
                    dist.P2POp(dist.irecv, got[r], r)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    out = [payload.clone() if r == rank else got[r].to(x.device)
           for r in peers]
    return [o.view(torch.bool) for o in out] if is_bool else out


@dataclasses.dataclass(frozen=True)
class CoreMesh:
    """This process's place in the multi-process partitioned run: the
    process group, the rank (= the partition index), the world size (=
    the number of partitions) and the rank's device.

    ``nccl`` moves the payloads device to device and needs one GPU a
    rank.  ``gloo`` is the backend that can put several ranks on one card
    (or run them on the CPU): its payloads cross host memory
    (:func:`staged_all_gather`, the transport of
    :class:`repro_torch.launch.mesh.Mesh` too)."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (same shape and dtype on each), in rank
        order, each a new tensor: :func:`staged_all_gather`."""
        return staged_all_gather(x, list(range(self.world_size)), self.rank,
                                 self.backend)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``x``."""
        return torch.stack(self.all_gather(x)).sum(dim=0)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


def make_core_mesh(n_cores: int, devices=None, *, backend: str = "nccl",
                   init_method: Optional[str] = None) -> CoreMesh:
    """The :class:`CoreMesh` of this process, one partition a process.

    Uses the default process group if one is initialized (its backend
    must be ``backend``), else initializes it from ``init_method``
    (default ``env://``: the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
    that ``torchrun`` sets).  The world size must equal ``n_cores``.
    ``devices[rank]`` is this rank's device; by default
    ``cuda:LOCAL_RANK`` (modulo the cards of the host), and without a
    card that raises: nothing falls back to the CPU.  ``nccl`` refuses
    two ranks on one device, so a ``nccl`` mesh whose ranks would share
    a card raises here, before the first step; ``gloo`` puts any number
    of ranks on a card."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
    elif init_method is None and "RANK" not in os.environ:
        raise RuntimeError(
            "no process group: the multi-process path runs one process a "
            "partition; launch it under torchrun (RANK, WORLD_SIZE, "
            "LOCAL_RANK) or pass init_method, or use emulate=True")
    else:
        dist.init_process_group(backend, init_method=init_method or "env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n_cores:
        raise ValueError(f"{world} processes for {n_cores} partitions: the "
                         f"world size must equal the number of partitions")
    device = rank_device(backend, rank, world, devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return CoreMesh(dist.group.WORLD, rank, world, device, backend)


def rank_device(backend: str, rank: int, world: int, devices=None
                ) -> torch.device:
    """Rank ``rank``'s device: ``devices[rank]``, or by default
    ``cuda:LOCAL_RANK`` modulo the host's cards (raising without one).
    Raises for ``nccl`` when two ranks would share a device (NCCL refuses
    them) or a rank would run off the GPU."""
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
        shared = len({str(torch.device(x)) for x in devices}) < world
    else:
        n_gpu = torch.cuda.device_count()
        if n_gpu == 0:
            raise RuntimeError("no CUDA device: pass devices= to run the "
                               "ranks elsewhere (gloo only)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % n_gpu)
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", world)) > n_gpu
    if backend == "nccl" and (shared or device.type != "cuda"):
        raise ValueError(
            "nccl needs one GPU a rank: these ranks would share a device "
            "or run off the GPU; use backend='gloo' to put several ranks "
            "on one card")
    return device


def gather_tree(mesh: CoreMesh, tree) -> list:
    """Every rank's ``tree`` (the same structure, shapes and dtypes on
    each: a carry, a records dict), in rank order; one ``all_gather`` a
    tensor leaf, other leaves kept from this rank's."""
    leaves: list = []
    map_tensors(lambda x: leaves.append(x) or x, tree)
    gathered = [mesh.all_gather(x) for x in leaves]
    out = []
    for r in range(mesh.world_size):
        it = iter(g[r] for g in gathered)
        out.append(map_tensors(lambda _x: next(it), tree))
    return out


def _check_same_partition(d: DCSR, mesh: CoreMesh) -> None:
    """Raise on every rank unless there is one rank a partition and all
    ranks hold the same partitioning (a digest of ``perm``)."""
    if mesh.world_size != d.n_parts:
        raise ValueError(f"{mesh.world_size} ranks for {d.n_parts} "
                         f"partitions")
    h = hashlib.sha256(np.ascontiguousarray(d.perm).tobytes()).digest()
    mine = torch.tensor([int.from_bytes(h[:8], "little", signed=True)],
                        dtype=torch.int64, device=mesh.device)
    seen = [int(x) for x in mesh.all_gather(mine)]
    if len(set(seen)) != 1:
        raise RuntimeError(f"the ranks hold different partitionings "
                           f"(perm digests {seen})")


class RankCheckpointer(SimCheckpointer):
    """The :class:`~repro_torch.core.health.SimCheckpointer` of one rank
    of the multi-process path, in the emulated path's layout: at each
    save every rank's carry and records are gathered and rank 0 writes
    the list of P carries and the ``[P, ...]`` records; a restore reads
    that layout on every rank and keeps the rank's own partition."""

    def __init__(self, directory: str, mesh: CoreMesh,
                 async_save: bool = False):
        super().__init__(directory, async_save=async_save)
        self.mesh = mesh

    def save(self, step: int, carry, records: dict) -> None:
        carries = gather_tree(self.mesh, carry[0])
        parts = gather_tree(self.mesh, dict(records))
        recs = {k: torch.cat([r[k] for r in parts]) for k in records}
        if self.mesh.rank == 0:
            super().save(step, carries, recs)

    def restore_latest(self, carry_template):
        # rank 0 of an earlier run may still be writing: it reaches this
        # barrier only after its final join
        self.mesh.barrier()
        restored = super().restore_latest(
            [carry_template[0]] * self.mesh.world_size)
        if restored is None:
            return None
        carries, records, step = restored
        r = self.mesh.rank
        return [carries[r]], {k: v[r:r + 1] for k, v in records.items()}, step


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
                     device, parts=None) -> list[SimCarry]:
    """One carry per partition (with ``parts``, those partitions'), in the
    step's lane layout; ``keys`` is [P, B, 2]: ``keys[p, b]`` is lane b's
    key on partition p."""
    P_, U = d.n_parts, d.part_size
    B = keys.shape[1]
    sc = cfg.sim
    lif0 = init_state(P_ * U, sc.params, sc.fixed_point, device=device)
    carries = []
    for p in (range(P_) if parts is None else parts):
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


def _run_parts(scheme, states, carries, stims, pads, vrows,
               cfg: DistConfig, probes, t_steps: int, topos: list,
               partitionable: bool, t0: int = 0, gather=all_gather):
    """The steps of the partitions this process runs, from the absolute
    step ``t0``: per step, each one's exchange half, the collective
    ``gather`` of their contributions, each one's finish.  Emulated,
    these are all the partitions and ``gather`` is the emulated
    :func:`all_gather`; on the multi-process path they are the rank's
    own partition and ``gather`` the process group's.  Returns the final
    carries and each partition's records, ``[B, T, ...]`` per name.  The
    given list and its carries are not modified (each ring is copied
    once, then written in place)."""
    P_ = len(carries)
    carries = [c._replace(ring=c.ring.clone()) for c in carries]
    common = dict(scheme=scheme, cap=cfg.capacity, partitionable=partitionable)
    records: list[dict[str, list]] = [{} for _ in range(P_)]
    for t in range(t0, t0 + t_steps):
        exs = [step_exchange(carries[p], t, state=states[p], stim=stims[p],
                             topo=topos[p], **common) for p in range(P_)]
        gathered = gather([ex.sent for ex in exs])
        for p in range(P_):
            carries[p], rec = step_finish(
                carries[p], exs[p], gathered, t, state=states[p],
                stim=stims[p], sim=cfg.sim, topo=topos[p], probes=probes,
                pad_mask=pads[p], voltage_rows=vrows[p], **common)
            for k, v in rec.items():
                records[p].setdefault(k, []).append(v)
    return carries, [{k: torch.stack(v, dim=1) for k, v in r.items()}
                     for r in records]


_SHARD_MAP_CALLS: dict[str, obs.InstrumentedCall] = {}


def _run_rank_call(scheme_name: str) -> obs.InstrumentedCall:
    """:func:`_run_parts` on a rank, under the compile-cache name the
    reference's ``shard_map`` program has,
    ``distributed.shard_map.<scheme>``."""
    if scheme_name not in _SHARD_MAP_CALLS:
        _SHARD_MAP_CALLS[scheme_name] = obs.InstrumentedCall(
            _run_parts, f"distributed.shard_map.{scheme_name}",
            static_argnums=(6, 7, 8))
    return _SHARD_MAP_CALLS[scheme_name]


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
    _run_parts, "distributed.run_emulated", static_argnums=(6, 7, 8))


def run_partitioned(d: DCSR, cfg: DistConfig, t_steps: int, keys,
                    sugar_neurons, stimulus, probes, device,
                    partitionable: bool, trials: bool = True,
                    chunk_steps: Optional[int] = None,
                    checkpoint_dir: Optional[str] = None,
                    resume: bool = False, async_checkpoint: bool = False,
                    mesh: Optional[CoreMesh] = None):
    """Build the scheme's state, shard the stimulus and run the partitions
    from ``keys`` [P, B, 2], emulated on ``device``, or with a ``mesh``
    this rank's partition on its device (:func:`_run_on_mesh`); returns
    the final carries, each partition's ``[B, T, ...]`` records and the
    probe owners (on every rank: the mesh path gathers them).  Shared by
    :func:`simulate_distributed` and
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
    if mesh is not None:
        return _run_on_mesh(d, cfg, scheme, t_steps, keys, sugar_neurons,
                            stimulus, probes, partitionable, chunk_steps,
                            checkpoint_dir, resume, async_checkpoint, mesh)
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
    topos = [Topology(P_, U, axis=AXIS, index=p) for p in range(P_)]

    def run(cs, k, t0):
        return _run_emulated_call(scheme, states, cs, stims, pad, vrows,
                                  cfg, probes, k, topos, partitionable, t0)

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


def _run_on_mesh(d: DCSR, cfg: DistConfig, scheme, t_steps: int, keys,
                 sugar_neurons, stimulus, probes, partitionable: bool,
                 chunk_steps, checkpoint_dir, resume: bool,
                 async_checkpoint: bool, mesh: CoreMesh):
    """:func:`run_partitioned` on one rank: its own partition's state,
    stimulus shard, pad mask, voltage rows and carry on its device, the
    chunk loop over :func:`_run_parts` (the health checks over every
    rank's counters, checkpoints in the emulated layout), then every
    partition's carry and records gathered to every rank."""
    _check_same_partition(d, mesh)
    p, device, U = mesh.rank, mesh.device, d.part_size
    with obs.span("build", what="scheme_state", scheme=cfg.scheme):
        state = map_tensors(lambda a: a[0], scheme.build(
            d, cfg.sim, cfg.capacity, device, parts=[p]))
    stim = _resolve_dist_stimulus(d, cfg.sim, sugar_neurons,
                                  stimulus).to(device)
    probes, rows, owner = _resolve_dist_probes(d, cfg.sim, probes)
    pad = torch.from_numpy(d.inv_perm[p * U:(p + 1) * U] >= 0).to(device)
    vrows = torch.from_numpy(rows[p]).to(device) if probes.voltage else None
    carry = _init_dist_carry(d, cfg, stim, scheme, keys, device, parts=[p])
    stim = map_tensors(lambda a: a[p], stim)
    topo = Topology(d.n_parts, U, axis=AXIS, index=p)
    call = _run_rank_call(cfg.scheme)
    gather = functools.partial(all_gather_group, mesh=mesh)

    def run_chunk(cs, s, k):
        cs, recs = call(scheme, [state], cs, [stim], [pad], [vrows], cfg,
                        probes, k, [topo], partitionable, s, gather)
        return cs, {name: v[None] for name, v in recs[0].items()}

    ckpt = (RankCheckpointer(checkpoint_dir, mesh,
                             async_save=async_checkpoint)
            if checkpoint_dir is not None else None)
    carries, stacked = run_chunked(
        run_chunk, carry, t_steps, chunk_steps, time_axis=2,
        health=cfg.sim.health, n=d.n_orig, dt_ms=cfg.sim.params.dt,
        checkpointer=ckpt, resume=resume,
        host_hook=getattr(scheme, "host_supervise", None), mesh=mesh)
    records = gather_tree(mesh, {k: v[0] for k, v in stacked.items()})
    return gather_tree(mesh, carries[0]), records, owner


def _mesh_for(d: DCSR, emulate: bool, mesh: Optional[CoreMesh], device
              ) -> Optional[CoreMesh]:
    """The mesh of a multi-process run (None for an emulated one)."""
    if mesh is not None and not isinstance(mesh, CoreMesh):
        raise TypeError(f"mesh must be a CoreMesh (make_core_mesh), not "
                        f"{type(mesh).__name__}")
    if mesh is None and not emulate:
        mesh = make_core_mesh(
            d.n_parts, None if device is None else [device] * d.n_parts)
    if (mesh is not None and device is not None
            and torch.device(device) != mesh.device):
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    return mesh


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
    """Run the partitioned network: its partitions emulated on one
    device, or one partition a process (``emulate=False``, below).

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

    ``emulate=False``, or a ``mesh`` (:func:`make_core_mesh`), runs the
    multi-process path: this process runs partition ``mesh.rank`` on
    ``mesh.device`` and every rank returns the whole result, bitwise the
    emulated one.  Without a ``mesh`` one is made for ``d.n_parts``
    ranks with the ``nccl`` backend (``device``, if given, for every
    rank).  A rank's telemetry counts its own partition, apart from the
    ``run_end`` counters, which are the gathered run's.
    """
    refuse_per_synapse_delays(cfg.sim.engine, "simulate_distributed")
    mesh = _mesh_for(d, emulate, mesh, device)
    tele = obs.active()
    with obs.span("simulate_distributed", scheme=cfg.scheme):
        device = mesh.device if mesh is not None else resolve_device(device)
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
            async_checkpoint=async_checkpoint, mesh=mesh)
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


__all__ = ["AXIS", "BACKENDS", "CoreMesh", "DistConfig", "DistResult",
           "RankCheckpointer", "gather_tree", "host_buffer", "make_core_mesh",
           "rank_device", "run_partitioned", "send_buffer",
           "simulate_distributed", "staged_all_gather"]
