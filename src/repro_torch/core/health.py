"""Supervision: health sentinels in the step, chunked runs,
checkpoint/resume at chunk boundaries, and the crash/escalation
supervisor.

Counterpart of ``repro/core/health.py``:

* **Sentinels** (:func:`health_stats_init` / :func:`health_step_stats`)
  are per-lane counters accumulated in the step next to the exchange
  scheme's: non-finite ``v`` / ``g`` entries on the float path, entries
  within ``sat_margin_bits`` of the int32 limit on the Q19.12 path.  They
  exist only when ``cfg.health`` is set, and change no result.
* **Chunked supervision** (:func:`run_chunked`): a T-step run becomes
  ceil(T/K) runs of K steps with the carry handed from one to the next on
  the device.  Each chunk runs from its absolute step index, so the
  clocked stimuli see the steps they would see in one run, and the result
  is bitwise the unchunked run's.  At each boundary the host checks the
  :class:`HealthConfig` thresholds against the chunk's counter deltas;
  before each chunk it runs an optional ``host_hook`` (the ``faulty``
  exchange scheme's injected failures and stragglers).
* **Checkpoint/resume** (:class:`SimCheckpointer`): at chunk boundaries
  the carry and the records so far are written through
  :mod:`repro_torch.train.checkpoint` (copied to the host first, then
  written atomically, optionally on a background thread), so a killed
  run resumed from the newest checkpoint reproduces the uninterrupted
  run bit for bit.
* **Supervision policy** (:func:`run_resilient`, paced by
  :class:`BackoffPolicy`): poison (NaN / saturation / rate envelope)
  re-raises; a crash restarts from the newest checkpoint; a drop-rate
  breach escalates the capacity and resumes from the last healthy
  checkpoint.

A carry here is a :class:`~repro_torch.core.step.SimCarry` (one run, or a
trial batch on its lane axis), or the list of one such carry per
partition that the partitioned runner threads; every counter reduction
sums over all of them.  On the multi-process path a rank's list holds its
own partition only: the health checks then sum the counters over the
ranks (``mesh``), and the rank's telemetry counts its own partition.
With a telemetry session active
(:mod:`repro_torch.obs`) each chunk boundary synchronizes the device and
emits one ``chunk`` event, plus ``checkpoint`` and ``health`` events as
they happen, and the supervisor emits ``restart`` and ``escalation``
events; without one, nothing waits for the device.
"""

from __future__ import annotations

import dataclasses
import random
import re
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs.phases import PhaseMarks

from .capacity import CapacityConfig, escalate_capacity


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds checked at each chunk boundary (host-side, against the
    per-chunk deltas of the in-step counters).

    ``max_nonfinite`` / ``max_saturated`` bound the *poison* counters
    (float non-finite v/g entries; Q19.12 |x| within ``sat_margin_bits``
    of the int32 limit).  ``max_drop_rate`` bounds dropped synapse events
    per step.  ``rate_lo_hz`` / ``rate_hi_hz`` bound the per-chunk mean
    population rate.
    """

    max_nonfinite: int = 0
    max_saturated: int = 0
    sat_margin_bits: int = 2       # |x| >= 2**(31 - margin) counts saturated
    max_drop_rate: Optional[float] = None   # dropped synapse events / step
    rate_lo_hz: Optional[float] = None      # per-chunk mean pop rate bounds
    rate_hi_hz: Optional[float] = None


class SimulationHealthError(RuntimeError):
    """A health threshold was breached at a chunk boundary.

    ``kind`` is the counter (``nonfinite`` / ``saturated`` /
    ``drop_rate`` / ``rate_envelope``), ``step`` the simulation step of
    the chunk boundary that detected it, ``value`` the offending
    per-chunk measurement.
    """

    def __init__(self, kind: str, step: int, value, threshold):
        self.kind, self.step, self.value, self.threshold = \
            kind, step, value, threshold
        super().__init__(
            f"health breach at step {step}: {kind}={value} "
            f"(threshold {threshold})")


#: kinds that capacity escalation can fix (everything else is poison)
RECOVERABLE_KINDS = ("drop_rate",)


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff for supervision retry loops: retry
    ``attempt`` (1-based) waits ``base_s * factor**(attempt-1)`` seconds,
    capped at ``cap_s``, times ``1 + jitter * (2u - 1)`` for a uniform
    draw u.  Consumed by :func:`run_resilient` and the serving layer
    (:mod:`repro_torch.serving.sim`); the chosen delay rides on the
    telemetry event (``backoff_s``)."""

    base_s: float = 0.1
    factor: float = 2.0
    cap_s: float = 30.0
    jitter: float = 0.25     # fraction of the delay, uniform in [-j, +j]

    def delay(self, attempt: int, rng=None) -> float:
        """Seconds before retry ``attempt``.  ``rng`` is anything with
        ``.random()`` (default: the ``random`` module); a seeded
        ``random.Random`` gives the reference's delays for its seed."""
        d = min(self.base_s * self.factor ** max(0, attempt - 1), self.cap_s)
        if self.jitter:
            u = (rng if rng is not None else random).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)


# --------------------------------------------------------------------------
# In-step sentinels
# --------------------------------------------------------------------------

def health_stats_init(sim, lanes: int, device) -> dict:
    """Zero sentinel counters, one per lane (``[lanes]`` int32), merged
    into the carry's ``stats`` next to the exchange scheme's.  Empty when
    ``sim.health`` is None."""
    if getattr(sim, "health", None) is None:
        return {}
    name = "h_saturated" if sim.fixed_point else "h_nonfinite"
    return {name: torch.zeros(lanes, dtype=torch.int32, device=device)}


def health_step_stats(lif, sim) -> dict:
    """This step's sentinel increments, ``[...]`` per lane for an
    ``[..., n]`` state.  Float path: non-finite entries of v and g.
    Q19.12 path: entries within ``sat_margin_bits`` of the int32 limit,
    an int32 compare on both sides (int32 wraps rather than clips)."""
    hc = getattr(sim, "health", None)
    if hc is None:
        return {}
    if sim.fixed_point:
        thr = 1 << (31 - hc.sat_margin_bits)
        sat = (((lif.v >= thr) | (lif.v <= -thr)).sum(dim=-1)
               + ((lif.g >= thr) | (lif.g <= -thr)).sum(dim=-1))
        return {"h_saturated": sat.to(torch.int32)}
    nf = ((~torch.isfinite(lif.v)).sum(dim=-1)
          + (~torch.isfinite(lif.g)).sum(dim=-1))
    return {"h_nonfinite": nf.to(torch.int32)}


# --------------------------------------------------------------------------
# Chunk-boundary supervision
# --------------------------------------------------------------------------

class HealthSnapshot(NamedTuple):
    """Host-side reduction of the carry's cumulative counters at a chunk
    boundary; every field is a plain sum over all leading axes (and over
    the partitions)."""

    step: int
    spikes: int
    dropped: int
    nonfinite: int
    saturated: int


def _carries(carry) -> list:
    return list(carry) if isinstance(carry, list) else [carry]


def _counter_tensors(carry, lanes: bool) -> dict:
    """name -> the counter summed over everything but (with ``lanes``)
    the leading lane axis, and over the partitions; on the device."""
    out: dict = {}
    for c in _carries(carry):
        leaves = {"spikes": c.counts, "dropped": c.dropped, **c.stats}
        for k, v in leaves.items():
            v = v.long()
            s = (v.reshape(v.shape[0], -1).sum(dim=1) if lanes
                 else v.sum())
            out[k] = s if k not in out else out[k] + s
    return out


def carry_counters(carry, mesh=None) -> dict:
    """Every cumulative counter of the carry (spikes, drops, scheme
    stats, health sentinels) reduced to a flat name -> int dict: the
    per-chunk telemetry record's payload.  The per-neuron sums run on the
    device; the whole dict comes to the host in one transfer.  With a
    ``mesh`` (:class:`repro_torch.core.distributed.CoreMesh`) the sums
    are over every rank's partition: a collective, so every rank calls
    it."""
    sums = _counter_tensors(carry, lanes=False)
    vals = torch.stack(list(sums.values()))
    if mesh is not None:
        vals = mesh.all_reduce_sum(vals)
    return dict(zip(sums, (int(v) for v in vals.cpu().tolist())))


def lane_snapshots(step: int, carry) -> list[HealthSnapshot]:
    """Per-lane :class:`HealthSnapshot` of a trial batch's carry (leaves
    ``[B, ...]``): lane b's counters reduce over everything except the
    lane axis, so a poisoned lane of a batch is attributable.  One
    transfer for the whole batch."""
    sums = _counter_tensors(carry, lanes=True)
    host = dict(zip(sums, torch.stack(list(sums.values())).cpu().tolist()))
    zero = [0] * len(host["spikes"])
    return [HealthSnapshot(
        step=int(step), spikes=int(host["spikes"][b]),
        dropped=int(host["dropped"][b]),
        nonfinite=int(host.get("h_nonfinite", zero)[b]),
        saturated=int(host.get("h_saturated", zero)[b]),
    ) for b in range(len(host["spikes"]))]


def snapshot(step: int, carry, mesh=None) -> HealthSnapshot:
    c = carry_counters(carry, mesh)
    return HealthSnapshot(step=int(step), spikes=c["spikes"],
                          dropped=c["dropped"],
                          nonfinite=c.get("h_nonfinite", 0),
                          saturated=c.get("h_saturated", 0))


def check_chunk(prev: HealthSnapshot, now: HealthSnapshot, hc: HealthConfig,
                *, n: int, dt_ms: float) -> None:
    """Check one chunk's counter deltas against ``hc``; raises
    :class:`SimulationHealthError` naming the step and counter."""
    steps = now.step - prev.step
    if steps <= 0:
        return
    d_nf = now.nonfinite - prev.nonfinite
    if d_nf > hc.max_nonfinite:
        raise SimulationHealthError("nonfinite", now.step, d_nf,
                                    hc.max_nonfinite)
    d_sat = now.saturated - prev.saturated
    if d_sat > hc.max_saturated:
        raise SimulationHealthError("saturated", now.step, d_sat,
                                    hc.max_saturated)
    if hc.max_drop_rate is not None:
        rate = (now.dropped - prev.dropped) / steps
        if rate > hc.max_drop_rate:
            raise SimulationHealthError("drop_rate", now.step, rate,
                                        hc.max_drop_rate)
    if hc.rate_lo_hz is not None or hc.rate_hi_hz is not None:
        hz = (now.spikes - prev.spikes) / (n * steps * dt_ms * 1e-3)
        lo = hc.rate_lo_hz if hc.rate_lo_hz is not None else -np.inf
        hi = hc.rate_hi_hz if hc.rate_hi_hz is not None else np.inf
        if not lo <= hz <= hi:
            raise SimulationHealthError("rate_envelope", now.step,
                                        round(hz, 4), (lo, hi))


# --------------------------------------------------------------------------
# Checkpointing at chunk boundaries
# --------------------------------------------------------------------------

_RECORD_KEY = re.compile(r"^\['records'\]/\['(\w+)'\]$")


class SimCheckpointer:
    """Carry + records-so-far checkpoints through
    :mod:`repro_torch.train.checkpoint`, one at every chunk boundary.
    ``async_save`` overlaps the file write with the next chunk (the carry
    is copied to the host before the chunk starts); the handle is joined
    before the next save and at run end, so the newest checkpoint is
    never lost to a fast exit."""

    def __init__(self, directory: str, async_save: bool = False):
        self.directory = str(directory)
        self.async_save = async_save
        self._handle = None

    def save(self, step: int, carry, records: dict) -> None:
        from repro_torch.train.checkpoint import save_checkpoint
        self.join()
        self._handle = save_checkpoint(
            self.directory, int(step), {"carry": carry,
                                        "records": dict(records)},
            metadata={"sim_step": int(step)}, async_save=self.async_save)

    def join(self) -> None:
        if self._handle is not None:
            self._handle.join()
            self._handle = None

    def latest(self) -> Optional[int]:
        from repro_torch.train.checkpoint import latest_step
        return latest_step(self.directory)

    def restore_latest(self, carry_template):
        """-> (carry, records, step) from the newest checkpoint, or None.
        ``carry_template`` supplies the structure, shapes, dtypes and
        devices (the restore is shape- and dtype-checked: a Q19.12 int32
        carry never casts silently into a float32 target).  The file is
        read once; the records so far, whose time axis has no template,
        are picked out of the same flat dict."""
        from repro_torch.train.checkpoint import (read_checkpoint_arrays,
                                                  unflatten)
        step = self.latest()
        if step is None:
            return None
        raw, meta = read_checkpoint_arrays(self.directory, step)
        carry = unflatten({"carry": carry_template}, raw)["carry"]
        device = _carries(carry_template)[0].counts.device
        records = {m.group(1): v.to(device) for k, v in raw.items()
                   if (m := _RECORD_KEY.match(k))}
        return carry, records, int(meta.get("sim_step", step))


# --------------------------------------------------------------------------
# The chunk loop (shared by simulate(), simulate_distributed() and
# run_trials())
# --------------------------------------------------------------------------

def concat_records(chunks: list[dict], axis: int) -> dict:
    """Concatenate per-chunk record dicts along the time axis."""
    chunks = [c for c in chunks if c]
    if not chunks:
        return {}
    if len(chunks) == 1:
        return chunks[0]
    return {k: torch.cat([c[k] for c in chunks], dim=axis)
            for k in chunks[0]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drain_marked(device: torch.device, marks, metrics) -> dict:
    """Drain the device after a marked chunk, resolving the marks while it
    finishes, and time the host's wait: the ``chunk`` event's ``phases``
    and ``drain_s``; each phase is also observed as ``step.<name>``."""
    t0 = time.monotonic()
    seconds = marks.seconds()
    _sync(device)
    drain_s = time.monotonic() - t0
    for name, sec in seconds.items():
        metrics.observe(f"step.{name}", sec)
    return {"phases": {name: round(sec, 9) for name, sec in seconds.items()},
            "drain_s": round(drain_s, 6)}


def run_chunked(run_chunk: Callable[[Any, int, int], tuple],
                carry, t_steps: int, chunk_steps: Optional[int], *,
                time_axis: int = 0, health: Optional[HealthConfig] = None,
                n: int = 1, dt_ms: float = 0.1,
                checkpointer: Optional[SimCheckpointer] = None,
                resume: bool = False, host_hook=None, mesh=None):
    """Drive ``ceil(T/K)`` chunks with host supervision between them:
    ``run_chunk(carry, start_step, k) -> (carry, records)`` runs K steps
    from the absolute step ``start_step`` and leaves the given carry as
    it was.  With ``chunk_steps`` None the run is one chunk of
    ``t_steps``: every run of the port goes through this loop, supervised
    or not.

    Health thresholds are checked (and raise) *before* the chunk is
    checkpointed, so the newest checkpoint on disk is always the last
    healthy boundary.  ``host_hook(start, stop)`` runs before each chunk
    (the ``faulty`` scheme's injected failures and stragglers).
    With a telemetry session active each boundary synchronizes the
    device and emits a ``chunk`` event (wall time, steps/s, cumulative
    and per-chunk counters), plus ``checkpoint`` and ``health`` events;
    the steps themselves are untouched, so results are bitwise the same
    with telemetry on or off.  With the session's ``phases`` switch on
    (read at each chunk's start) a chunk on a CUDA device is marked
    (:mod:`repro_torch.obs.phases`): its ``chunk`` event gains
    ``phases`` (each step phase's device-stream seconds summed over the
    chunk, also observed as ``step.<name>``) and ``drain_s`` (the host's
    wait in the boundary's drain, the marks resolved meanwhile), both
    inside the chunk span.  ``mesh`` (a rank of the multi-process path)
    makes the health checks read the counters summed over the ranks."""
    chunk_steps = int(chunk_steps) if chunk_steps else max(t_steps, 1)
    if chunk_steps <= 0:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    tele = obs.active()
    start = 0
    chunks: list[dict] = []
    if checkpointer is not None and resume:
        restored = checkpointer.restore_latest(carry)
        if restored is not None:
            carry, saved_records, start = restored
            if saved_records:
                chunks.append(saved_records)
    prev = snapshot(start, carry, mesh) if health is not None else None
    prev_counters = carry_counters(carry) if tele is not None else None
    device = _carries(carry)[0].counts.device
    recorder = None     # one PhaseMarks a run, made at the first marked chunk
    s = start
    while s < t_steps:
        k = min(chunk_steps, t_steps - s)
        if host_hook is not None:
            host_hook(s, s + k)
        marks = None
        if tele is not None and tele.phases:
            marks = recorder = recorder or PhaseMarks.for_device(device)
        marked: dict = {}
        with obs.span("chunk", step=s) as sp:
            if marks is None:
                carry, rec = run_chunk(carry, s, k)
                if tele is not None:
                    # an honest per-chunk wall time needs the device drained
                    _sync(device)
            else:
                with marks:
                    carry, rec = run_chunk(carry, s, k)
                marked = _drain_marked(device, marks, tele.metrics)
        chunks.append(rec)
        if tele is not None:
            counters = carry_counters(carry)
            delta = {key: counters[key] - prev_counters.get(key, 0)
                     for key in counters}
            wall = max(sp.wall_s, 1e-9)
            tele.emit("chunk", step=s + k, steps=k,
                      wall_s=round(wall, 6),
                      steps_per_s=round(k / wall, 3),
                      counters=counters, delta=delta, **marked)
            prev_counters = counters
        if health is not None:
            now = snapshot(s + k, carry, mesh)
            try:
                check_chunk(prev, now, health, n=n, dt_ms=dt_ms)
            except SimulationHealthError as e:
                if tele is not None:
                    value = (float(e.value) if np.isscalar(e.value)
                             else e.value)
                    tele.emit("health", kind=e.kind, step=e.step,
                              value=value, threshold=e.threshold)
                raise
            prev = now
        if checkpointer is not None:
            checkpointer.save(s + k, carry,
                              concat_records(chunks, time_axis))
            if tele is not None:
                tele.emit("checkpoint", step=s + k,
                          async_save=checkpointer.async_save)
        s += k
    if checkpointer is not None:
        checkpointer.join()
    return carry, concat_records(chunks, time_axis)


# --------------------------------------------------------------------------
# Supervisor
# --------------------------------------------------------------------------

def run_resilient(run_fn: Callable[[Optional[int], Optional[CapacityConfig]],
                                   Any],
                  checkpoint_dir: Optional[str] = None,
                  max_restarts: int = 3,
                  capacity: Optional[CapacityConfig] = None,
                  escalate=None, max_escalations: int = 4,
                  backoff: Optional[BackoffPolicy] = BackoffPolicy(),
                  sleep: Callable[[float], None] = time.sleep,
                  rng=None):
    """Supervise ``run_fn(resume_step, capacity)`` to completion; the
    resume signal is ``latest_step(checkpoint_dir)`` (None when there is
    no checkpoint yet).  Policy:

    * **crash** (a ``RuntimeError`` that is not a health breach, e.g. the
      ``faulty`` scheme's injected partition failure): restart from the
      newest checkpoint, up to ``max_restarts`` times;
    * **drop-rate breach** (:class:`SimulationHealthError` of kind
      ``drop_rate``): ``escalate(error, capacity)`` (default:
      :func:`repro_torch.core.capacity.escalate_capacity` of
      ``capacity``) and resume from the last healthy checkpoint, up to
      ``max_escalations`` times; a None capacity re-raises;
    * **poison** (``nonfinite`` / ``saturated`` / ``rate_envelope``):
      re-raise at once.

    Every retry first waits ``backoff.delay(attempt, rng)`` through
    ``sleep`` (``backoff=None``: no wait).  With a telemetry session
    active each escalation and restart emits an ``escalation`` /
    ``restart`` event carrying ``backoff_s``."""
    from repro_torch.train.checkpoint import latest_step
    if escalate is None:
        def escalate(e, cap):
            return escalate_capacity(cap)
    tele = obs.active()
    restarts = escalations = 0
    resume: Optional[int] = None

    def _latest():
        return latest_step(checkpoint_dir) if checkpoint_dir else None

    def _wait(attempt: int) -> float:
        if backoff is None:
            return 0.0
        d = backoff.delay(attempt, rng)
        if d > 0:
            sleep(d)
        return round(d, 6)

    with obs.span("run_resilient"):
        while True:
            try:
                return run_fn(resume, capacity)
            except SimulationHealthError as e:
                if e.kind not in RECOVERABLE_KINDS:
                    raise
                escalations += 1
                if escalations > max_escalations:
                    raise
                capacity = escalate(e, capacity)
                if capacity is None:
                    raise
                resume = _latest()
                waited = _wait(escalations)
                if tele is not None:
                    tele.emit("escalation", attempt=escalations,
                              resume_step=resume, kind=e.kind,
                              backoff_s=waited)
            except RuntimeError as e:
                restarts += 1
                if restarts > max_restarts:
                    raise
                resume = _latest()
                waited = _wait(restarts)
                if tele is not None:
                    tele.emit("restart", attempt=restarts,
                              resume_step=resume, error=type(e).__name__,
                              backoff_s=waited)


__all__ = ["BackoffPolicy", "HealthConfig", "HealthSnapshot",
           "RECOVERABLE_KINDS", "SimCheckpointer", "SimulationHealthError",
           "carry_counters", "check_chunk", "concat_records",
           "health_stats_init", "health_step_stats", "lane_snapshots",
           "run_chunked", "run_resilient", "snapshot"]
