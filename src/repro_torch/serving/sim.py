"""Simulation serving: a fault-tolerant batched front end for the
connectome simulator.

Counterpart of ``repro/serving/sim.py``.  The paper's platform serves one
connectome to many callers, and the natural workload is many independent
experiments (stimulus -> propagation -> readout).  A request is
``(scenario, stimulus params, probes, duration, seed, deadline,
priority)``; the server:

* **admits** against a bounded queue (overflow is shed at once with a
  reason);
* **batches by compile signature**: requests that share ``(scenario,
  params, t_steps, probes)`` differ only in their seed, which is the lane
  axis of the step (:mod:`repro_torch.exp.trials`), so a batch is one
  chunked run of B lanes, each delivery kernel launching once a step for
  all of them, and a packed request's result is bitwise a solo
  :func:`repro_torch.core.simulate` run's;
* **supervises at chunk boundaries**: per-request wall-clock deadlines
  and per-lane health sentinels
  (:func:`repro_torch.core.health.lane_snapshots`, one read of the lane
  counters a boundary), so a poisoned request is attributed to its lane;
* **retries transient faults** with jittered exponential backoff
  (:class:`repro_torch.core.health.BackoffPolicy`); a request that keeps
  crashing is isolated (run solo) before it is rejected;
* **escalates capacity per batch tier** on a drop-rate breach (that
  signature's budgets only);
* **quarantines poison**: a request that fails health checks
  ``max_health_failures`` times is rejected for good with its
  :class:`~repro_torch.core.health.SimulationHealthError` attached;
* **degrades** under pressure: past the soft queue watermark, new
  admissions drop per-neuron probes for scalar ones and run in shorter
  chunks before the hard limit starts shedding.

Every decision streams through the ambient :mod:`repro_torch.obs`
session (the ``serve_*`` event kinds of ``schema.json``), in the
reference's order, and an always-on
:class:`~repro_torch.obs.MetricsRegistry` keeps the counters and latency
percentiles of :meth:`SimServer.stats`.

The server runs on the CUDA device unless it is given one; with none
named and no CUDA device present it raises, as
:func:`repro_torch.core.simulate` does.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.capacity import escalate_capacity
from repro_torch.core.engines import refuse_per_synapse_delays
from repro_torch.core.engine import (SimConfig, SimResult, build_synapses,
                                     resolve_device)
from repro_torch.core.health import (RECOVERABLE_KINDS, BackoffPolicy,
                                     HealthConfig, SimulationHealthError,
                                     check_chunk, concat_records,
                                     lane_snapshots)
from repro_torch.core.neuron import LIFState
from repro_torch.exp import ProbeSpec, build_scenario
from repro_torch.exp.trials import _run_trial_steps, trial_carry


# --------------------------------------------------------------------------
# Request model
# --------------------------------------------------------------------------

#: terminal statuses: every submitted request ends in exactly one of these
COMPLETED = "completed"
REJECTED = "rejected"
QUARANTINED = "quarantined"
TERMINAL = (COMPLETED, REJECTED, QUARANTINED)

QUEUED = "queued"
PENDING = "pending"


@dataclasses.dataclass(eq=False)   # identity equality: results hold tensors
class SimRequest:
    """One simulation request: a named scenario with overrides, a seed, a
    probe selection, and a service contract (deadline, priority).

    Two requests with equal ``(scenario, params, t_steps, probes)`` share
    one signature and differ only in ``seed``, the lane axis; ``params``
    values must be hashable.  ``fault_hook(start, stop)`` runs on the host
    before each chunk of any batch holding this request (the ``faulty``
    exchange scheme's :meth:`host_supervise` plugs in here)."""

    scenario: str
    t_steps: int
    seed: int = 0
    params: dict = dataclasses.field(default_factory=dict)
    probes: ProbeSpec = ProbeSpec()
    deadline_s: Optional[float] = None     # wall-clock budget from submit
    priority: int = 0                      # higher is served first
    rid: Optional[int] = None              # assigned at submit when None
    fault_hook: Optional[Callable[[int, int], None]] = None

    # -- server-managed ----------------------------------------------------
    status: str = PENDING
    reason: Optional[str] = None           # terminal reason for non-complete
    error: Optional[BaseException] = None  # attached on quarantine/crash
    result: Optional[SimResult] = None
    degraded: bool = False
    solo: bool = False            # failed once: never re-batched with healthy
    attempts: int = 0             # crash retries consumed
    health_failures: int = 0
    submitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    not_before: float = 0.0       # backoff gate (server clock)
    _order: int = 0               # FIFO tiebreak within a priority class

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None or self.submitted_at is None:
            return None
        return self.finished_at - self.submitted_at


@dataclasses.dataclass(frozen=True)
class SimServeConfig:
    """Serving policy.  ``degrade_queue_depth=None`` disables the
    degradation ladder; ``health=None`` disables the sentinels (then only
    deadlines and crash retries protect the server)."""

    max_queue: int = 64            # hard admission limit (then shed)
    max_batch: int = 8             # lanes per tick
    chunk_steps: int = 50          # supervision granularity
    degraded_chunk_steps: int = 20
    degrade_queue_depth: Optional[int] = None   # soft watermark
    default_deadline_s: Optional[float] = None  # applied when request has none
    max_retries: int = 2           # crash re-runs per request
    max_health_failures: int = 2   # then quarantine
    max_escalations: int = 2       # capacity bumps per signature tier
    health: Optional[HealthConfig] = HealthConfig()
    backoff: BackoffPolicy = BackoffPolicy(base_s=0.05, cap_s=5.0)


class _CapacityBreach(Exception):
    """A recoverable drop-rate breach inside a batch: handled at the batch
    tier (escalate and requeue), never surfaced to callers."""

    def __init__(self, err: SimulationHealthError, rid):
        super().__init__(str(err))
        self.err = err
        self.rid = rid


class _HookCrash(Exception):
    """A crash raised by one request's ``fault_hook``: attributable, so
    only the culprit pays the retry and isolation cost and its
    batch-mates requeue free."""

    def __init__(self, err: BaseException, rid):
        super().__init__(str(err))
        self.err = err
        self.rid = rid


def _degrade_probes(p: ProbeSpec) -> ProbeSpec:
    """Coarsen a probe spec under load: per-neuron streams (raster,
    voltage traces) collapse into the scalar population rate; scalar
    streams survive."""
    return ProbeSpec(raster=False, voltage=(),
                     pop_rate=p.pop_rate or p.raster or bool(p.voltage),
                     drops=p.drops)


def _lane_result(carry, records: dict, b: int) -> SimResult:
    """Lane ``b`` of a batch's carry and ``[B, T, ...]`` records: the
    SimResult a solo ``simulate()`` of that request gives."""
    recs = {k: v[b] for k, v in records.items()}
    return SimResult(counts=carry.counts[b],
                     state=LIFState(*(x[b] for x in carry.lif)),
                     dropped=carry.dropped[b],
                     raster=recs.get("raster"),
                     records=recs,
                     stats={k: v[b] for k, v in carry.stats.items()})


class SimServer:
    """Admission, batching and supervision over one connectome.

    A synchronous tick loop: :meth:`submit` applies admission control,
    :meth:`tick` serves one batch, :meth:`run` drains a workload until
    every request is terminal.  ``clock`` / ``sleep`` / ``rng`` are
    injectable for deterministic tests.  ``device`` defaults to CUDA and
    raises without it; ``partitionable`` is the threefry mode of the
    seeds' streams (JAX's ``jax_threefry_partitionable``); ``syn`` is an
    optional state of :func:`repro_torch.core.build_synapses` for ``cfg``
    on ``device``, as ``simulate(syn=)`` takes one (else it is built on
    first use).
    """

    def __init__(self, c, cfg: SimConfig,
                 serve: SimServeConfig = SimServeConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 device=None, partitionable: bool = True,
                 syn: Any = None):
        refuse_per_synapse_delays(cfg.engine, "SimServer")
        self.c = c
        self.device = resolve_device(device)
        self.partitionable = partitionable
        # the in-step sentinels are the quarantine substrate: the server's
        # health config rides on the sim config (an explicit cfg.health
        # wins)
        if cfg.health is None and serve.health is not None:
            cfg = dataclasses.replace(cfg, health=serve.health)
        self.cfg = cfg
        self.serve = serve
        self.clock = clock
        self.sleep = sleep
        self.rng = rng if rng is not None else random.Random(0)
        self.metrics = obs.MetricsRegistry()
        self._queue: list[SimRequest] = []
        self._seq = 0
        self._next_rid = 0
        self._syn_cache: dict[SimConfig, Any] = (
            {} if syn is None else {cfg: syn})
        self._stim_cache: dict[tuple, Any] = {}
        self._capacity: dict[tuple, Any] = {}      # per-tier escalations
        self._escalations: dict[tuple, int] = {}
        self._latencies: list[float] = []

    # -- admission ---------------------------------------------------------

    def submit(self, req: SimRequest) -> SimRequest:
        """Admission control: assign an rid, shed on overflow, degrade
        under pressure, enqueue otherwise.  Returns the request; a shed
        request is already terminal (``rejected`` / ``queue_full``)."""
        if req.rid is None:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid) + 1
        req.submitted_at = self.clock()
        self.metrics.inc("serving.submitted")
        if len(self._queue) >= self.serve.max_queue:
            self.metrics.inc("serving.shed")
            self._emit("serve_shed", rid=req.rid, reason="queue_full")
            self._finish(req, REJECTED, reason="queue_full")
            return req
        soft = self.serve.degrade_queue_depth
        if soft is not None and len(self._queue) >= soft:
            degraded = _degrade_probes(req.probes)
            if degraded != req.probes or not req.degraded:
                req.probes = degraded
                req.degraded = True
                self.metrics.inc("serving.degraded")
                self._emit("serve_degrade", rid=req.rid, what="probes+chunk",
                           queue_depth=len(self._queue))
        req.status = QUEUED
        self._seq += 1
        req._order = self._seq
        self._queue.append(req)
        self.metrics.inc("serving.admitted")
        self._emit("serve_admit", rid=req.rid, queue_depth=len(self._queue),
                   priority=req.priority, degraded=req.degraded)
        return req

    # -- scheduling --------------------------------------------------------

    def _signature(self, r: SimRequest) -> tuple:
        return (r.scenario, tuple(sorted(r.params.items())), r.t_steps,
                r.probes, r.degraded)

    def _deadline(self, r: SimRequest) -> Optional[float]:
        return (r.deadline_s if r.deadline_s is not None
                else self.serve.default_deadline_s)

    def _expired(self, r: SimRequest, now: float) -> bool:
        dl = self._deadline(r)
        return dl is not None and now - r.submitted_at > dl

    def tick(self) -> list[SimRequest]:
        """One scheduling round: shed expired queue entries, pick the
        highest-priority eligible request, pack every compatible
        (same-signature, non-isolated) request up to ``max_batch`` into
        one chunked run of lanes, and settle the outcomes.  Returns the
        requests that reached a terminal state this round."""
        now = self.clock()
        finished: list[SimRequest] = []
        still: list[SimRequest] = []
        for r in self._queue:
            if self._expired(r, now):
                self._expire(r, step=0)
                finished.append(r)
            else:
                still.append(r)
        self._queue = still
        ready = [r for r in self._queue if r.not_before <= now]
        if not ready:
            return finished
        ready.sort(key=lambda r: (-r.priority, r._order))
        head = ready[0]
        if head.solo:
            batch = [head]
        else:
            sig = self._signature(head)
            batch = [r for r in ready
                     if not r.solo and self._signature(r) == sig]
            batch = batch[: self.serve.max_batch]
        for r in batch:
            self._queue.remove(r)
        finished.extend(self._run_batch(batch))
        return finished

    def run(self, requests=None, max_ticks: int = 10_000
            ) -> list[SimRequest]:
        """Serve a workload until every request is terminal.  The
        ``max_ticks`` backstop rejects leftovers with
        ``reason="server_stopped"``, so every submission is accounted
        for."""
        requests = list(requests) if requests is not None else []
        for r in requests:
            if r.status == PENDING:
                self.submit(r)
        seen = list(requests)
        ticks = 0
        while self._queue and ticks < max_ticks:
            done = self.tick()
            for r in done:
                if r not in seen:
                    seen.append(r)
            if self._queue:
                wait = min(r.not_before for r in self._queue) - self.clock()
                if wait > 0:
                    # every queued request is backing off: sleep to the
                    # earliest retry gate instead of spinning
                    self.sleep(wait)
            ticks += 1
        for r in self._queue:
            self._finish(r, REJECTED, reason="server_stopped")
        self._queue = []
        return seen

    # -- batch execution ---------------------------------------------------

    def _cfg_for(self, sig: tuple) -> SimConfig:
        cap = self._capacity.get(sig)
        return (dataclasses.replace(self.cfg, capacity=cap)
                if cap is not None else self.cfg)

    def _syn(self, cfg: SimConfig):
        if cfg not in self._syn_cache:
            self._syn_cache[cfg] = build_synapses(self.c, cfg, self.device)
        return self._syn_cache[cfg]

    def _stimulus(self, r: SimRequest):
        key = (r.scenario, tuple(sorted(r.params.items())))
        if key not in self._stim_cache:
            self._stim_cache[key] = build_scenario(
                r.scenario, self.c, self.cfg, **r.params).to(self.device)
        return self._stim_cache[key]

    def _run_batch(self, batch: list[SimRequest]) -> list[SimRequest]:
        sig = self._signature(batch[0])
        cfg = self._cfg_for(sig)
        chunk = (self.serve.degraded_chunk_steps if batch[0].degraded
                 else self.serve.chunk_steps)
        t_steps = batch[0].t_steps
        self.metrics.inc("serving.batches")
        self._emit("serve_batch", size=len(batch), signature=_sig_str(sig),
                   chunk_steps=chunk, t_steps=t_steps,
                   rids=[r.rid for r in batch])
        try:
            stim = self._stimulus(batch[0])
            with obs.span("serve_batch", size=len(batch)):
                lanes = self._execute(batch, stim, cfg, batch[0].probes,
                                      t_steps, chunk)
        except _CapacityBreach as cb:
            return self._escalate(sig, batch, cb)
        except _HookCrash as hc:
            return self._crashed(batch, hc.err, culprit=hc.rid)
        except SimulationHealthError:
            raise   # a programming error: lane attribution catches these
        except Exception as e:  # noqa: BLE001 (the crash taxonomy)
            return self._crashed(batch, e)
        finished = []
        for r, outcome in zip(batch, lanes):
            kind = outcome[0]
            if kind == "done":
                self._finish(r, COMPLETED, result=outcome[1])
                finished.append(r)
            elif kind == "deadline":
                self._expire(r, step=outcome[1])
                finished.append(r)
            else:   # poison
                if self._poisoned(r, outcome[1]):
                    finished.append(r)
        return finished

    def _execute(self, batch, stim, cfg: SimConfig, probes, t_steps: int,
                 chunk_steps: int):
        """Drive one packed batch as a chunked run of B lanes (the lanes'
        carry on the device, handed from chunk to chunk).  Returns one
        outcome per lane: ``("done", SimResult)`` / ``("deadline",
        step)`` / ``("poison", SimulationHealthError)``.  Raises
        :class:`_CapacityBreach` on a recoverable drop-rate breach and
        lets crashes propagate to the retry path."""
        n = self.c.n
        syn = self._syn(cfg)
        carry, _ = trial_carry(n, cfg, stim, [r.seed for r in batch],
                               self.device)
        hc = cfg.health
        prev = lane_snapshots(0, carry) if hc is not None else None
        out: list[Optional[tuple]] = [None] * len(batch)
        chunks: list[dict] = []
        s = 0
        while s < t_steps:
            k = min(chunk_steps, t_steps - s)
            for r in batch:
                if r.fault_hook is not None:
                    try:
                        r.fault_hook(s, s + k)
                    except Exception as e:   # noqa: BLE001 (attributed)
                        raise _HookCrash(e, r.rid) from e
            carry, rec = _run_trial_steps(syn, carry, stim, cfg, probes, k,
                                          n, s,
                                          partitionable=self.partitionable)
            self.metrics.inc("serving.chunks")
            s += k
            chunks.append(rec)
            now = self.clock()
            # the boundary's one read of the device: the lane counters
            snaps = lane_snapshots(s, carry) if hc is not None else None
            for b, r in enumerate(batch):
                if out[b] is not None:
                    continue
                if self._expired(r, now):
                    # enforced at the chunk boundary: the lane stops
                    # mattering here even though the batch may go on
                    out[b] = ("deadline", s)
                    continue
                if hc is None:
                    continue
                try:
                    check_chunk(prev[b], snaps[b], hc, n=n,
                                dt_ms=cfg.params.dt)
                except SimulationHealthError as e:
                    if e.kind in RECOVERABLE_KINDS:
                        # an under-provisioned batch tier, not a sick lane
                        raise _CapacityBreach(e, r.rid) from None
                    out[b] = ("poison", e)
            if snaps is not None:
                prev = snaps
            if all(o is not None for o in out):
                break   # nobody left to serve: stop spending device time
        records = concat_records(chunks, axis=1)
        return [out[b] if out[b] is not None
                else ("done", _lane_result(carry, records, b))
                for b in range(len(batch))]

    # -- outcome handling --------------------------------------------------

    def _requeue(self, r: SimRequest, backoff_s: float) -> None:
        r.status = QUEUED
        r.not_before = self.clock() + backoff_s
        self._seq += 1
        r._order = self._seq
        self._queue.append(r)

    def _crashed(self, batch: list[SimRequest], e: BaseException,
                 culprit=None) -> list[SimRequest]:
        """Transient-crash policy: retry with jittered exponential
        backoff, and keep crashers away from healthy traffic.  An
        attributable crash (``culprit``: a request's own fault hook
        raised) charges only that request, which is isolated at once; its
        batch-mates requeue with no attempt charged and no backoff.  An
        unattributable crash charges every member, and a member that has
        crashed twice is isolated.  Retries exhausted: rejected, with the
        error attached."""
        finished = []
        delays = []
        retried = []
        for r in batch:
            blamed = culprit is None or r.rid == culprit
            if not blamed:
                self._requeue(r, 0.0)
                continue
            r.attempts += 1
            if r.attempts > self.serve.max_retries:
                r.error = e
                self._finish(r, REJECTED, reason="crash")
                finished.append(r)
                continue
            if culprit is not None or r.attempts >= 2:
                r.solo = True
            d = self.serve.backoff.delay(r.attempts, self.rng)
            delays.append(d)
            retried.append(r)
            self._requeue(r, d)
        self.metrics.inc("serving.retries", len(retried))
        if retried:
            self._emit("serve_retry", reason=f"crash:{type(e).__name__}",
                       backoff_s=round(max(delays), 6),
                       rids=[r.rid for r in retried],
                       attempt=max(r.attempts for r in retried),
                       solo=any(r.solo for r in retried))
        return finished

    def _escalate(self, sig: tuple, batch: list[SimRequest],
                  cb: _CapacityBreach) -> list[SimRequest]:
        """Drop-rate breach: escalate this signature tier's capacity and
        retry the whole batch (seeds unchanged, so the accepted re-run is
        still bitwise a solo run's); other tiers keep their budgets."""
        n_esc = self._escalations.get(sig, 0) + 1
        if n_esc > self.serve.max_escalations:
            for r in batch:
                r.error = cb.err
                self._finish(r, REJECTED, reason="capacity")
            return list(batch)
        self._escalations[sig] = n_esc
        base = self._capacity.get(sig) or self.cfg.capacity
        self._capacity[sig] = escalate_capacity(base)
        self.metrics.inc("serving.escalations")
        d = self.serve.backoff.delay(n_esc, self.rng)
        for r in batch:
            self._requeue(r, d)
        self._emit("serve_retry", reason="drop_rate",
                   backoff_s=round(d, 6), rids=[r.rid for r in batch],
                   attempt=n_esc, solo=False)
        return []

    def _poisoned(self, r: SimRequest, e: SimulationHealthError) -> bool:
        """Poison policy: the first failure isolates the request (solo);
        ``max_health_failures`` failures quarantine it with the health
        error attached.  Returns whether the request is terminal."""
        r.health_failures += 1
        if r.health_failures >= self.serve.max_health_failures:
            r.error = e
            self._emit("serve_quarantine", rid=r.rid, error=str(e),
                       step=e.step)
            self._finish(r, QUARANTINED, reason=e.kind)
            return True
        r.solo = True
        d = self.serve.backoff.delay(r.health_failures, self.rng)
        self.metrics.inc("serving.retries")
        self._requeue(r, d)
        self._emit("serve_retry", reason=f"health:{e.kind}",
                   backoff_s=round(d, 6), rids=[r.rid],
                   attempt=r.health_failures, solo=True)
        return False

    def _expire(self, r: SimRequest, step: int) -> None:
        self.metrics.inc("serving.deadline_expired")
        self._emit("serve_deadline", rid=r.rid, step=step,
                   deadline_s=self._deadline(r))
        self._finish(r, REJECTED, reason="deadline")

    def _finish(self, r: SimRequest, status: str, reason=None,
                result=None) -> None:
        r.status = status
        r.reason = reason
        r.result = result
        r.finished_at = self.clock()
        self.metrics.inc(f"serving.{status}")
        if status == COMPLETED and r.latency_s is not None:
            self._latencies.append(r.latency_s)
        self._emit("serve_request_end", rid=r.rid, status=status,
                   reason=reason, wall_s=round(r.latency_s or 0.0, 6))

    # -- observability -----------------------------------------------------

    def _emit(self, type_: str, **fields) -> None:
        tele = obs.active()
        if tele is not None:
            tele.emit(type_, **{k: v for k, v in fields.items()
                                if v is not None})

    def stats(self) -> dict:
        """Queue depth, terminal-state counters, retry / escalation /
        degradation accounting, and the completed requests' latency
        percentiles (plus the compile-cache snapshot with a telemetry
        session active)."""
        c = self.metrics.counters()
        lat = np.asarray(sorted(self._latencies), np.float64)
        pct = (lambda q: float(np.percentile(lat, q)) if lat.size else None)
        out = {
            "queue_depth": len(self._queue),
            "latency_p50_s": pct(50),
            "latency_p99_s": pct(99),
            "escalated_tiers": len(self._capacity),
        }
        for k in ("submitted", "admitted", "shed", "completed", "rejected",
                  "quarantined", "retries", "escalations", "batches",
                  "chunks", "degraded", "deadline_expired"):
            out[k] = int(c.get(f"serving.{k}", 0))
        tele = obs.active()
        if tele is not None:
            out["compile_cache"] = tele.metrics.compile_snapshot()
        return out


def _sig_str(sig: tuple) -> str:
    scenario, params, t_steps, probes, degraded = sig
    kv = ",".join(f"{k}={v}" for k, v in params)
    return (f"{scenario}({kv})/T{t_steps}"
            + ("/degraded" if degraded else ""))


__all__ = ["COMPLETED", "QUARANTINED", "QUEUED", "REJECTED", "TERMINAL",
           "SimRequest", "SimServeConfig", "SimServer"]
