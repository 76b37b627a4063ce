"""Fault-injection wrapper scheme: break the exchange layer on purpose.

Counterpart of ``repro/core/exchange/faulty.py``.  The scheme wraps any
registered partitioned scheme and injects the failure modes the
resilience layer (:mod:`repro_torch.core.health`) must survive:

* **dropped payloads** (``drop_payload_at``): at configured steps the
  chosen partition's delayed spikes are zeroed before compaction, so its
  whole outgoing fan-out vanishes from every partition's event list.
  The inner scheme's drop accounting compares the requested fan-out
  (of the clean spikes) against the kept one, so the loss lands in the
  ``dropped`` counter.
* **corrupt payloads** (``corrupt_payload_at``): the partition's
  delayed-spike vector is rolled by one neuron before compaction (wrong
  ids enter the event list).
* **partition failure / stragglers** (``fail_at`` / ``straggle_at``):
  host-side, through the chunk loop's ``host_hook``
  (:meth:`FaultyExchange.host_supervise`): a configured step inside the
  upcoming chunk raises :class:`ExchangeFault` once, or sleeps
  ``straggle_s`` seconds per configured straggle step.

The reference keeps the fault steps as traced arrays so that a new plan
never retraces; the port runs eagerly, so the plan is plain Python on
the state and a step that injects nothing costs no device op.  The
partition test is ``topo.index == part`` (the reference's
``axis_index``), and the step is the absolute one
(:func:`repro_torch.core.step.step_exchange`), so a resumed run fires at
the steps an unbroken run would.  ``build`` / ``exchange`` / ``deliver``
delegate to the inner scheme, and so do ``fuses_lif`` /
``deliver_fused``: with ``engine="blocked_fused"`` a ``faulty`` wrapper
of ``blocked`` runs the fused kernel, whose result is bitwise the
unfused one's.  Typical use::

    configure_faulty(inner="event", spec=FaultSpec(partition=1,
                                                   fail_at=(96,)))
    cfg = DistConfig(sim, scheme="faulty")
    run_resilient(lambda resume, cap: simulate_distributed(...), ...)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import torch

from .base import Topology, get_scheme, register_scheme


class ExchangeFault(RuntimeError):
    """Injected partition failure (host-side, from ``host_supervise``)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What to break, where, and when (step indices are global)."""

    partition: int = 0
    drop_payload_at: tuple = ()      # zero the partition's outgoing spikes
    corrupt_payload_at: tuple = ()   # roll its spike vector by one
    fail_at: tuple = ()              # raise ExchangeFault (host, once each)
    straggle_at: tuple = ()          # sleep straggle_s (host)
    straggle_s: float = 0.05


class FaultyState(NamedTuple):
    """The inner scheme's state plus the fault plan (the same plan on
    every partition; the partitioned runner slices only tensors)."""

    inner: Any
    part: int              # the faulty partition's index
    drop_at: frozenset     # steps whose payload is zeroed
    corrupt_at: frozenset  # steps whose payload is rolled by one


@register_scheme
class FaultyExchange:
    """``scheme="faulty"``: the configured inner scheme plus injected
    faults.  Configure with :func:`configure_faulty` before a run."""

    name = "faulty"

    def __init__(self):
        self._inner = "event"
        self._spec = FaultSpec()
        self._fired: set = set()

    # -- host-side configuration ------------------------------------------
    def configure(self, inner: str = "event",
                  spec: FaultSpec = FaultSpec()) -> "FaultyExchange":
        if inner in ("faulty", "local"):
            raise ValueError(f"cannot wrap the {inner!r} scheme")
        self._inner = inner
        self._spec = spec
        self._fired = set()
        return self

    @property
    def scheme(self):
        return get_scheme(self._inner)

    # -- ExchangeScheme protocol ------------------------------------------
    def build(self, d, sim, cap, device, parts=None) -> FaultyState:
        s = self._spec
        return FaultyState(
            inner=self.scheme.build(d, sim, cap, device, parts),
            part=int(s.partition),
            drop_at=frozenset(int(t) for t in s.drop_payload_at),
            corrupt_at=frozenset(int(t) for t in s.corrupt_payload_at))

    def init_stats(self) -> dict:
        return self.scheme.init_stats()

    def exchange(self, state: FaultyState, delayed, cap, topo: Topology):
        # the t-free protocol entry; the step prefers exchange_at
        return self.scheme.exchange(state.inner, delayed, cap, topo)

    def exchange_at(self, state: FaultyState, delayed, cap, topo: Topology,
                    t: int):
        """Inject on the configured partition at the configured steps,
        then run the inner exchange on the (possibly sabotaged) spikes
        ``[..., U]``."""
        if topo.index == state.part:
            if t in state.drop_at:
                delayed = torch.zeros_like(delayed)
            if t in state.corrupt_at:
                delayed = torch.roll(delayed, 1, dims=-1)
        return self.scheme.exchange(state.inner, delayed, cap, topo)

    def deliver(self, state: FaultyState, payload, delayed, sim, cap,
                topo: Topology):
        return self.scheme.deliver(state.inner, payload, delayed, sim, cap,
                                   topo)

    def fuses_lif(self, sim) -> bool:
        fuses = getattr(self.scheme, "fuses_lif", None)
        return bool(fuses(sim)) if fuses is not None else False

    def deliver_fused(self, state: FaultyState, payload, delayed, lif, drive,
                      sim, cap, topo: Topology):
        return self.scheme.deliver_fused(state.inner, payload, delayed, lif,
                                         drive, sim, cap, topo)

    # -- chunk-loop hook --------------------------------------------------
    def host_supervise(self, start: int, stop: int) -> None:
        """Called by :func:`repro_torch.core.health.run_chunked` before
        each chunk ``[start, stop)``: sleep per straggle step, then raise
        for a configured failure step, once per step, so the supervisor's
        restarted attempt proceeds past it (a crash, not a poison)."""
        s = self._spec
        for t in s.straggle_at:
            if start <= t < stop:
                time.sleep(s.straggle_s)
        for t in s.fail_at:
            if start <= t < stop and t not in self._fired:
                self._fired.add(t)
                raise ExchangeFault(
                    f"injected failure of partition {s.partition} "
                    f"at step {t}")


def configure_faulty(inner: str = "event",
                     spec: FaultSpec = FaultSpec()) -> FaultyExchange:
    """Configure the registered ``faulty`` singleton and return it."""
    return get_scheme("faulty").configure(inner=inner, spec=spec)


__all__ = ["ExchangeFault", "FaultSpec", "FaultyExchange", "FaultyState",
           "configure_faulty"]
