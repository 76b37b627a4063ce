"""Runtime telemetry of the port (counterpart of :mod:`repro.obs`).

Off the compute path: with no telemetry session active every hook checks
:func:`active` once and does nothing (no device op, no synchronization);
with one, the instrumentation is host-side at chunk and run granularity,
and the device is synchronized only at chunk boundaries, so results are
bitwise the same with telemetry on or off.

* :func:`telemetry` / :func:`active` / :class:`Telemetry`: the ambient
  session, an optional :class:`EventSink` (JSONL file, callback) plus a
  :class:`MetricsRegistry`.
* :class:`span`: nested, thread-safe, monotonic-clock tracing spans
  wired through ``simulate``, ``simulate_distributed``, the chunk loop
  and the host-side builds; each ``span`` event carries its start on
  the session clock and its parent span's name.
* Step phases (:mod:`repro_torch.obs.phases`): a session's ``phases``
  switch, off by default (``session.phases = True``, also on the live
  session).
  When it is on, each chunk of a run on a CUDA device is marked on the
  device stream at every phase of the step (``entry``, ``keys``,
  ``exchange``, ``stimulus``, ``deliver``, ``finish``, ``probes``); its
  ``chunk`` event gains ``phases`` (seconds a phase over the chunk) and
  ``drain_s`` (the host's wait at the boundary), the registry
  ``step.<name>``, and every span and phase is also a
  ``torch.profiler.record_function`` range.  When it is off nothing of
  this runs: no event, no range, no device op.  The simulation CLI's
  ``--telemetry PATH`` and ``--profile DIR`` turn it on.
* :class:`InstrumentedCall`: per-signature compile-cache counters around
  the step loops (``stats["compile_cache"]``).
* :class:`JsonlSink`: streamed events, validated by ``schema.json``
  (``python -m repro_torch.obs.check run.jsonl``).
* ``python -m repro_torch.obs.report run.jsonl``: phase, throughput and
  health summary of an event stream.
* :func:`profile_trace`: ``torch.profiler`` around a block, for the
  launcher's ``--profile DIR``.
"""

from .events import CallbackSink, EventSink, JsonlSink, coerce_sink
from .jit import InstrumentedCall
from .metrics import MetricsRegistry
from .profiler import profile_trace
from .schema import validate_record
from .trace import Telemetry, active, span, telemetry

__all__ = ["CallbackSink", "EventSink", "InstrumentedCall", "JsonlSink",
           "MetricsRegistry", "Telemetry", "active", "coerce_sink",
           "profile_trace", "span", "telemetry", "validate_record"]
