"""The ambient telemetry session and the tracing-span API.

Counterpart of ``repro/obs/trace.py``.  A session (:func:`telemetry`
context manager) carries an optional
:class:`~repro_torch.obs.events.EventSink` and a
:class:`~repro_torch.obs.metrics.MetricsRegistry`.  Instrumented code
asks :func:`active` once and does nothing when there is no session: the
layer then costs two attribute checks and touches no device.

:class:`span` is the phase-tracing primitive: monotonic host clock,
nesting (per-thread stacks), and on exit one ``span`` event with its
start on the session clock and the name of the span that encloses it.  A
span reads the host clock only; it does not wait for the device.  The
chunk loop (:func:`repro_torch.core.health.run_chunked`) synchronizes the
device at each chunk boundary when a session is active, so chunk spans
carry the device time of their steps.

A session's ``phases`` switch (off by default, settable on the live
session) turns on the step-phase marks of :mod:`repro_torch.obs.phases`,
and while it is on every span also opens a
``torch.profiler.record_function`` range of its name, so profiler traces
carry the program's spans and phases on the profiler's own clock.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from threading import local
from typing import Optional

import torch

from .events import _jsonable, coerce_sink
from .metrics import MetricsRegistry

_ACTIVE: ContextVar[Optional["Telemetry"]] = ContextVar(
    "repro_torch_obs_active", default=None)


class Telemetry:
    """One telemetry session: sink + metrics + session-relative clock.
    ``phases`` is the step-phase switch (:mod:`repro_torch.obs.phases`),
    off until set on the session; the chunk loop reads it at each chunk's
    start."""

    def __init__(self, sink=None, validate: bool = False):
        self.sink = coerce_sink(sink)
        self.metrics = MetricsRegistry()
        self.validate = validate
        self.phases = False
        self._t0 = time.monotonic()
        self._tls = local()    # per-thread span stacks

    def now(self) -> float:
        """Seconds since the session opened (monotonic)."""
        return time.monotonic() - self._t0

    def emit(self, type_: str, **fields) -> None:
        """Emit one event record (no-op without a sink; metrics still
        accumulate).  ``validate=True`` checks every record against
        ``schema.json`` before it is written."""
        record = _jsonable({"t": round(self.now(), 6), "type": type_,
                            **fields})
        if self.validate:
            from .schema import validate_record
            errors = validate_record(record)
            if errors:
                raise ValueError(
                    f"invalid {type_!r} event: " + "; ".join(errors))
        if self.sink is not None:
            self.sink.emit(record)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


def active() -> Optional[Telemetry]:
    """The ambient session, or None: the one check every hook makes."""
    return _ACTIVE.get()


@contextlib.contextmanager
def telemetry(sink=None, *, validate: bool = False):
    """Open a telemetry session for the enclosed block.

        with obs.telemetry("run.jsonl"):
            simulate(c, cfg, t_steps, ...)

    ``sink`` is a path (JSONL file), a callable (one dict per event), an
    :class:`EventSink`, or None (metrics only).  The sink is closed
    (async writes joined, writer errors re-raised) when the block exits.
    """
    session = Telemetry(sink, validate=validate)
    token = _ACTIVE.set(session)
    try:
        yield session
    finally:
        _ACTIVE.reset(token)
        session.close()


class span:
    """Tracing span: ``with span("build", what="synapses"): ...``.

    No-op (no clock read) without an active session.  On exit
    ``wall_s`` is set on the span object and a ``span`` event is emitted:
    ``start`` (session clock), ``wall_s``, ``depth`` and ``parent`` (the
    enclosing span's name, None at the top).  With the session's
    ``phases`` switch on the span is also a profiler range of its name.
    """

    __slots__ = ("name", "attrs", "wall_s", "_session", "_start", "_depth",
                 "_parent", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.wall_s: Optional[float] = None
        self._session: Optional[Telemetry] = None

    def __enter__(self):
        s = active()
        if s is not None:
            self._session = s
            stack = s._stack()
            self._depth = len(stack)
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self._range = None
            if s.phases:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            self._start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        s = self._session
        if s is not None:
            self.wall_s = time.monotonic() - self._start
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
            s._stack().pop()
            fields = {"name": self.name,
                      "start": round(self._start - s._t0, 6),
                      "wall_s": round(self.wall_s, 6),
                      "depth": self._depth, "parent": self._parent}
            if self.attrs:
                fields["attrs"] = self.attrs
            s.emit("span", **fields)
        return False


__all__ = ["Telemetry", "active", "span", "telemetry"]
