"""Event sinks: where telemetry records go.

Counterpart of ``repro/obs/events.py``.  A sink receives one JSON-able
dict per event.  The only contract is :meth:`EventSink.emit` /
:meth:`EventSink.close`; :class:`JsonlSink` streams records to a
``.jsonl`` file through a background writer thread (the run loop never
blocks on disk; ``close()`` joins the writer and re-raises anything it
raised, as :class:`repro_torch.train.checkpoint.CheckpointHandle` does).
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Callable, Optional


def _jsonable(x):
    """Coerce numpy / torch scalars and tuples into plain JSON types."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, (int, float, str)):
        return x
    item = getattr(x, "item", None)   # numpy scalar, one-element tensor
    if item is not None:
        try:
            return _jsonable(item())
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(x)


class EventSink:
    """Base sink: subclasses override :meth:`emit`; :meth:`close` is
    idempotent and must flush."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CallbackSink(EventSink):
    """Deliver each record to a host callback (tests, live dashboards)."""

    def __init__(self, fn: Callable[[dict], None]):
        self._fn = fn

    def emit(self, record: dict) -> None:
        self._fn(record)


_CLOSE = object()


class JsonlSink(EventSink):
    """One JSON object per line, flushed by a background writer thread.

    ``emit`` enqueues and returns immediately; ``close`` drains the
    queue, joins the writer, and re-raises any write-thread failure.
    ``async_flush=False`` writes inline (deterministic ordering for
    tests).
    """

    def __init__(self, path: str, async_flush: bool = True):
        self.path = str(path)
        self._file = open(self.path, "w")
        self._error: Optional[BaseException] = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if async_flush:
            self._queue = queue.Queue()
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def _write(self, record: dict) -> None:
        self._file.write(json.dumps(_jsonable(record)) + "\n")
        self._file.flush()

    def _drain(self) -> None:
        while True:
            rec = self._queue.get()
            if rec is _CLOSE:
                return
            try:
                self._write(rec)
            except BaseException as e:  # noqa: BLE001 — re-raised in close
                self._error = e
                return

    def emit(self, record: dict) -> None:
        if self._error is not None:
            raise self._error
        if self._queue is not None:
            self._queue.put(record)
        else:
            self._write(record)

    def close(self) -> None:
        if self._thread is not None:
            self._queue.put(_CLOSE)
            self._thread.join()
            self._thread = None
        if not self._file.closed:
            self._file.close()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def coerce_sink(sink) -> Optional[EventSink]:
    """None | EventSink | path-like -> JsonlSink | callable -> CallbackSink."""
    if sink is None or isinstance(sink, EventSink):
        return sink
    if callable(sink):
        return CallbackSink(sink)
    return JsonlSink(sink)


__all__ = ["CallbackSink", "EventSink", "JsonlSink", "coerce_sink"]
