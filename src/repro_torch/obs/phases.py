"""Step phases: marks on the device stream inside the step loop.

A session's ``phases`` switch (:class:`~repro_torch.obs.Telemetry`, off
by default) turns them on.  :func:`repro_torch.core.health.run_chunked`
reads it once at each chunk's start and, for a run on a CUDA device,
opens a :class:`PhaseMarks` around the chunk; the step halves
(:func:`repro_torch.core.step.step_exchange` and ``step_finish``, shared
by every runner) mark where each phase of a step starts.  A mark records
one timing event on the stream and ends the phase before it, so the
marks tile the chunk: the first phase opens at the chunk's start and the
last closes at its end.  At the chunk's boundary :meth:`PhaseMarks.seconds`
sums each phase's stream time over the chunk's steps, waiting for each
mark in turn, so that it runs while the device finishes the chunk.  One
:class:`PhaseMarks` serves a whole run: each chunk records the events of
the one before again, so none is created or destroyed at a boundary.

The phases of a step (:data:`PHASES`): ``entry`` (the chunk's start: the
ring's copy, the voltage rows), ``keys`` (the key split), ``exchange``
(the delayed read, the scheme's exchange, the collective), ``stimulus``
(the stimulus draws), ``deliver`` (delivery and the LIF update, the
fused engines' pads included), ``finish`` (pad mask, ring write,
counters, health sentinels, scheme stats) and ``probes`` (the probe
records, and their stacking after the chunk's last step).

With the switch on each phase also opens a
``torch.profiler.record_function("step.<name>")`` range, so a profiler
trace shows the phases on its own clock beside the kernels they launch.
With it off, or on a CPU device, a mark site finds no marks
(:func:`current` is None) and does nothing else.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Optional

import torch

PHASES = ("entry", "keys", "exchange", "stimulus", "deliver", "finish",
          "probes")

_CURRENT: ContextVar[Optional["PhaseMarks"]] = ContextVar(
    "repro_torch_obs_phase_marks", default=None)


def current() -> Optional["PhaseMarks"]:
    """The marks of the chunk in flight, or None: the one check a mark
    site makes."""
    return _CURRENT.get()


def event_class(device: torch.device):
    """The timing event of marks on ``device``: CUDA's on a card, None
    elsewhere (no marks)."""
    return torch.cuda.Event if device.type == "cuda" else None


class PhaseMarks:
    """The marks of a run's chunks.  ``event`` is the timing-event class
    (constructed with ``enable_timing=True``, with ``record(stream)``,
    ``synchronize()`` and ``elapsed_time(later) -> ms``); ``stream`` the
    stream they are recorded on (None: the current one).

    Used as a context manager around each chunk of a run: entering makes
    the marks current and opens ``entry``; ``marks(name)`` opens phase
    ``name``; leaving closes the last phase and clears them."""

    def __init__(self, event, stream=None):
        self._event = event
        self._stream = stream
        self._names: list[str] = []
        self._events: list = []
        self._spare: list = []
        self._range = None
        self._token = None

    @classmethod
    def for_device(cls, device: torch.device) -> Optional["PhaseMarks"]:
        """Marks for a chunk run on ``device``, or None where it has no
        timing event."""
        event = event_class(device)
        if event is None:
            return None
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        return cls(event, stream)

    def _record(self) -> None:
        ev = (self._spare.pop() if self._spare
              else self._event(enable_timing=True))
        ev.record(self._stream)
        self._events.append(ev)

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __call__(self, name: str) -> None:
        """Open phase ``name`` here, closing the one before it."""
        self._record()
        self._names.append(name)
        self._close_range()
        self._range = torch.profiler.record_function(f"step.{name}")
        self._range.__enter__()

    def __enter__(self) -> "PhaseMarks":
        # the last chunk's events have all completed: record them again
        self._spare, self._events, self._names = self._events, [], []
        self._token = _CURRENT.set(self)
        self("entry")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _CURRENT.reset(self._token)
        self._record()
        self._close_range()
        return False

    def seconds(self) -> dict[str, float]:
        """Each phase's stream time summed over the chunk, in seconds, in
        the order the phases first opened.  Waits for each mark before
        reading it, the last one being the chunk's end."""
        out: dict[str, float] = {}
        for name, a, b in zip(self._names, self._events, self._events[1:]):
            b.synchronize()
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) * 1e-3
        return out


__all__ = ["PHASES", "PhaseMarks", "current", "event_class"]
