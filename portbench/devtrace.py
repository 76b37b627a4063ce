"""Reading a stretch of the run from ``torch.profiler``.

A :class:`Stretch` is started and stopped at chunk boundaries, where the
program has drained the device, so the stretch holds whole steps.  From
its events: the device's busy time (the union of every kernel, copy and
set on the device), the summed device time and count of those
activities, the device operations that took most time, and the idle
gaps between them, each named by the innermost host operation running at
its middle ("python" where none was).
"""

from __future__ import annotations

import collections
import time

import torch

TOP = 10


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


class Stretch:
    """``host=False`` records the device's activity alone (on a card), so
    that the stretch runs at nearly its own speed; ``host=True`` also
    records every host operation, to name the idle gaps, at the cost of
    slowing the host by about half."""

    def __init__(self, device: torch.device, host: bool):
        acts = []
        if host or device.type != "cuda":
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.wall_s = None

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> dict:
        """busy_s, device_s, device_events, top device ops, idle gaps."""
        dev, cpu = [], []
        for e in self._prof.profiler.kineto_results.events():
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, start + dur, e.name()))
            elif dur > 0:
                cpu.append((start, start + dur, e.name()))
        dev.sort()
        ops: dict = collections.defaultdict(float)
        for a, b, name in dev:
            ops[name] += (b - a) * 1e-9
        busy, gaps, end = 0, [], None
        for a, b, _ in dev:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return {"wall_s": self.wall_s, "busy_s": busy * 1e-9,
                "device_s": sum(ops.values()), "device_events": len(dev),
                "device_ops": [(_short(k), v) for k, v in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:TOP]],
                "idle_gaps": _name_gaps(gaps, cpu)}


def _short(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.startswith("void "):
        return name
    return name.replace("(anonymous namespace)", "anon").split("(")[0]


def _name_gaps(gaps, cpu) -> list:
    """Idle seconds by the innermost host operation open at each gap's
    middle, the ten largest: one sweep over the host operations (sorted
    by start, nested as one thread runs them) and the gaps in order."""
    cpu.sort()
    out: dict = collections.defaultdict(float)
    stack: list = []
    j = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while j < len(cpu) and cpu[j][0] <= mid:
            while stack and stack[-1][1] < cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "python"] += (b - a) * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])[:TOP]
