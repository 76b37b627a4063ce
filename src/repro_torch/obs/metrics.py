"""Thread-safe metrics registry: counters, observations, compile records.

Counterpart of ``repro/obs/metrics.py``.  One registry rides on each
:class:`repro_torch.obs.Telemetry` session (ambient instrumentation), and
components with always-on accounting (the serving engine's admission and
batching counters, the simulation server's) own a registry directly.
Everything is host-side Python; nothing here touches a device.
"""

from __future__ import annotations

import threading
from typing import Optional


class MetricsRegistry:
    """Counters (``inc``), observations (``observe``: count and total
    per key; phase wall times use these), and per-signature compile
    records (:meth:`record_compile` / :meth:`compile_snapshot`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._observations: dict[str, dict] = {}
        self._compiles: list[dict] = []

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            o = self._observations.setdefault(name,
                                              {"count": 0, "total": 0.0})
            o["count"] += 1
            o["total"] += value

    def record_compile(self, fn: str, signature: str, trace_s: float,
                       compile_s: float, flops: Optional[float],
                       bytes_accessed: Optional[float],
                       fallback: bool = False) -> None:
        """One record per compile-cache miss."""
        with self._lock:
            self._compiles.append({
                "fn": fn, "signature": signature,
                "trace_s": trace_s, "compile_s": compile_s,
                "flops": flops, "bytes_accessed": bytes_accessed,
                "fallback": fallback,
            })

    def counters(self) -> dict:
        """Flat name -> number dict: counters plus flattened observation
        aggregates (``<name>.count`` / ``<name>.total_s``)."""
        with self._lock:
            out = dict(self._counters)
            for name, o in self._observations.items():
                out[f"{name}.count"] = o["count"]
                out[f"{name}.total_s"] = round(o["total"], 6)
            return out

    def observations(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._observations.items()}

    def compile_snapshot(self) -> dict:
        """Hit/miss totals plus the per-signature records (attached to
        ``SimResult.stats`` / ``DistResult.stats`` when a telemetry
        session is active)."""
        with self._lock:
            return {
                "hits": int(self._counters.get("compile_cache.hits", 0)),
                "misses": int(self._counters.get("compile_cache.misses", 0)),
                "signatures": [dict(r) for r in self._compiles],
            }

    def snapshot(self) -> dict:
        return {"counters": self.counters(),
                "observations": self.observations(),
                "compile_cache": self.compile_snapshot()}


__all__ = ["MetricsRegistry"]
