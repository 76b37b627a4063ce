"""Thread-safe metrics registry: counters and compile-cache records.

Counterpart of the counter and compile-record parts of
``repro/obs/metrics.py`` (what ``ServingEngine.stats()`` reads).
Everything is host-side Python; nothing here touches a device.
"""

from __future__ import annotations

import threading
from typing import Optional


class MetricsRegistry:
    """Counters (``inc``) and per-signature compile records
    (:meth:`record_compile` / :meth:`compile_snapshot`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._compiles: list[dict] = []

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

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
        """Flat name -> number dict of the counters."""
        with self._lock:
            return dict(self._counters)

    def compile_snapshot(self) -> dict:
        """Hit/miss totals plus the per-signature records."""
        with self._lock:
            return {
                "hits": int(self._counters.get("compile_cache.hits", 0)),
                "misses": int(self._counters.get("compile_cache.misses", 0)),
                "signatures": [dict(r) for r in self._compiles],
            }


__all__ = ["MetricsRegistry"]
