"""Per-signature call accounting: the port's stand-in for
``repro/obs/jit.py::InstrumentedJit``.

PyTorch runs eagerly and compiles nothing, but the serving engine's
``stats()["compile_cache"]`` keeps the reference's meaning: the first call
with a new argument signature (the shapes, dtypes and devices of the
tensor leaves, the structure around them, the types of other leaves) is a
miss, as a jit retrace is, and a repeat is a hit.  A miss records a
compile whose trace and compile times are 0 and whose cost is unknown.
"""

from __future__ import annotations

import hashlib

import torch

from .metrics import MetricsRegistry


def signature(x):
    """The jit-style cache key of an argument tree."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, torch.nn.Module):
        return ("m", type(x).__name__, tuple(
            (name, tuple(p.shape), str(p.dtype))
            for name, p in x.named_parameters()))
    if isinstance(x, dict):
        return ("d", tuple((k, signature(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(signature(v) for v in x))
    return ("s", type(x).__name__)


class InstrumentedCall:
    """Wrap ``fn`` so that calls count compile-cache hits and misses in
    ``registry`` (``compile_cache.hits`` / ``.misses`` and per-function
    counters), keyed by :func:`signature` of the arguments."""

    def __init__(self, fn, name: str, registry: MetricsRegistry):
        self.fn = fn
        self.name = name
        self.registry = registry
        self._seen: set = set()

    def __call__(self, *args):
        key = signature(args)
        reg = self.registry
        if key in self._seen:
            reg.inc("compile_cache.hits")
            reg.inc(f"compile_cache.{self.name}.hits")
        else:
            self._seen.add(key)
            reg.inc("compile_cache.misses")
            reg.inc(f"compile_cache.{self.name}.misses")
            reg.record_compile(self.name, hashlib.sha256(
                repr(key).encode()).hexdigest()[:12], 0.0, 0.0, None, None)
        return self.fn(*args)


__all__ = ["InstrumentedCall", "signature"]
