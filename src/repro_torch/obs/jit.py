"""Per-signature call accounting: the port's stand-in for
``repro/obs/jit.py::InstrumentedJit``.

PyTorch runs eagerly and compiles nothing, but ``compile_cache`` keeps the
reference's meaning: the first call with a new argument signature (the
values of the static arguments; the shapes, dtypes and devices of the
tensor leaves of the others, the structure around them, the types of
other leaves) is a miss, as a jit retrace is, and a repeat is a hit.  A
miss records a compile whose trace and compile times are 0 and whose cost
is unknown, and, with a telemetry session active, emits a ``compile``
event.  The wrapped function runs unchanged either way.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from .metrics import MetricsRegistry
from .trace import active


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
    """Wrap ``fn`` so that calls count compile-cache hits and misses
    (``compile_cache.hits`` / ``.misses``; the per-signature records name
    the function), keyed by :func:`signature` of the arguments, with the
    arguments at ``static_argnums`` keyed by value (as jit's static
    arguments are).

    ``registry`` binds always-on accounting (the serving engine's);
    without one the ambient telemetry session's registry is used, and
    with no session either the call passes straight through.
    """

    def __init__(self, fn, name: str,
                 registry: Optional[MetricsRegistry] = None,
                 static_argnums=()):
        self.fn = fn
        self.name = name
        self.registry = registry
        self._static = frozenset(static_argnums)
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        tele = active()
        reg = self.registry if self.registry is not None else (
            tele.metrics if tele is not None else None)
        if reg is None:
            return self.fn(*args, **kwargs)
        key = tuple(("v", a) if i in self._static else signature(a)
                    for i, a in enumerate(args))
        if key in self._seen:
            reg.inc("compile_cache.hits")
        else:
            self._seen.add(key)
            reg.inc("compile_cache.misses")
            sig = hashlib.sha256(repr(key).encode()).hexdigest()[:12]
            reg.record_compile(self.name, sig, 0.0, 0.0, None, None)
            if tele is not None:
                tele.emit("compile", fn=self.name, signature=sig,
                          trace_s=0.0, compile_s=0.0, flops=None,
                          bytes_accessed=None, fallback=False)
        return self.fn(*args, **kwargs)


__all__ = ["InstrumentedCall", "signature"]
