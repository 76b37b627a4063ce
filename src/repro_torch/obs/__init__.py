"""Host-side accounting of the port (counterpart of the parts of
:mod:`repro.obs` that the serving engine reads)."""

from .jit import InstrumentedCall
from .metrics import MetricsRegistry

__all__ = ["InstrumentedCall", "MetricsRegistry"]
