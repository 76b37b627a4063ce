"""Serving layer of the port: two front ends over the batched compute
cores (counterparts of :mod:`repro.serving`).

* :mod:`repro_torch.serving.engine`: LM serving, slot-based continuous
  batching over prefill/decode.
* :mod:`repro_torch.serving.sim`: simulation serving for the connectome
  simulator: admission control, batching by signature onto one chunked
  run of lanes, per-lane health attribution, retry with backoff, poison
  quarantine, load shedding, degradation and per-tier capacity
  escalation.
"""

from .engine import Request, ServeConfig, ServingEngine
from .sim import (COMPLETED, QUARANTINED, QUEUED, REJECTED, TERMINAL,
                  SimRequest, SimServeConfig, SimServer)

__all__ = [
    "Request", "ServeConfig", "ServingEngine",
    "COMPLETED", "QUARANTINED", "QUEUED", "REJECTED", "TERMINAL",
    "SimRequest", "SimServeConfig", "SimServer",
]
