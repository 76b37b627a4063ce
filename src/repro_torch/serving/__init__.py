"""LM serving of the port: the slot-based continuous-batching engine
(counterpart of :mod:`repro.serving.engine`)."""

from .engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
