"""Synthetic LM data of the port (counterpart of :mod:`repro.data`)."""

from .pipeline import SyntheticLM, make_global_batch

__all__ = ["SyntheticLM", "make_global_batch"]
