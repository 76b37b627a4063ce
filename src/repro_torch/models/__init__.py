"""The LM side-stack of the port: the dense transformer family (counterpart
of :mod:`repro.models`)."""

from .model import (LMParams, ModelConfig, count_params, decode_step, forward,
                    init_cache, init_params, prefill)

__all__ = ["LMParams", "ModelConfig", "count_params", "decode_step",
           "forward", "init_cache", "init_params", "prefill"]
