"""The LM side-stack of the port: the dense, MoE, hybrid (RG-LRU), SSM
(RWKV-6), enc-dec and VLM families (counterpart of :mod:`repro.models`)."""

from .model import (LMParams, ModelConfig, cast_for_compute, count_params,
                    decode_step, forward, init_cache, init_params, loss_fn,
                    prefill)

__all__ = ["LMParams", "ModelConfig", "cast_for_compute", "count_params",
           "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "prefill"]
