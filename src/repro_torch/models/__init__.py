"""The LM side-stack of the port: the dense, MoE, hybrid (RG-LRU), SSM
(RWKV-6), enc-dec and VLM families (counterpart of :mod:`repro.models`)."""

from .model import (LMParams, ModelConfig, abstract_params, cast_for_compute,
                    count_params, decode_step, forward, init_cache,
                    init_params, loss_fn, module_param_axes, param_axes,
                    param_specs, prefill)

__all__ = ["LMParams", "ModelConfig", "abstract_params", "cast_for_compute",
           "count_params", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "module_param_axes", "param_axes",
           "param_specs", "prefill"]
