"""Parameter init helpers of the LM stack.

Counterpart of ``repro/models/param.py``'s init helpers.  The reference
pairs every leaf with logical sharding axes for its TPU meshes; on one
card there is nothing to shard, so the port keeps plain tensors.  Random
draws come from a ``torch.Generator`` on the parameters' device and do not
reproduce JAX's streams: tests carry JAX weights over with
:func:`repro_torch.convert.lm_params_from_jax`.
"""

from __future__ import annotations

import torch


def dense_param(gen: torch.Generator, in_dim: int, out_dim: int,
                device=None) -> torch.Tensor:
    """``[in_dim, out_dim]`` float32 normal draws times ``1 / sqrt(in_dim)``
    (scaled in place)."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return w.mul_(in_dim ** -0.5)


def bias_param(dim: int, device=None) -> torch.Tensor:
    return torch.zeros(dim, device=device)


def scale_param(dim: int, device=None) -> torch.Tensor:
    return torch.ones(dim, device=device)


__all__ = ["bias_param", "dense_param", "scale_param"]
