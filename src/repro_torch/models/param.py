"""Parameter init helpers of the LM stack.

Counterpart of ``repro/models/param.py``'s init helpers.  The reference
pairs every leaf with its logical sharding axes at init (``Param``); the
port keeps plain tensors and names the axes apart, per parameter name
(:func:`repro_torch.models.param_axes`, for
:mod:`repro_torch.parallel.sharding`).  The logical names: ``embed``
(d_model; FSDP over the data axes), ``heads`` / ``kv_heads`` (attention
head dims), ``mlp`` (d_ff), ``vocab``, ``experts`` (all over ``model``),
None (replicated).  The reference's ``layers`` axis of a scanned stack
has no counterpart: the port's layers are modules of their own.  Random
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


def expert_param(gen: torch.Generator, n_experts: int, in_dim: int,
                 out_dim: int, scale_dim: int, device=None) -> torch.Tensor:
    """``[n_experts, in_dim, out_dim]`` float32 normal draws times
    ``1 / sqrt(scale_dim)`` (the reference scales every expert matrix by
    ``d_model``)."""
    w = torch.randn((n_experts, in_dim, out_dim), generator=gen,
                    device=device)
    return w.mul_(scale_dim ** -0.5)


def bias_param(dim: int, device=None) -> torch.Tensor:
    return torch.zeros(dim, device=device)


def scale_param(dim: int, device=None) -> torch.Tensor:
    return torch.ones(dim, device=device)


__all__ = ["bias_param", "dense_param", "expert_param", "scale_param"]
