"""Plain oracle: materialized-scores softmax attention with the same causal
/ sliding-window / GQA semantics.  Counterpart of
``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D].  Query i sits at position
    ``i + Skv - Sq`` (the ends aligned, as in decode).  Returns q.dtype."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    groups = H // Hkv
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=1)
        v = torch.repeat_interleave(v, groups, dim=1)
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_ids = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_ids = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        mask &= k_ids > q_ids - window - 1
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


__all__ = ["attention_ref"]
