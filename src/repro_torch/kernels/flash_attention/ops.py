"""GQA-aware entry point of the flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/ops.py``: the operands are
cast to float32 for the kernel and the result back to ``q.dtype``.  The
kernel reads kv head ``h // groups`` in place, so nothing is repeated or
padded here; the TPU's block sizes and interpret flag have no counterpart.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_gqa, refuse_grad


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D] with H % Hkv == 0 (GQA).

    window: sliding-window size (keys within [i-window, i]); None = full.
    Returns [B, H, Sq, D] in q.dtype.  Not differentiable, as the
    reference's is not: raises when grad is enabled and an operand
    requires grad (use ``"chunked"`` attention to train).
    """
    refuse_grad(q, k, v)
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    out = flash_attention_gqa(f32(q), f32(k), f32(v), scale=scale,
                              causal=causal, window=window)
    return out.to(q.dtype)


__all__ = ["flash_attention"]
