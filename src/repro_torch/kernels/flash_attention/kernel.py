"""Flash attention (online softmax) as a CUDA kernel.

Counterpart of ``repro/kernels/flash_attention/kernel.py``:

==================== ============================================ ===================
wrapper              replaces                                     CUDA source
==================== ============================================ ===================
flash_attention_gqa  flash_attention_pallas (kernel.py:85)        flash_attention.cu
==================== ============================================ ===================

The TPU kernel takes GQA-expanded, block-padded ``[BH, S, D]`` operands and
carries the running max, sum and accumulator in VMEM across a sequential kv
grid axis.  Here one CUDA block owns a (batch x head, 64-query block) pair
and loops over key tiles itself, reading kv head ``h // groups`` in place
(no expanded copy) and masking the ragged ends instead of padding.  Both
products run on the tensor cores at float32 accuracy: each operand is
split into two TF32 parts and each product formed from three TF32
products (3xTF32); see the source's note.
The semantics are the TPU kernel's: query ``i`` sits at position ``i``
(not end-aligned), keys at ``j >= Skv`` are masked, causal keeps
``j <= i``, a window keeps ``j > i - window - 1``, fully masked tiles are
skipped, and a row whose every key is masked comes out as zeros.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device, or raises; ``LAUNCHES`` counts
launches.  On the ``meta`` device it returns an empty result of the right
shape, so a step can be counted without memory
(:mod:`repro_torch.launch.hlo`); on ``meta`` and CUDA alike it charges its
work to an active counter (:func:`repro_torch.kernels.build.charge`).
Neither is differentiable: the TPU kernel has no backward (``jax.grad``
through it raises), so the wrapper refuses operands that autograd would
differentiate (:func:`refuse_grad`), on either device.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from repro_torch.kernels import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")
SOURCES = {"flash_attention": SOURCE}
NEG_INF = -1e30
MAX_HEAD_DIM = 256

#: Kernel launches per wrapper (plain-version calls are not counted).
LAUNCHES = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_F, _I, _I, _I, _P]


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _mask(Sq, Skv, causal, window, device):
    q_ids = torch.arange(Sq, device=device)[:, None]
    k_ids = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        mask &= k_ids > q_ids - window - 1
    return mask


def kept_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the kernel's masks keep: query ``i`` sees
    the keys ``j < Skv`` with ``j <= i`` (causal) and ``j >= i - window``
    (window)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(
        0, i - window)
    return int(np.maximum(hi - lo + 1, 0).sum())


def refuse_grad(q, k, v) -> None:
    """Raise when autograd would differentiate through the kernel: grad
    mode on and an operand that requires grad.  The kernel writes into a
    tensor autograd cannot see, so a gradient through it would be dropped
    without a word; the reference raises there, and so does the port."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward (nor has the TPU kernel): "
            "train with attention_impl='chunked', or run under "
            "torch.no_grad() / torch.inference_mode()")


def flash_attention_plain(q, k, v, *, scale, causal, window):
    """Plain PyTorch version of :func:`flash_attention_gqa`: the same
    masks and zero rows, with the scores materialized per kv head group."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    mask = _mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, H, Sq, D)


def flash_attention_gqa(q, k, v, *, scale: float, causal: bool,
                        window: int | None):
    """q: [B, H, Sq, D], k/v: [B, Hkv, Skv, D], float32, contiguous, with
    H % Hkv == 0 and D <= 256.  Returns [B, H, Sq, D] float32.  Raises
    under grad (:func:`refuse_grad`)."""
    refuse_grad(q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B, H, Sq, D], k and v [B, Hkv, Skv, D]")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    dev = q.device
    build.check_tensor("q", q, torch.float32, (B, H, Sq, D), dev)
    build.check_tensor("k", k, torch.float32, (B, Hkv, Skv, D), dev)
    build.check_tensor("v", v, torch.float32, (B, Hkv, Skv, D), dev)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_gqa: no kernel for {dev}")
    out = torch.empty_like(q)
    if dev.type == "cuda":
        # 16-byte copies need rows of whole 16-byte chunks on 16-byte
        # bounds
        vec = D % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (q, k, v))
        rc = build.function(SOURCE, "flash_attention_launch", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, Sq, Skv, D, scale, int(causal),
            -1 if window is None else window, int(vec), build.stream(dev))
        build.raise_on(rc, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    build.charge("flash_attention",
                 4 * B * H * D * kept_pairs(Sq, Skv, causal, window),
                 4 * (2 * q.numel() + 2 * k.numel()))
    return out


__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "SOURCE", "SOURCES",
           "flash_attention_gqa", "flash_attention_plain", "kept_pairs",
           "refuse_grad", "reset_launches"]
