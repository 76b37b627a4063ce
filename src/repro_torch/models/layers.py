"""Shared transformer layers: norms, RoPE, GQA attention, gated MLP.

Counterpart of ``repro/models/layers.py`` for the dense stack.  Parameters
are mappings of tensors with the reference's keys (``wq``, ``bq``,
``w_up``, ...), weights stored ``[in, out]`` as there.

Attention implementations (``cfg.attention_impl``, the reference's values):

* ``"chunked"`` -- online softmax over kv chunks in plain PyTorch (the
  reference's ``lax.scan`` becomes a loop), O(S * chunk) memory;
* ``"pallas"``  -- the flash attention kernel: on a CUDA device the port's
  hand-written CUDA kernel (:mod:`repro_torch.kernels.flash_attention`),
  on the CPU its plain version.  The name is the reference's, so its
  configs carry over unchanged.

``"banded"`` and ``"windowed"`` (XLA-shaped variants of the same math)
and the MoE layers are not ported and raise ``NotImplementedError``; the
reference's ``shard_act`` is a no-op on one device and is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import bias_param, dense_param, scale_param

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rms_norm_init(d, device=None):
    return {"scale": scale_param(d, device=device)}


def rms_norm(p, x, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def layer_norm_init(d, device=None):
    return {"scale": scale_param(d, device=device),
            "bias": bias_param(d, device=device)}


def layer_norm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope(x, positions, theta=1e4):
    """x: [..., S, n_heads, d_head]; positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs            # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def attention_init(gen, d_model, n_heads, n_kv_heads, d_head, qkv_bias=False,
                   device=None):
    p = {"wq": dense_param(gen, d_model, n_heads * d_head, device=device),
         "wk": dense_param(gen, d_model, n_kv_heads * d_head, device=device),
         "wv": dense_param(gen, d_model, n_kv_heads * d_head, device=device),
         "wo": dense_param(gen, n_heads * d_head, d_model, device=device)}
    if qkv_bias:
        p["bq"] = bias_param(n_heads * d_head, device=device)
        p["bk"] = bias_param(n_kv_heads * d_head, device=device)
        p["bv"] = bias_param(n_kv_heads * d_head, device=device)
    return p


def _qkv(p, x, n_heads, n_kv_heads, d_head):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, n_heads, d_head),
            k.reshape(B, S, n_kv_heads, d_head),
            v.reshape(B, S, n_kv_heads, d_head))


def chunked_attention(q, k, v, *, causal, window, chunk=512, q_offset=0):
    """Online softmax over kv chunks, GQA-grouped (KV is never expanded to
    H heads).  q: [B,H,Sq,D], k/v: [B,Hkv,Skv,D] with H % Hkv == 0.  Query
    i attends to key j iff j <= i+q_offset (causal) and
    j > i+q_offset-window-1 (window)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nc = (Skv + pad) // chunk
    qg = (q.float() * D ** -0.5).reshape(B, Hkv, G, Sq, D)
    q_ids = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Hkv, G, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for c in range(nc):
        c0 = c * chunk
        kb = k[:, :, c0:c0 + chunk].float()
        vb = v[:, :, c0:c0 + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        k_ids = c0 + torch.arange(chunk, device=q.device)
        mask = (k_ids[None, :] < Skv).expand(Sq, chunk)
        if causal:
            mask = mask & (k_ids[None, :] <= q_ids[:, None])
        if window is not None:
            mask = mask & (k_ids[None, :] > q_ids[:, None] - window - 1)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                   vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


def attention_apply(p, x, cfg, *, causal=True, window=None, positions=None,
                    impl="chunked", use_rope=True):
    """Full-sequence (prefill) attention.  Returns (out, (k, v)) with k, v
    ``[B, Hkv, S, D]``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    qh = q.transpose(1, 2)      # [B, H, S, D]
    kh = k.transpose(1, 2)      # [B, Hkv, S, D] -- never GQA-expanded
    vh = v.transpose(1, 2)
    if impl == "chunked":
        out = chunked_attention(qh, kh, vh, causal=causal, window=window)
    elif impl == "pallas":
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(qh, kh, vh, causal=causal, window=window)
    elif impl in ("banded", "windowed"):
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported; use 'chunked' or "
            f"'pallas' (the flash attention kernel)")
    else:
        raise ValueError(impl)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], (kh, vh)


def attention_decode(p, x, cache_k, cache_v, pos, cfg, *, window=None,
                     use_rope=True):
    """One-token decode.  x: [B, 1, d]; cache_k/v: [B, Hkv, Smax, D];
    pos: int or per-slot [B] positions (continuous batching).

    Unlike the reference, which returns updated copies, the token's k and
    v are written into ``cache_k`` / ``cache_v`` in place (no copy of the
    cache per step).  Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.long)
    pos_b = pos_b.expand(B) if pos_b.dim() == 0 else pos_b
    if use_rope:
        q = rope(q, pos_b[:, None], cfg.rope_theta)
        k = rope(k, pos_b[:, None], cfg.rope_theta)
    qh = q.transpose(1, 2)                          # [B, H, 1, D]
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, :, pos_b] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, :, pos_b] = v[:, 0].to(cache_v.dtype)
    groups = cfg.n_heads // cfg.n_kv_heads
    Smax = cache_k.shape[2]
    scale = cfg.d_head ** -0.5
    # grouped-query einsum: the G-times-repeated KV is never materialized
    qg = (qh * scale).reshape(B, cfg.n_kv_heads, groups, cfg.d_head)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(cache_k.dtype),
                     cache_k).float()
    ids = torch.arange(Smax, device=x.device)
    mask = ids[None, :] <= pos_b[:, None]                 # [B, Smax]
    if window is not None:
        mask = mask & (ids[None, :] > pos_b[:, None] - window - 1)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    pw = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", pw.to(cache_v.dtype),
                       cache_v).float()
    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# --------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, gated=True, device=None):
    p = {"w_up": dense_param(gen, d_model, d_ff, device=device),
         "w_down": dense_param(gen, d_ff, d_model, device=device)}
    if gated:
        p["w_gate"] = dense_param(gen, d_model, d_ff, device=device)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def mlp_apply(p, x, act="silu"):
    up = x @ p["w_up"]
    if "w_gate" in p:
        gate = x @ p["w_gate"]
        h = (F.silu(gate) if act == "silu" else _gelu(gate)) * up
    else:
        h = _gelu(up) if act == "gelu" else F.silu(up)
    return h @ p["w_down"]


__all__ = ["attention_apply", "attention_decode", "attention_init",
           "chunked_attention", "layer_norm", "layer_norm_init", "mlp_apply",
           "mlp_init", "rms_norm", "rms_norm_init", "rope"]
