"""Block assembly: the dense stack as an ``nn.ModuleList`` of blocks.

Counterpart of ``repro/models/transformer.py`` for blocks of kind
``"attn"`` and ``"local"`` (sliding window).  The reference stacks the
parameters of each position of ``cfg.block_pattern`` on a leading layer
axis and runs a ``lax.scan`` over the repeats, plus an unrolled tail;
here every layer is its own :class:`Block` and a Python loop walks them in
the same order (layer ``i`` has kind ``pattern[i % len(pattern)]``).
Recurrent (``rglru``, ``rwkv``) blocks and MoE feed-forwards are not
ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (attention_apply, attention_decode, attention_init,
                     layer_norm, layer_norm_init, mlp_apply, mlp_init,
                     rms_norm, rms_norm_init)

KINDS = ("attn", "local")


def _pdict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One pre-norm residual block: ``norm1``, ``mixer`` (attention),
    ``norm2``, ``ffn`` (MLP), each a ``ParameterDict`` with the
    reference's keys."""

    def __init__(self, kind: str, params: dict):
        super().__init__()
        if kind not in KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported")
        self.kind = kind
        for name in ("norm1", "norm2", "mixer", "ffn"):
            setattr(self, name, _pdict(params[name]))


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the dense port cannot
    run."""
    if any(k not in KINDS for k in cfg.block_pattern):
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern} holds unported kinds "
            f"(ported: {KINDS})")
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE feed-forwards are not ported")


def block_init(gen, kind, cfg, device=None) -> Block:
    norm_init = rms_norm_init if cfg.norm == "rms" else layer_norm_init
    return Block(kind, {
        "norm1": norm_init(cfg.d_model, device),
        "norm2": norm_init(cfg.d_model, device),
        "mixer": attention_init(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias,
                                device),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                        device=device)})


def _norm(cfg):
    return rms_norm if cfg.norm == "rms" else layer_norm


def _pad_kv(kv, max_len):
    """[B, Hkv, S, D] -> [B, Hkv, max_len, D]."""
    S = kv.shape[2]
    return kv if S == max_len else F.pad(kv, (0, 0, 0, max_len - S))


def block_apply(blk: Block, x, cfg, *, causal=True, impl=None, max_len=None):
    """Full-sequence apply.  Returns (x, cache, aux_loss).

    ``max_len`` (prefill): also build the block's decode cache, padded to
    ``max_len``.  None: the cache is None."""
    norm = _norm(cfg)
    impl = impl or cfg.attention_impl
    win = cfg.window if blk.kind == "local" else None
    h = norm(blk.norm1, x)
    m, (kh, vh) = attention_apply(blk.mixer, h, cfg, causal=causal,
                                  window=win, impl=impl, use_rope=cfg.use_rope)
    cache = None
    if max_len is not None:
        cache = {"k": _pad_kv(kh, max_len), "v": _pad_kv(vh, max_len)}
    x = x + m
    h = norm(blk.norm2, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_apply(blk.ffn, h, act=cfg.act), cache, aux


def block_decode(blk: Block, x, cfg, cache, pos):
    """One-token apply; the block's kv cache is updated in place."""
    norm = _norm(cfg)
    win = cfg.window if blk.kind == "local" else None
    h = norm(blk.norm1, x)
    m, ck, cv = attention_decode(blk.mixer, h, cache["k"], cache["v"], pos,
                                 cfg, window=win, use_rope=cfg.use_rope)
    x = x + m
    h = norm(blk.norm2, x)
    return x + mlp_apply(blk.ffn, h, act=cfg.act), {"k": ck, "v": cv}


def block_cache_init(kind, cfg, batch, max_len, dtype=torch.float32,
                     device=None):
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def layer_kinds(cfg) -> list[str]:
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def stack_init(gen, cfg, device=None) -> nn.ModuleList:
    check_supported(cfg)
    return nn.ModuleList(block_init(gen, kind, cfg, device)
                         for kind in layer_kinds(cfg))


def stack_apply(stack: nn.ModuleList, x, cfg, *, causal=True, impl=None):
    """Full-sequence forward through the stack.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in stack:
        x, _, a = block_apply(blk, x, cfg, causal=causal, impl=impl)
        aux = aux + a
    return x, aux


def stack_prefill(stack: nn.ModuleList, x, cfg, max_len, *, causal=True,
                  impl=None):
    """Prefill: forward + per-layer decode caches.  Returns (x, caches),
    caches a list of ``{"k", "v"}`` per layer."""
    caches = []
    for blk in stack:
        x, ck, _ = block_apply(blk, x, cfg, causal=causal, impl=impl,
                               max_len=max_len)
        caches.append(ck)
    return x, caches


def stack_cache_init(cfg, batch, max_len, dtype=torch.float32, device=None):
    return [block_cache_init(kind, cfg, batch, max_len, dtype, device)
            for kind in layer_kinds(cfg)]


def stack_decode(stack: nn.ModuleList, caches, x, cfg, pos):
    """One-token decode through the stack.  Returns (x, caches)."""
    new = []
    for blk, cache in zip(stack, caches):
        x, ck = block_decode(blk, x, cfg, cache, pos)
        new.append(ck)
    return x, new


__all__ = ["Block", "KINDS", "block_apply", "block_cache_init",
           "block_decode", "block_init", "check_supported", "layer_kinds",
           "stack_apply", "stack_cache_init", "stack_decode", "stack_init",
           "stack_prefill"]
