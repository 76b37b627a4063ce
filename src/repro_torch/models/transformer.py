"""Block assembly: the stack as an ``nn.ModuleList`` of blocks.

Counterpart of ``repro/models/transformer.py``: blocks of kind ``"attn"``,
``"local"`` (sliding window), ``"rglru"`` (:mod:`.rglru`) and ``"rwkv"``
(:mod:`.rwkv6`, whose feed-forward is its channel mix), with an MLP or,
when ``cfg.n_experts > 0``, an MoE feed-forward.  The reference stacks the
parameters of each position of ``cfg.block_pattern`` on a leading layer
axis and runs a ``lax.scan`` over the repeats, plus an unrolled tail;
here every layer is its own :class:`Block` and a Python loop walks them in
the same order (layer ``i`` has kind ``pattern[i % len(pattern)]``).  Under
grad with ``cfg.remat``, each repeat of the pattern is recomputed in the
backward pass, as the reference's ``jax.checkpoint`` of its scan body.
The MoE load-balance loss of every block is summed into ``aux`` there;
decoding discards it, as the reference does.  A block's decode cache is a
dict: ``{"k", "v"}`` for attention, ``{"h", "tail"}`` for RG-LRU and
``{"shift_t", "wkv", "shift_c"}`` for RWKV.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import rglru as rg
from . import rwkv6 as rw
from .layers import (attention_apply, attention_decode, attention_init,
                     layer_norm, layer_norm_init, mlp_apply, mlp_init,
                     moe_apply, moe_init, rms_norm, rms_norm_init)

KINDS = ("attn", "local", "rglru", "rwkv")


def _pdict(tree: dict) -> nn.ParameterDict:
    """A (nested) dict of tensors as a ``ParameterDict`` of trainable
    parameters; a nested dict (the MoE's ``shared`` MLP) becomes a nested
    ``ParameterDict``, named ``ffn.shared.w_up`` and so on."""
    return nn.ParameterDict({
        k: _pdict(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


class Block(nn.Module):
    """One pre-norm residual block: ``norm1``, ``mixer`` (attention, RG-LRU
    or RWKV time mix), ``norm2``, ``ffn`` (MLP, RWKV channel mix, or MoE:
    ``router``, ``[E, in, out]`` experts and an optional ``shared`` MLP),
    each a ``ParameterDict`` with the reference's keys (nested for the
    LoRAs and the shared expert)."""

    def __init__(self, kind: str, params: dict):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        for name in ("norm1", "norm2", "mixer", "ffn"):
            setattr(self, name, _pdict(params[name]))


def block_init(gen, kind, cfg, device=None) -> Block:
    """A block's parameters, drawn from ``gen`` mixer first, then ffn."""
    norm_init = rms_norm_init if cfg.norm == "rms" else layer_norm_init
    if kind in ("attn", "local"):
        mixer = attention_init(gen, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias,
                               device)
    elif kind == "rglru":
        mixer = rg.rglru_init(gen, cfg.d_model, cfg.d_rnn, device)
    elif kind == "rwkv":
        mixer = rw.timemix_init(gen, cfg.d_model, device)
    else:
        raise ValueError(kind)
    if cfg.n_experts > 0:
        ffn = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, gated=True,
                       shared_expert=cfg.shared_expert, device=device)
    elif kind == "rwkv":
        ffn = rw.chanmix_init(gen, cfg.d_model, cfg.d_ff, device)
    else:
        ffn = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                       device=device)
    return Block(kind, {"norm1": norm_init(cfg.d_model, device),
                        "norm2": norm_init(cfg.d_model, device),
                        "mixer": mixer, "ffn": ffn})


def _norm(cfg):
    return rms_norm if cfg.norm == "rms" else layer_norm


def _ffn(blk: Block, h, cfg):
    """The block's feed-forward: (out, aux), aux 0 for an MLP."""
    if cfg.n_experts > 0:
        return moe_apply(blk.ffn, h, top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity_factor,
                         act=cfg.act)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return mlp_apply(blk.ffn, h, act=cfg.act), aux


def _pad_kv(kv, max_len):
    """[B, Hkv, S, D] -> [B, Hkv, max_len, D]."""
    S = kv.shape[2]
    return kv if S == max_len else F.pad(kv, (0, 0, 0, max_len - S))


def block_apply(blk: Block, x, cfg, *, causal=True, impl=None, max_len=None):
    """Full-sequence apply.  Returns (x, cache, aux_loss).

    ``max_len`` (prefill): also build the block's decode cache, padded to
    ``max_len`` for the attention kinds.  None: the cache is None.  An
    RWKV block has a cache only without experts, as in the reference
    (its channel mix is the feed-forward then)."""
    norm = _norm(cfg)
    impl = impl or cfg.attention_impl
    cache = None
    h = norm(blk.norm1, x)
    if blk.kind in ("attn", "local"):
        win = cfg.window if blk.kind == "local" else None
        m, (kh, vh) = attention_apply(blk.mixer, h, cfg, causal=causal,
                                      window=win, impl=impl,
                                      use_rope=cfg.use_rope)
        if max_len is not None:
            cache = {"k": _pad_kv(kh, max_len), "v": _pad_kv(vh, max_len)}
    elif blk.kind == "rglru":
        m, (hlast, a_tail) = rg.rglru_apply(blk.mixer, h,
                                            assoc=cfg.assoc_scan,
                                            remat=cfg.remat)
        if max_len is not None:
            cache = {"h": hlast, "tail": a_tail}
    else:
        m, (shift_t, wkv) = rw.timemix_apply(blk.mixer, h, remat=cfg.remat)
    x = x + m
    h = norm(blk.norm2, x)
    if blk.kind == "rwkv" and cfg.n_experts == 0:
        f, shift_c = rw.chanmix_apply(blk.ffn, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if max_len is not None:
            cache = {"shift_t": shift_t, "wkv": wkv, "shift_c": shift_c}
    else:
        f, aux = _ffn(blk, h, cfg)
    return x + f, cache, aux


def block_decode(blk: Block, x, cfg, cache, pos):
    """One-token apply.  Returns (x, cache): an attention block's kv
    cache is updated in place, a recurrent block's state replaced."""
    norm = _norm(cfg)
    h = norm(blk.norm1, x)
    if blk.kind in ("attn", "local"):
        win = cfg.window if blk.kind == "local" else None
        m, ck, cv = attention_decode(blk.mixer, h, cache["k"], cache["v"],
                                     pos, cfg, window=win,
                                     use_rope=cfg.use_rope)
        cache = {"k": ck, "v": cv}
    elif blk.kind == "rglru":
        m, (hh, tail) = rg.rglru_decode(blk.mixer, h,
                                        (cache["h"], cache["tail"]))
        cache = {"h": hh, "tail": tail}
    else:
        m, (shift_t, wkv) = rw.timemix_apply(blk.mixer, h, cache["shift_t"],
                                             cache["wkv"])
        cache = dict(cache, shift_t=shift_t, wkv=wkv)
    x = x + m
    h = norm(blk.norm2, x)
    if blk.kind == "rwkv" and cfg.n_experts == 0:
        f, shift_c = rw.chanmix_apply(blk.ffn, h, cache["shift_c"])
        cache = dict(cache, shift_c=shift_c)
    else:
        f, _ = _ffn(blk, h, cfg)
    return x + f, cache


def block_cache_init(kind, cfg, batch, max_len, dtype=torch.float32,
                     device=None):
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    if kind in ("attn", "local"):
        shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if kind == "rglru":
        return {"h": zeros(batch, cfg.d_rnn),
                "tail": zeros(batch, rg.CONV_W - 1, cfg.d_rnn)}
    if kind == "rwkv":
        H = cfg.d_model // rw.HEAD
        return {"shift_t": zeros(batch, cfg.d_model),
                "wkv": zeros(batch, H, rw.HEAD, rw.HEAD, dt=torch.float32),
                "shift_c": zeros(batch, cfg.d_model)}
    raise ValueError(kind)


def layer_kinds(cfg) -> list[str]:
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def stack_init(gen, cfg, device=None) -> nn.ModuleList:
    return nn.ModuleList(block_init(gen, kind, cfg, device)
                         for kind in layer_kinds(cfg))


def stack_apply(stack: nn.ModuleList, x, cfg, *, causal=True, impl=None):
    """Full-sequence forward through the stack.  Returns (x, aux).

    With ``cfg.remat`` and grad enabled, each whole repeat of
    ``cfg.block_pattern`` runs under ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward pass), as the reference
    remats its scanned repeats; the unrolled tail is not rematerialized."""
    def apply(blocks, h, aux):
        for blk in blocks:
            h, _, a = block_apply(blk, h, cfg, causal=causal, impl=impl)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pat = len(cfg.block_pattern)
    n_scan = len(stack) // pat * pat
    remat = cfg.remat and torch.is_grad_enabled()
    for r0 in range(0, n_scan, pat):
        blocks = stack[r0:r0 + pat]
        if remat:
            x, aux = checkpoint(apply, blocks, x, aux, use_reentrant=False)
        else:
            x, aux = apply(blocks, x, aux)
    return apply(stack[n_scan:], x, aux)


def stack_prefill(stack: nn.ModuleList, x, cfg, max_len, *, causal=True,
                  impl=None):
    """Prefill: forward + per-layer decode caches.  Returns (x, caches),
    caches a list of one dict per layer (:func:`block_cache_init`'s
    keys)."""
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
           "block_decode", "block_init", "layer_kinds",
           "stack_apply", "stack_cache_init", "stack_decode", "stack_init",
           "stack_prefill"]
