"""Public model API: config, init, forward, prefill/decode, for the dense
family.

Counterpart of ``repro/models/model.py``.  :class:`ModelConfig` has every
field of the reference's (dtypes are torch dtypes), so a reference config
carries over unchanged.  Parameters are an :class:`LMParams` module; the
functions take it as the reference's take its parameter pytree.  Families
other than ``"dense"`` (MoE, hybrid, SSM, enc-dec, VLM), learned absolute
positions (whisper's), ``compute_dtype`` and the training loss are not
ported and raise ``NotImplementedError``.

Entry points run on the CUDA device unless given ``device=...``
(:func:`repro_torch.core.engine.resolve_device`); run them under
``torch.inference_mode()`` (:class:`repro_torch.serving.ServingEngine`
does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.engine import resolve_device
from . import transformer as tf
from .layers import layer_norm, layer_norm_init, rms_norm, rms_norm_init


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)
    window: Optional[int] = None      # local-attention window
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25  # 0 -> dropless (C = S * top_k)
    qkv_bias: bool = False
    norm: str = "rms"                 # rms | ln
    act: str = "silu"
    gated_mlp: bool = True
    use_rope: bool = True
    rope_theta: float = 1e4
    learned_pos: int = 0              # >0: learned absolute positions
    tie_embeddings: bool = False
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0
    dec_max: int = 0
    # vlm (llava)
    n_patches: int = 0
    # hybrid (recurrentgemma)
    d_rnn: int = 0
    # execution knobs
    attention_impl: str = "chunked"   # chunked | pallas (the flash kernel)
    assoc_scan: bool = False
    remat: bool = True                # training only; unused here
    param_dtype: Any = torch.float32
    compute_dtype: Any = None
    subquadratic: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(1, self.n_heads))

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can run ``cfg``."""
    if cfg.family != "dense" or cfg.is_encdec or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported (dense only)")
    if cfg.compute_dtype is not None or cfg.learned_pos:
        raise NotImplementedError("compute_dtype and learned positions are "
                                  "not ported")
    tf.check_supported(cfg)


class LMParams(nn.Module):
    """The parameters of a dense LM: ``embed [vocab, d]``, ``lm_head
    [d, vocab]`` (None when tied to ``embed``), ``final_norm`` and
    ``stack``, an ``nn.ModuleList`` of
    :class:`repro_torch.models.transformer.Block`."""

    def __init__(self, embed, lm_head, final_norm: dict,
                 stack: nn.ModuleList):
        super().__init__()
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.embed = frozen(embed)
        self.lm_head = None if lm_head is None else frozen(lm_head)
        self.final_norm = tf._pdict(final_norm)
        self.stack = stack


def init_params(seed: int, cfg: ModelConfig, device=None) -> LMParams:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: embeddings normal x 0.02 in ``cfg.param_dtype``,
    weights normal / sqrt(fan-in), biases 0, norm scales 1 (the
    reference's init; its JAX streams are not reproduced)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.param_dtype

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(0.02)
    embed = normal((cfg.vocab, cfg.d_model))
    lm_head = None if cfg.tie_embeddings else normal((cfg.d_model, cfg.vocab))
    ninit = rms_norm_init if cfg.norm == "rms" else layer_norm_init
    stack = tf.stack_init(gen, cfg, device)
    return LMParams(embed, lm_head, ninit(cfg.d_model, device), stack)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of ``cfg``'s dense model, from shapes alone."""
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.d_head
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    if cfg.qkv_bias:
        attn += hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    norm = d if cfg.norm == "rms" else 2 * d
    per_layer = attn + mlp + 2 * norm
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    return cfg.vocab * d + head + norm + cfg.n_layers * per_layer


def _final(params: LMParams, x, cfg):
    x = (rms_norm if cfg.norm == "rms" else layer_norm)(params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def forward(params: LMParams, batch, cfg: ModelConfig):
    """Returns (logits [B, S, vocab], aux_loss)."""
    check_supported(cfg)
    x = params.embed[batch["tokens"]]
    x, aux = tf.stack_apply(params.stack, x, cfg, causal=True)
    return _final(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, device=None):
    """A zero kv cache: a list of ``{"k", "v"}`` ``[B, Hkv, max_len, D]``
    per layer."""
    check_supported(cfg)
    return tf.stack_cache_init(cfg, batch_size, max_len, dtype,
                               resolve_device(device))


def prefill(params: LMParams, batch, cfg: ModelConfig, max_len: int):
    """Returns (last-token logits [B, vocab], cache padded to max_len)."""
    check_supported(cfg)
    x = params.embed[batch["tokens"]]
    x, cache = tf.stack_prefill(params.stack, x, cfg, max_len, causal=True)
    return _final(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params: LMParams, cache, tokens, pos, cfg: ModelConfig):
    """tokens: [B] int; pos: int or per-slot [B] write positions.  The
    cache is updated in place.  Returns (logits [B, vocab], cache)."""
    check_supported(cfg)
    x = params.embed[tokens][:, None]                # [B, 1, d]
    x, cache = tf.stack_decode(params.stack, cache, x, cfg, pos)
    return _final(params, x, cfg)[:, 0], cache


__all__ = ["LMParams", "ModelConfig", "check_supported", "count_params",
           "decode_step", "forward", "init_cache", "init_params", "prefill"]
