"""Public model API: config, init, forward, loss, prefill/decode, for all
ten architectures: dense, MoE, hybrid (RG-LRU), SSM (RWKV-6), enc-dec
(whisper) and VLM (llava).

Counterpart of ``repro/models/model.py``.  :class:`ModelConfig` has every
field of the reference's (dtypes are torch dtypes), so a reference config
carries over unchanged.  Parameters are an :class:`LMParams` module of
trainable parameters; the functions take it as the reference's take its
parameter pytree.  With ``cfg.compute_dtype`` set, :func:`forward`,
:func:`prefill` and :func:`decode_step` first cast the parameters to it
as the reference does (:func:`cast_for_compute`), so a training step
differentiates through the cast into float32 masters.

The enc-dec family takes ``batch["frames"]`` ``[B, enc_seq, d]`` (the
stub of whisper's conv front end) beside the tokens, and raises
``KeyError`` without it, as the reference does; the VLM family takes
optional ``batch["patches"]`` ``[B, n_patches, d]``, which go before the
tokens.  A whisper decode step at ``pos >= dec_max`` gives NaN logits and
writes nothing into the cache, as the reference's (ROADMAP finding 12).

Entry points run on the CUDA device unless given ``device=...``
(:func:`repro_torch.core.engine.resolve_device`).  Serve under
``torch.inference_mode()`` (:class:`repro_torch.serving.ServingEngine`
does): with grad enabled a forward pass records an autograd graph, and
the flash kernel (``attention_impl="pallas"``) refuses to run, since it
has no backward.  :func:`loss_fn` is what :mod:`repro_torch.train`
differentiates.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from . import rglru as rg
from . import rwkv6 as rw
from . import transformer as tf
from .layers import (_mm, attention_apply, attention_decode,
                     attention_init, layer_norm, layer_norm_init, mlp_apply,
                     mlp_init, rms_norm, rms_norm_init)


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
    attention_impl: str = "chunked"   # chunked | banded | windowed | pallas
    assoc_scan: bool = False
    remat: bool = True                # recompute each repeat in backward
    param_dtype: Any = torch.float32
    compute_dtype: Any = None         # e.g. torch.bfloat16: cast >=2D params
                                      # for compute
    subquadratic: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(1, self.n_heads))

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0


def _norm(cfg):
    return rms_norm if cfg.norm == "rms" else layer_norm


# --------------------------------------------------------------------------
# Whisper-style enc-dec decoder block (self-attn + cross-attn + mlp)
# --------------------------------------------------------------------------


class EncDecBlock(nn.Module):
    """One decoder layer of the enc-dec family: ``norm1``, ``self``
    (causal self-attention), ``norm2``, ``cross`` (attention over the
    encoder's output), ``norm3`` and ``ffn`` (a gelu MLP), each a
    ``ParameterDict`` with the reference's keys."""

    NAMES = ("norm1", "norm2", "norm3", "self", "cross", "ffn")

    def __init__(self, params: dict):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, tf._pdict(params[name]))


def _encdec_block_init(gen, cfg, device=None) -> EncDecBlock:
    ninit = rms_norm_init if cfg.norm == "rms" else layer_norm_init

    def attn():
        return attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head, device=device)
    p = {"norm1": ninit(cfg.d_model, device),
         "norm2": ninit(cfg.d_model, device),
         "norm3": ninit(cfg.d_model, device)}
    p["self"] = attn()
    p["cross"] = attn()
    p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                        device=device)
    return EncDecBlock(p)


def _cross_kv(p, enc_out, cfg):
    """The encoder output's cross-attention k, v: [B, Hkv, Se, D] each."""
    B, Se, _ = enc_out.shape
    k = _mm(enc_out, p["wk"]).reshape(B, Se, cfg.n_kv_heads, cfg.d_head)
    v = _mm(enc_out, p["wv"]).reshape(B, Se, cfg.n_kv_heads, cfg.d_head)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_attend(p, x, ck, cv, cfg):
    """x: [B, Sq, d]; ck/cv: [B, Hkv, Se, D] precomputed encoder kv.  A
    plain float32 softmax over every key (q scaled before the product),
    cast back to x's dtype, as the reference's einsum."""
    B, Sq, _ = x.shape
    q = _mm(x, p["wq"]).reshape(B, Sq, cfg.n_heads, cfg.d_head)
    if "bq" in p:
        q = q + p["bq"].reshape(cfg.n_heads, cfg.d_head)
    qh = q.transpose(1, 2)
    groups = cfg.n_heads // cfg.n_kv_heads
    kx = ck.repeat_interleave(groups, dim=1) if groups > 1 else ck
    vx = cv.repeat_interleave(groups, dim=1) if groups > 1 else cv
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float() * cfg.d_head ** -0.5,
                     kx.float())
    pw = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", pw, vx.float())
    o = o.to(x.dtype).transpose(1, 2).reshape(B, Sq,
                                               cfg.n_heads * cfg.d_head)
    return _mm(o, p["wo"])


def _encdec_block_apply(blk, x, enc_kv, cfg, *, pos=None, cache=None,
                        max_len=None):
    """Full sequence (pos None) or one decode token (pos given, the self
    kv cache updated in place).  With ``max_len`` the full-sequence path
    also returns the padded self-attention kv cache."""
    norm = _norm(cfg)
    h = norm(blk.norm1, x)
    if pos is None:
        m, (kh, vh) = attention_apply(blk.self, h, cfg, causal=True,
                                      impl=cfg.attention_impl,
                                      use_rope=cfg.use_rope)
        if max_len is not None:
            cache = {"k": tf._pad_kv(kh, max_len),
                     "v": tf._pad_kv(vh, max_len)}
    else:
        m, ck, cv = attention_decode(blk.self, h, cache["k"], cache["v"],
                                     pos, cfg, use_rope=cfg.use_rope)
        cache = dict(cache, k=ck, v=cv)
    x = x + m
    h = norm(blk.norm2, x)
    x = x + _cross_attend(blk.cross, h, enc_kv[0], enc_kv[1], cfg)
    h = norm(blk.norm3, x)
    x = x + mlp_apply(blk.ffn, h, act="gelu")
    return x, cache


class LMParams(nn.Module):
    """The parameters of an LM: ``embed [vocab, d]``, ``lm_head
    [d, vocab]`` (None when tied to ``embed``), ``final_norm``, and
    either ``stack``, an ``nn.ModuleList`` of
    :class:`repro_torch.models.transformer.Block` (with ``pos``, learned
    absolute positions, where ``cfg.learned_pos`` is set), or for the
    enc-dec family ``enc_pos [enc_seq, d]``, ``dec_pos [dec_max, d]``,
    ``encoder`` (blocks of kind ``"attn"``, run non-causal), ``decoder``
    (:class:`EncDecBlock`) and ``enc_norm``.  Every tensor is a trainable
    ``nn.Parameter``; ``named_parameters()`` names them (``embed``,
    ``stack.0.mixer.wq``, ``decoder.1.cross.wk``, ...), and those names
    key the gradients and optimizer moments of :mod:`repro_torch.train`."""

    def __init__(self, embed, lm_head, final_norm: dict,
                 stack: nn.ModuleList | None = None, *, pos=None,
                 enc_pos=None, dec_pos=None,
                 encoder: nn.ModuleList | None = None,
                 decoder: nn.ModuleList | None = None,
                 enc_norm: dict | None = None):
        super().__init__()
        opt = lambda t: None if t is None else nn.Parameter(t)  # noqa: E731
        self.embed = nn.Parameter(embed)
        self.lm_head = opt(lm_head)
        self.final_norm = tf._pdict(final_norm)
        self.stack = stack
        self.pos = opt(pos)
        self.enc_pos, self.dec_pos = opt(enc_pos), opt(dec_pos)
        self.encoder, self.decoder = encoder, decoder
        self.enc_norm = None if enc_norm is None else tf._pdict(enc_norm)


def init_params(seed: int, cfg: ModelConfig, device=None) -> LMParams:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: embeddings and positions normal x 0.02 in
    ``cfg.param_dtype``, weights normal / sqrt(fan-in) (experts / sqrt(
    d_model)), biases 0, norm scales 1, and the recurrent blocks'
    deterministic leaves as the reference's (RG-LRU's ``lam``, RWKV's
    ``mu_*`` 0.5, ``w0`` -6, ``u`` 0).  The reference's JAX streams are
    not reproduced."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init(gen, cfg, device)


def _init(gen, cfg: ModelConfig, device) -> LMParams:
    dt = cfg.param_dtype

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(0.02)
    embed = normal((cfg.vocab, cfg.d_model))
    lm_head = None if cfg.tie_embeddings else normal((cfg.d_model, cfg.vocab))
    ninit = rms_norm_init if cfg.norm == "rms" else layer_norm_init
    if cfg.is_encdec:
        enc_pos = normal((cfg.enc_seq, cfg.d_model))
        dec_pos = normal((cfg.dec_max, cfg.d_model))
        encoder = nn.ModuleList(tf.block_init(gen, "attn", cfg, device)
                                for _ in range(cfg.n_enc_layers))
        decoder = nn.ModuleList(_encdec_block_init(gen, cfg, device)
                                for _ in range(cfg.n_layers))
        return LMParams(embed, lm_head, ninit(cfg.d_model, device),
                        enc_pos=enc_pos, dec_pos=dec_pos, encoder=encoder,
                        decoder=decoder, enc_norm=ninit(cfg.d_model, device))
    stack = tf.stack_init(gen, cfg, device)
    pos = normal((cfg.learned_pos, cfg.d_model)) if cfg.learned_pos else None
    return LMParams(embed, lm_head, ninit(cfg.d_model, device), stack,
                    pos=pos)


# --------------------------------------------------------------------------
# sharding metadata: logical axes and abstract values
# --------------------------------------------------------------------------

# The logical axes of each leaf, as the reference's init functions name
# them (repro/models/{layers,rglru,rwkv6}.py), by the dict that holds it.
_NORM = {"scale": ("embed",), "bias": ("embed",)}
_ATTN = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
         "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
_MLP = {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
        "w_down": ("mlp", "embed")}
_MOE = {"router": ("embed", None), "w_up": ("experts", "embed", "mlp"),
        "w_gate": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"), "shared": _MLP}
_RGLRU = {"w_x": ("embed", "mlp"), "w_y": ("embed", "mlp"),
          "conv": (None, "mlp"), "w_r": ("mlp", None), "w_i": ("mlp", None),
          "lam": ("mlp",), "w_o": ("mlp", "embed")}
_LORA = {"a": ("embed", None), "b": (None, "embed")}
_TIMEMIX = {**{f"mu_{k}": ("embed",) for k in ("base", "w", "k", "v", "r",
                                                "g")},
            "lora_mix": _LORA, "lora_w": _LORA, "w0": ("embed",),
            "u": ("embed",), "ln_scale": ("embed",),
            **{k: ("embed", "heads") for k in ("w_r", "w_k", "w_v", "w_g")},
            "w_o": ("heads", "embed")}
_CHANMIX = {"mu_k": ("embed",), "mu_r": ("embed",), "w_k": ("embed", "mlp"),
            "w_v": ("mlp", "embed"), "w_r": ("embed", None)}
_TOP = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
        "pos": (None, "embed"), "enc_pos": (None, "embed"),
        "dec_pos": (None, "embed"), "final_norm": _NORM, "enc_norm": _NORM}


def _block_tables(blk) -> dict:
    """The tables of a block's parameter dicts, by the block's kind and
    feed-forward (an MoE holds a router)."""
    if isinstance(blk, EncDecBlock):
        return {"norm1": _NORM, "norm2": _NORM, "norm3": _NORM,
                "self": _ATTN, "cross": _ATTN, "ffn": _MLP}
    mixer = {"attn": _ATTN, "local": _ATTN, "rglru": _RGLRU,
             "rwkv": _TIMEMIX}[blk.kind]
    ffn = (_MOE if "router" in blk.ffn else
           _CHANMIX if blk.kind == "rwkv" else _MLP)
    return {"norm1": _NORM, "norm2": _NORM, "mixer": mixer, "ffn": ffn}


def module_param_axes(params: LMParams) -> dict:
    """``named_parameters()`` name -> logical axes of ``params``.  The
    reference stacks scanned layers on a leading ``"layers"`` axis (rule
    ``("layers", None)``: never sharded); the port's layers are modules of
    their own, so each leaf has the rest of the reference's tuple."""
    out = {}
    for name, t in params.named_parameters():
        path = name.split(".")
        if path[0] in ("stack", "encoder", "decoder"):
            blk = getattr(params, path[0])[int(path[1])]
            table, path = _block_tables(blk), path[2:]
        else:
            table = _TOP
        for part in path:
            table = table[part]
        if len(table) != t.dim():
            raise ValueError(f"{name}: axes {table} for shape "
                             f"{tuple(t.shape)}")
        out[name] = table
    return out


def _abstract_module(cfg: ModelConfig) -> LMParams:
    """The parameters of ``cfg`` on the ``meta`` device: shapes and
    dtypes, no storage (a full-size config costs no memory)."""
    return _init(None, cfg, torch.device("meta"))


def param_axes(cfg: ModelConfig) -> dict:
    return module_param_axes(_abstract_module(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """``named_parameters()`` name -> meta tensor of ``cfg``."""
    return {k: t.detach() for k, t in
            _abstract_module(cfg).named_parameters()}


def param_specs(cfg: ModelConfig):
    """(abstract values, logical axes), each keyed by parameter name."""
    m = _abstract_module(cfg)
    return ({k: t.detach() for k, t in m.named_parameters()},
            module_param_axes(m))


def _block_count(kind, cfg) -> int:
    d, hd = cfg.d_model, cfg.d_head
    norm = d if cfg.norm == "rms" else 2 * d
    if kind in ("attn", "local"):
        mixer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        if cfg.qkv_bias:
            mixer += hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
    elif kind == "rglru":
        mixer = rg.rglru_param_count(d, cfg.d_rnn)
    else:
        mixer = rw.timemix_param_count(d)
    if cfg.n_experts > 0:
        ffn = d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.d_ff
        ffn += 3 * d * cfg.d_ff if cfg.shared_expert else 0
    elif kind == "rwkv":
        ffn = rw.chanmix_param_count(d, cfg.d_ff)
    else:
        ffn = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    return mixer + ffn + 2 * norm


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of ``cfg``'s model, from shapes alone (an MoE
    feed-forward: the router, every expert's three matrices and the
    shared expert)."""
    d = cfg.d_model
    norm = d if cfg.norm == "rms" else 2 * d
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    n = cfg.vocab * d + head + norm
    if cfg.is_encdec:
        attn = d * cfg.d_head * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        dec = 3 * norm + 2 * attn + 2 * d * cfg.d_ff
        return (n + (cfg.enc_seq + cfg.dec_max) * d + norm
                + cfg.n_enc_layers * _block_count("attn", cfg)
                + cfg.n_layers * dec)
    n += sum(_block_count(k, cfg) for k in tf.layer_kinds(cfg))
    return n + cfg.learned_pos * d


def cast_for_compute(params: LMParams, cfg: ModelConfig):
    """The parameters as the model computes with them: with
    ``cfg.compute_dtype`` set, a view of ``params`` (the same attributes
    and keys) whose tensors of two or more dimensions are cast to it;
    ``params`` itself otherwise.  The casts are autograd ops: gradients
    reach the float32 masters.

    The reference casts the leaves of its parameter tree that have two or
    more dimensions, and the layers of its scanned pattern repeats, and
    whisper's encoder and decoder, are stacked there on a leading layer
    axis: their 1-D leaves (norm scales and biases, qkv biases, RG-LRU's
    ``lam``, RWKV's ``mu_*``, ``w0``, ``u`` and ``ln_scale``) are 2-D
    there and cast too.  Only ``final_norm``, ``enc_norm`` and the
    unrolled tail layers' (``n_layers % len(block_pattern)``) 1-D tensors
    stay float32.  So here too (ROADMAP finding 10)."""
    cd = cfg.compute_dtype
    if cd is None:
        return params

    def tree(p, min_dim):
        return {k: tree(v, min_dim) if isinstance(v, nn.ParameterDict)
                else (v.to(cd) if v.dim() >= min_dim else v)
                for k, v in p.items()}

    def block(blk, min_dim):
        return SimpleNamespace(kind=getattr(blk, "kind", None), **{
            n: tree(m, min_dim) for n, m in blk.named_children()})

    def cast(t):
        return None if t is None else t.to(cd)
    view = SimpleNamespace(
        embed=params.embed.to(cd), lm_head=cast(params.lm_head),
        final_norm=tree(params.final_norm, 2), pos=cast(params.pos),
        enc_pos=cast(params.enc_pos), dec_pos=cast(params.dec_pos),
        stack=None, encoder=None, decoder=None, enc_norm=None)
    if cfg.is_encdec:
        view.encoder = [block(b, 1) for b in params.encoder]
        view.decoder = [block(b, 1) for b in params.decoder]
        view.enc_norm = tree(params.enc_norm, 2)
    else:
        pat = len(cfg.block_pattern)
        n_scan = cfg.n_layers // pat * pat
        view.stack = [block(b, 1 if i < n_scan else 2)
                      for i, b in enumerate(params.stack)]
    return view


def _final(params: LMParams, x, cfg):
    x = _norm(cfg)(params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return _mm(x, head)


def _take_rows(table, pos, B):
    """``table[pos]`` for int or per-slot [B] positions, NaN rows where a
    position is past the table, as ``jnp.take``'s default fill."""
    pos_b = torch.as_tensor(pos, device=table.device).long().expand(B)
    n = table.shape[0]
    rows = table[pos_b.clamp(max=n - 1)]
    return torch.where((pos_b < n)[:, None], rows, float("nan"))


def _embed_inputs(params, batch, cfg):
    """Token (+ patch stub) embedding: [B, S, d], the patches (cast to
    x's dtype) before the tokens; learned positions for a model that is
    not enc-dec."""
    x = params.embed[batch["tokens"]]
    if cfg.n_patches and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if cfg.learned_pos and params.pos is not None and not cfg.is_encdec:
        x = x + params.pos[:x.shape[1]]
    return x


def _layers(fn, blocks, x, remat):
    """x through ``fn(block, x)`` for each block, each recomputed in the
    backward pass when ``remat`` and grad is enabled."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        x = checkpoint(fn, blk, x, use_reentrant=False) if remat \
            else fn(blk, x)
    return x


def _encode(params, frames, cfg, remat=False):
    """Whisper's encoder over ``frames`` cast to ``cfg.param_dtype`` plus
    ``enc_pos``: non-causal attention blocks, then ``enc_norm``."""
    enc = frames.to(cfg.param_dtype) + params.enc_pos[None]
    enc = _layers(lambda blk, h: tf.block_apply(
        blk, h, cfg, causal=False, impl=cfg.attention_impl)[0],
        params.encoder, enc, remat)
    return _norm(cfg)(params.enc_norm, enc)


def forward(params: LMParams, batch, cfg: ModelConfig):
    """Returns (logits [B, S, vocab], aux_loss)."""
    params = cast_for_compute(params, cfg)
    if cfg.is_encdec:
        enc = _encode(params, batch["frames"], cfg, cfg.remat)
        x = params.embed[batch["tokens"]]
        x = x + params.dec_pos[:x.shape[1]][None]
        x = _layers(lambda blk, h: _encdec_block_apply(
            blk, h, _cross_kv(blk.cross, enc, cfg), cfg)[0],
            params.decoder, x, cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x = _embed_inputs(params, batch, cfg)
        x, aux = tf.stack_apply(params.stack, x, cfg, causal=True)
    return _final(params, x, cfg), aux


def loss_fn(params: LMParams, batch, cfg: ModelConfig, aux_weight=0.01):
    """Next-token cross entropy (+ MoE aux) of ``batch["tokens"]`` against
    ``batch["labels"]`` ([B, S]; labels < 0 carry no loss): the mean over
    the labelled positions of float32 ``logsumexp`` minus the gold logit,
    plus ``aux_weight * aux``.  Patch positions carry no loss.  A 0-d
    float32 tensor."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"].long()
    if cfg.n_patches and "patches" in batch:
        logits = logits[:, cfg.n_patches:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # a masked label may be negative: gather at 0 there, then mask it out
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    return nll + aux_weight * aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, device=None):
    """A zero decode cache: a list of one dict per layer
    (:func:`repro_torch.models.transformer.block_cache_init`); for the
    enc-dec family ``{"self": [...], "cross": [...]}``, one ``{"k", "v"}``
    per decoder layer each, ``[B, Hkv, dec_max, D]`` and ``[B, Hkv,
    enc_seq, D]`` (``max_len`` is not used)."""
    device = resolve_device(device)
    if cfg.is_encdec:
        def kv(S):
            shape = (batch_size, cfg.n_kv_heads, S, cfg.d_head)
            return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
                    for _ in range(cfg.n_layers)]
        return {"self": kv(cfg.dec_max), "cross": kv(cfg.enc_seq)}
    return tf.stack_cache_init(cfg, batch_size, max_len, dtype, device)


def prefill(params: LMParams, batch, cfg: ModelConfig, max_len: int):
    """Returns (last-token logits [B, vocab], cache padded to max_len; for
    the enc-dec family the self cache is padded to ``cfg.dec_max``
    whatever ``max_len``, and the cross cache holds the encoder's kv)."""
    params = cast_for_compute(params, cfg)
    if cfg.is_encdec:
        enc = _encode(params, batch["frames"], cfg)
        x = params.embed[batch["tokens"]]
        x = x + params.dec_pos[:x.shape[1]][None]
        cache = {"self": [], "cross": []}
        for blk in params.decoder:
            kv = _cross_kv(blk.cross, enc, cfg)
            x, sc = _encdec_block_apply(blk, x, kv, cfg, max_len=cfg.dec_max)
            cache["self"].append(sc)
            cache["cross"].append({"k": kv[0], "v": kv[1]})
    else:
        x = _embed_inputs(params, batch, cfg)
        x, cache = tf.stack_prefill(params.stack, x, cfg, max_len,
                                    causal=True)
    return _final(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params: LMParams, cache, tokens, pos, cfg: ModelConfig):
    """tokens: [B] int; pos: int or per-slot [B] write positions.  The kv
    caches are updated in place.  Returns (logits [B, vocab], cache)."""
    params = cast_for_compute(params, cfg)
    B = tokens.shape[0]
    x = params.embed[tokens][:, None]                # [B, 1, d]
    if cfg.is_encdec:
        x = x + _take_rows(params.dec_pos, pos, B)[:, None]
        new_self = []
        for blk, sc, cc in zip(params.decoder, cache["self"], cache["cross"]):
            x, sc = _encdec_block_apply(blk, x, (cc["k"], cc["v"]), cfg,
                                        pos=pos, cache=sc)
            new_self.append(sc)
        cache = {"self": new_self, "cross": cache["cross"]}
    else:
        if cfg.learned_pos and params.pos is not None:
            x = x + _take_rows(params.pos, pos, B)[:, None]
        x, cache = tf.stack_decode(params.stack, cache, x, cfg, pos)
    return _final(params, x, cfg)[:, 0], cache


__all__ = ["EncDecBlock", "LMParams", "ModelConfig", "abstract_params",
           "cast_for_compute", "count_params", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "module_param_axes",
           "param_axes", "param_specs", "prefill"]
