"""Shared transformer layers: norms, RoPE, GQA attention, gated MLP,
sort-based MoE.

Counterpart of ``repro/models/layers.py``.  Parameters are mappings of
tensors with the reference's keys (``wq``, ``bq``, ``w_up``, ``router``,
...), weights stored ``[in, out]`` (experts ``[E, in, out]``) as there.

Attention implementations (``cfg.attention_impl``, the reference's values):

* ``"chunked"``  -- online softmax over kv chunks in plain PyTorch (the
  reference's ``lax.scan`` becomes a loop), O(S * chunk) memory;
* ``"banded"``   -- a static loop over q blocks, each against its causal
  kv prefix or window band only (half the FLOPs of ``"chunked"``);
* ``"windowed"`` -- sliding-window attention as a loop over q blocks, each
  against a kv band of static size ``window + block``; without a window
  or without ``causal`` it is ``"chunked"``, as in the reference;
* ``"pallas"``   -- the flash attention kernel: on a CUDA device the port's
  hand-written CUDA kernel (:mod:`repro_torch.kernels.flash_attention`),
  on the CPU its plain version.  The name is the reference's, so its
  configs carry over unchanged.

Mixed dtypes (``compute_dtype``): ``torch.matmul`` refuses operands of two
dtypes where ``jnp.matmul`` promotes them, so the products go through
:func:`_mm` / :func:`_einsum`, which promote as JAX does.  The reference's
``shard_act`` (:mod:`repro_torch.parallel.act`) returns its input
unchanged in the port, whose ranks hold whole activations, so the layers
do not call it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import hlo
from .param import bias_param, dense_param, expert_param, scale_param


def _promoted(a, b):
    """``a``, ``b`` converted to their promoted dtype where they differ
    (a bfloat16 activation against a float32 weight gives float32, as in
    JAX)."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(a, b):
    """``a @ b`` with JAX's promotion of mixed operand dtypes."""
    a, b = _promoted(a, b)
    return a @ b


def _einsum(eq, a, b):
    a, b = _promoted(a, b)
    return torch.einsum(eq, a, b)


_RECOMPUTING = contextvars.ContextVar("scan_chunk_recomputing",
                                      default=False)


@contextlib.contextmanager
def _recomputation():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def _chunk_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing for the
    forward pass, :func:`recomputing` true for the recomputation."""
    return contextlib.nullcontext(), _recomputation()


def recomputing() -> bool:
    """Whether a checkpointed chunk of :func:`scan_in_chunks` is being
    recomputed for its backward pass: a step may then skip a result that
    nothing in the backward reads, as XLA drops it from the reference's
    rematerialized chunk."""
    return _RECOMPUTING.get()


def _loop(step, n_xs, state, *args):
    """``step`` over the leading (time) axis of ``args[:n_xs]``, the rest
    passed to every step; returns (state, the outputs stacked)."""
    xs, consts = args[:n_xs], args[n_xs:]
    ys = []
    for x_t in zip(*(x.unbind(0) for x in xs)):
        state, y = step(state, *x_t, *consts)
        ys.append(y)
    return state, torch.stack(ys)


def scan_in_chunks(step, state, xs, remat=True, chunk=64, consts=()):
    """``step(state, *x_t, *consts) -> (state, y_t)`` over the leading
    (time) axis of the tensors ``xs``, for the recurrent blocks' scans.
    Under grad with ``remat``, each run of ``chunk`` steps goes through
    ``torch.utils.checkpoint``: the backward pass keeps one state a chunk
    and recomputes the steps inside, as the reference's ``lax.scan`` of a
    ``jax.checkpoint``-ed chunk step does.  Returns (state, the y_t
    stacked over time).

    Counted on the ``meta`` device (:func:`repro_torch.launch.hlo.count`)
    the step runs once under ``hlo.repeat(T)`` (:class:`_CountedScan`
    under grad)."""
    T = xs[0].shape[0]
    remat = remat and torch.is_grad_enabled()
    if T > 1 and hlo.repeating(xs[0]):
        if torch.is_grad_enabled() and (state.requires_grad or any(
                x.requires_grad for x in xs)):
            sizes = ([min(chunk, T - t0) for t0 in range(0, T, chunk)]
                     if remat else None)
            return _CountedScan.apply(step, sizes, len(xs), state, *xs,
                                      *consts)
        with hlo.repeat(T, "scan"):
            state, y = step(state, *(x[0] for x in xs), *consts)
        with hlo.hold((T - 1) * hlo.tensor_bytes(y)):
            return state, torch.stack([y] * T)
    if not remat:
        return _loop(step, len(xs), state, *xs, *consts)
    parts = []
    for x_c in zip(*(x.split(chunk) for x in xs)):
        state, ys = checkpoint(_loop, step, len(xs), state, *x_c, *consts,
                               use_reentrant=False,
                               context_fn=_chunk_contexts)
        parts.append(ys)
    return state, torch.cat(parts)


class _CountedScan(torch.autograd.Function):
    """:func:`scan_in_chunks` under grad, counted on ``meta``: one step
    stands for all T, forward and backward each under ``hlo.repeat(T)``.
    With ``sizes`` (remat: the chunks' lengths) the forward keeps no graph
    and the backward recomputes it first, as the checkpointed chunks do;
    the stacks and concatenations are the loop's.  The other T - 1 steps'
    retained bytes (outputs, and what the graph saves) are held as live
    while the graph of one chunk (or of the whole scan) would be.  A
    constant's gradient sums the T steps' (T - 1 adds)."""

    @staticmethod
    def _step(step, state, xs, consts, graph):
        T = xs[0].shape[0]
        live0 = hlo.active().live
        with torch.enable_grad() if graph else torch.no_grad():
            s_in = state.detach().requires_grad_(graph)
            x_in = [t.detach().requires_grad_(graph and t.requires_grad)
                    for t in [x[0] for x in xs] + list(consts)]
            with hlo.repeat(T, "scan"):
                s_out, y = step(s_in, *x_in)
        # without a graph a step keeps its output; the state goes on
        kept = (hlo.active().live - live0 if graph
                else hlo.tensor_bytes(y))
        return (s_in, x_in, s_out, y), kept

    @staticmethod
    def forward(ctx, step, sizes, n_xs, state, *args):
        ctx.set_materialize_grads(False)
        xs, consts = args[:n_xs], args[n_xs:]
        T = xs[0].shape[0]
        ctx.step, ctx.sizes, ctx.n_xs = step, sizes, n_xs
        ctx.save_for_backward(state, *args)
        graph, kept = _CountedScan._step(step, state, xs, consts,
                                         sizes is None)
        ctx.graph = graph if sizes is None else None
        ctx.held = (T - 1) * kept
        hlo.active().hold(ctx.held)
        y = graph[3].detach()
        ys = (torch.stack([y] * T) if sizes is None else
              torch.cat([torch.stack([y] * c) for c in sizes]))
        return graph[2].detach(), ys

    @staticmethod
    def backward(ctx, g_state, g_ys):
        state, *args = ctx.saved_tensors
        xs, consts = args[:ctx.n_xs], args[ctx.n_xs:]
        T, sizes, counter = xs[0].shape[0], ctx.sizes, hlo.active()
        counter.hold(-ctx.held)
        held = 0
        if sizes is None:
            s_in, x_in, s_out, y = ctx.graph
            held = ctx.held
        else:
            with _recomputation():
                (s_in, x_in, s_out, y), kept = _CountedScan._step(
                    ctx.step, state, xs, consts, True)
            held = (max(sizes) - 1) * kept
            # checkpoint's recomputation stops early: a chunk's stack, and
            # its last step's last op (the state update, which only saves
            # its inputs), are not run again
            flops, nbytes = counter.last_op
            k = len(sizes)
            counter.uncount(k * flops, k * nbytes, k)
        g_y = torch.empty_like(y) if g_ys is None else g_ys[0]
        # a step's state gradient comes from the next step; the scan's
        # last step has none when the final state is unused, and its first
        # computes none when the initial state needs none
        g_s = torch.empty_like(s_out) if g_state is None else g_state
        n_last = int(g_state is None)
        n_first = int(not state.requires_grad)
        x_want = [x for x in x_in if x.requires_grad]
        calls = {"steps": (T - n_first - n_last, True, [s_out, y],
                           [g_s, g_y]),
                 "first": (n_first, False, [s_out, y], [g_s, g_y]),
                 "last": (n_last, True, [y], [g_y])}
        calls = {k: c for k, c in calls.items() if c[0] > 0}
        got = {}
        with hlo.hold(held):
            for i, (name, (n, want_s, outs, gouts)) in enumerate(
                    calls.items()):
                with hlo.repeat(n, "scan backward"):
                    g = torch.autograd.grad(
                        outs, [s_in] * want_s + x_want, gouts,
                        allow_unused=True, retain_graph=i + 1 < len(calls))
                got[name] = g if want_s else (None, *g)
        ctx.graph = None
        grads = next(iter(got.values()))
        g_args, j = [], 0
        for i, xi in enumerate(x_in):
            j += xi.requires_grad
            g = grads[j] if xi.requires_grad else None
            if g is not None and i < ctx.n_xs:
                gs = [g] * T
                if "last" in got and got["last"][j] is None:
                    # the last step has none: autograd stacks an expanded
                    # zero in its place
                    gs[-1] = torch.zeros((), dtype=g.dtype,
                                         device=g.device).expand(g.shape)
                g = (torch.stack(gs) if sizes is None else torch.cat(
                    [torch.stack(gs[t0:t0 + c]) for t0, c in zip(
                        itertools.accumulate([0] + sizes[:-1]), sizes)]))
            elif g is not None:
                with hlo.repeat(T - 1, "scan constant's gradient"):
                    g + g
            g_args.append(g)
        g_state_in = grads[0] if state.requires_grad else None
        return (None, None, None, g_state_in, *g_args)


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


def rope_angles(positions, d, theta=1e4):
    """RoPE's rotation at ``positions`` ``[..., S]`` for a head width
    ``d``: ``(cos, sin)``, each ``[..., S, 1, d // 2]``.  Computed once, it
    rotates q and k alike (:func:`rope_rotate`; the reference's ``rope``
    computes it for each)."""
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs            # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_rotate(x, cos, sin):
    """x: [..., S, n_heads, d_head] rotated by :func:`rope_angles`."""
    half = x.shape[-1] // 2
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
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
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


def windowed_attention(q, k, v, *, window, block=1024):
    """Causal sliding-window attention as a loop over q blocks, each
    attending to a kv band of static size ``band`` (``window + block``
    rounded up to whole blocks, at most S) that ends with its q block:
    exact-window FLOPs.  q: [B,H,S,D], k/v: [B,Hkv,S,D].

    The reference's band is kept as it is: when S is not a multiple of
    ``block`` and the band is capped at S below ``window + block``, the
    last (padded) q block's band starts ``pad_q`` keys late, and those
    keys are missed there, in both packages."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    block = min(block, S)
    pad_q = (-S) % block
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    nq = (S + pad_q) // block
    band = min(S, ((window + block + block - 1) // block) * block)
    # pad kv front (band) and back (q padding) so every slice is in range
    k = F.pad(k, (0, 0, band, pad_q))
    v = F.pad(v, (0, 0, band, pad_q))
    scale = D ** -0.5
    ar_q = torch.arange(block, device=q.device)[:, None]
    ar_k = torch.arange(band, device=q.device)[None, :]
    outs = []
    for i in range(nq):
        q0 = i * block
        k0 = q0 + block                 # band ends at q-block end (+pad)
        kb = k[:, :, k0:k0 + band].float()
        vb = v[:, :, k0:k0 + band].float()
        qg = (q[:, :, q0:q0 + block].float() * scale).reshape(
            B, Hkv, G, block, D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        q_ids = q0 + ar_q
        k_ids = (q0 + block - band) + ar_k
        mask = ((k_ids <= q_ids) & (k_ids > q_ids - window - 1)
                & (k_ids >= 0) & (k_ids < S))
        s = torch.where(mask, s, -1e30)
        p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        outs.append(o.reshape(B, H, block, D))
    return torch.cat(outs, dim=2)[:, :, :S].to(q.dtype)


def banded_attention(q, k, v, *, causal, window, block=1024):
    """Causal-prefix q-block loop: q block i only touches kv[: (i+1)*block]
    (or its window band) -- S^2/2 FLOPs instead of S^2."""
    S = q.shape[2]
    block = min(block, S)
    outs = []
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        k0 = max(0, q0 - window) if window is not None else 0
        k1 = q1 if causal else S
        outs.append(chunked_attention(
            q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1], causal=causal,
            window=window, chunk=block, q_offset=q0 - k0))
    return torch.cat(outs, dim=2)


def attention_apply(p, x, cfg, *, causal=True, window=None, positions=None,
                    impl="chunked", use_rope=True):
    """Full-sequence (prefill) attention.  Returns (out, (k, v)) with k, v
    ``[B, Hkv, S, D]``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    qh = q.transpose(1, 2)      # [B, H, S, D]
    kh = k.transpose(1, 2)      # [B, Hkv, S, D] -- never GQA-expanded
    vh = v.transpose(1, 2)
    if impl == "chunked":
        out = chunked_attention(qh, kh, vh, causal=causal, window=window)
    elif impl == "windowed" and window is not None and causal:
        out = windowed_attention(qh, kh, vh, window=window)
    elif impl == "windowed":
        out = chunked_attention(qh, kh, vh, causal=causal, window=window)
    elif impl == "banded":
        out = banded_attention(qh, kh, vh, causal=causal, window=window)
    elif impl == "pallas":
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(qh, kh, vh, causal=causal, window=window)
    else:
        raise ValueError(impl)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return _mm(out, p["wo"]), (kh, vh)


def attention_decode(p, x, cache_k, cache_v, pos, cfg, *, window=None,
                     use_rope=True):
    """One-token decode.  x: [B, 1, d]; cache_k/v: [B, Hkv, Smax, D];
    pos: int or per-slot [B] positions (continuous batching).

    Unlike the reference, which returns updated copies, the token's k and
    v are written into ``cache_k`` / ``cache_v`` in place (no copy of the
    cache per step).  The reference's scatter drops the write of a slot
    whose position is past the cache, and so does this one: the write
    goes to the clamped position and keeps the value there (the slot then
    attends over the whole cache, unchanged, as the reference's does).
    RoPE's angles are computed once for q and k, which pays for the
    drop's launches.  Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.long)
    pos_b = pos_b.expand(B) if pos_b.dim() == 0 else pos_b
    if use_rope:
        cos, sin = rope_angles(pos_b[:, None], cfg.d_head, cfg.rope_theta)
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    qh = q.transpose(1, 2)                          # [B, H, 1, D]
    bidx = torch.arange(B, device=x.device)
    Smax = cache_k.shape[2]
    pos_w = pos_b.clamp(max=Smax - 1)
    keep = (pos_b < Smax)[:, None, None]
    cache_k[bidx, :, pos_w] = torch.where(keep, k[:, 0].to(cache_k.dtype),
                                          cache_k[bidx, :, pos_w])
    cache_v[bidx, :, pos_w] = torch.where(keep, v[:, 0].to(cache_v.dtype),
                                          cache_v[bidx, :, pos_w])
    groups = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.d_head ** -0.5
    # grouped-query einsum: the G-times-repeated KV is never materialized;
    # operands in the cache's dtype, products and sums in float32 (the
    # reference's preferred_element_type)
    qg = (qh * scale).reshape(B, cfg.n_kv_heads, groups, cfg.d_head)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(cache_k.dtype).float(),
                     cache_k.float())
    ids = torch.arange(Smax, device=x.device)
    mask = ids[None, :] <= pos_b[:, None]                 # [B, Smax]
    if window is not None:
        mask = mask & (ids[None, :] > pos_b[:, None] - window - 1)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    pw = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", pw.to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * cfg.d_head)
    return _mm(out, p["wo"]), cache_k, cache_v


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
    up = _mm(x, p["w_up"])
    if "w_gate" in p:
        gate = _mm(x, p["w_gate"])
        h = (F.silu(gate) if act == "silu" else _gelu(gate)) * up
    else:
        h = _gelu(up) if act == "gelu" else F.silu(up)
    return _mm(h, p["w_down"])


# --------------------------------------------------------------------------
# MoE (sort-based dispatch, capacity-bounded -- Switch/MegaBlocks style)
# --------------------------------------------------------------------------


def moe_init(gen, d_model, d_ff, n_experts, gated=True, shared_expert=False,
             device=None):
    """The router ``[d, E]`` (normal / sqrt(d)), the experts' ``w_up``,
    ``w_down`` (and ``w_gate``) ``[E, in, out]`` (normal / sqrt(d_model),
    as the reference scales all three) and, with ``shared_expert``, a
    ``shared`` MLP."""
    p = {"router": dense_param(gen, d_model, n_experts, device=device),
         "w_up": expert_param(gen, n_experts, d_model, d_ff, d_model,
                              device),
         "w_down": expert_param(gen, n_experts, d_ff, d_model, d_model,
                                device)}
    if gated:
        p["w_gate"] = expert_param(gen, n_experts, d_model, d_ff, d_model,
                                   device)
    if shared_expert:
        p["shared"] = mlp_init(gen, d_model, d_ff, gated=gated,
                               device=device)
    return p


def stable_top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties broken toward the lower index (a stable
    descending sort; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(S, top_k, n_experts, capacity_factor) -> int:
    """Slots per expert and example: ``int(cf * S * k / E)`` (``S * k``,
    dropless, when ``cf <= 0``) rounded up to a multiple of 8, >= 8."""
    if capacity_factor <= 0:
        C = S * top_k
    else:
        C = int(capacity_factor * S * top_k / n_experts)
    return max(8, ((C + 7) // 8) * 8)


def moe_route(p, x, k, capacity_factor):
    """The routing of :func:`moe_apply`.  Returns (probs [B,S,E] float32,
    choices [B,S,k], C, route), route being the per-example expert-sorted
    entries ``(t_s, g_s, keep, slot)``, each [B, S*k]: token, float32
    gate, kept under capacity, buffer slot."""
    B, S, _ = x.shape
    E = p["w_up"].shape[0]
    logits = _mm(x, p["router"])                          # [B, S, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, choices = stable_top_k(probs, k)            # [B, S, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = moe_capacity(S, k, E, capacity_factor)
    flat_e = choices.reshape(B, S * k)
    flat_t = torch.arange(S, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_s = torch.gather(flat_e, 1, order)
    t_s = flat_t[order]
    g_s = torch.gather(gate_vals.reshape(B, S * k), 1, order)
    idx = torch.arange(S * k, device=x.device)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    first = torch.searchsorted(e_s, experts)               # left side
    rank = idx - torch.gather(first, 1, e_s)
    keep = rank < C
    slot = e_s * C + rank.clamp_max(C - 1)
    return probs, choices, C, (t_s, g_s, keep, slot)


def moe_dispatch(x, route, n_experts, C):
    """x [B, S, d] into the [B, E, C, d] expert buffers: each kept entry
    of ``route`` (``moe_route``'s dispatch tuple) at its slot, a dropped
    one as zeros into slot ``E*C-1``."""
    B, S, d = x.shape
    t_s, _, keep, slot = route
    E = n_experts
    rows = (torch.arange(B, device=x.device) * (E * C))[:, None]
    tgt = torch.where(keep, slot, E * C - 1) + rows        # [B, S*k]
    src = torch.gather(x, 1, t_s[..., None].expand(*t_s.shape, d))
    src = torch.where(keep[..., None], src, 0.0)
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, tgt.reshape(-1), src.reshape(-1, d))
    return buf.reshape(B, E, C, d)


def moe_combine(eo, route, S):
    """The expert outputs ``eo`` [B, E*C, d] back onto the S tokens: each
    kept entry's slot times its gate, summed per token."""
    B, _, d = eo.shape
    t_s, g_s, keep, slot = route
    eo_g = torch.gather(eo, 1, slot[..., None].expand(*slot.shape, d))
    contrib = torch.where(keep[..., None],
                          eo_g * g_s[..., None].to(eo.dtype), 0.0)
    tok = t_s + (torch.arange(B, device=eo.device) * S)[:, None]
    out = torch.zeros((B * S, d), dtype=eo.dtype, device=eo.device)
    out.index_add_(0, tok.reshape(-1), contrib.reshape(-1, d))
    return out.reshape(B, S, d)


def moe_apply(p, x, *, top_k, capacity_factor=1.25, act="gelu"):
    """x: [B, S, d].  Per-example sort-based dispatch into [B, E, C, d]
    expert buffers (group-limited capacity, group = one example row), as
    the reference's.  ``capacity_factor <= 0`` selects dropless dispatch
    (C = S * top_k).  A dropped entry scatters zeros into slot ``E*C-1``.

    Every kept slot receives exactly one token (plus exact zeros) and each
    token at most ``top_k`` gated terms, so with ``top_k <= 2`` both
    ``index_add_`` scatters give the same bits in any order of addition.

    Returns (out, aux_loss), aux the Switch load-balance loss
    ``E * sum_e mean_prob_e * routed_fraction_e``."""
    B, S, d = x.shape
    E = p["w_up"].shape[0]
    probs, choices, C, route = moe_route(p, x, top_k, capacity_factor)
    buf = moe_dispatch(x, route, E, C)

    up = _einsum("becd,edf->becf", buf, p["w_up"])
    if "w_gate" in p:
        gate = _einsum("becd,edf->becf", buf, p["w_gate"])
        h = (_gelu(gate) if act == "gelu" else F.silu(gate)) * up
    else:
        h = _gelu(up)
    eo = _einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, d)
    out = moe_combine(eo, route, S)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x.reshape(B * S, d),
                              act=act).reshape(B, S, d)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean((0, 1))                               # [E]
    fe = torch.zeros(E, device=x.device).index_add_(
        0, choices.reshape(-1), torch.ones(B * S * top_k, device=x.device)
    ) / (B * S * top_k)
    aux = E * torch.sum(me * fe)
    return out, aux


__all__ = ["attention_apply", "attention_decode", "attention_init",
           "banded_attention", "chunked_attention", "layer_norm",
           "layer_norm_init", "mlp_apply", "mlp_init", "moe_apply",
           "moe_capacity", "moe_combine", "moe_dispatch", "moe_init",
           "moe_route", "rms_norm",
           "recomputing", "rms_norm_init", "rope", "scan_in_chunks",
           "stable_top_k", "windowed_attention"]
