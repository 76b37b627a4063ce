"""The dense family completed and the MoE family, against the JAX
package: phi3-medium, command-r (``norm="ln"``), gemma3 (gelu, tied
embeddings, 5:1 local:global, d_head != d_model / n_heads), grok-1 (8
experts, top-2) and llama4-scout (16 experts, top-1, a shared expert),
each at its SMOKE size on the reference's weights
(``convert.lm_params_from_jax``): ``forward``, ``prefill`` then
``decode_step``, one ``train_step``; the ``banded`` and ``windowed``
attentions; ``moe_apply`` with and without capacity drops; the bfloat16
``compute_dtype``; ``configs/shapes.py``; MoE decode through the slot
engine.  The port runs on one torch thread.

Tolerances, each beside the largest difference measured on this CPU:

* float32 logits (forward, prefill, decode): atol = rtol = 1e-5, as
  ``tests/test_torch_models.py`` (1.2e-6); kv caches atol 3e-5.
* One ``train_step`` (AdamW, lr 1e-3): loss and grad_norm rtol 2e-6, as
  ``tests/test_torch_train.py``'s plain trajectory (7.6e-8, 2.7e-7); the
  first moments atol 5e-8 (1.0e-8, entries up to 8.7e-3); the updated
  parameters atol 1e-6 where the reference's first moment is >= 1e-6
  (1.2e-7).  Adam's first step moves a parameter by lr x g / (|g| +
  eps), about lr whatever the size of g, so where g is within a few eps
  of 0 a gradient one rounding apart moves it by a different amount
  (5.9e-5 measured): there every parameter is held within 2.2 x lr of
  the reference's, which one step of either side cannot leave.
* ``banded`` / ``windowed`` against the reference's: atol 2e-6 on
  outputs of magnitude ~1; against ``chunked_attention`` too, except
  where the reference's ``windowed`` band misses keys (ROADMAP finding
  9), which the port mirrors.
* ``moe_apply``: the routing choices, the kept masks, the buffer slots
  and the token counts bitwise; ``aux`` rtol 1e-6; outputs atol 1e-5.
  Router logits summed in two orders could flip a choice at a near tie,
  so the test also asserts that the inputs' smallest top-k margin is far
  (100x) above the logits' measured difference.
* bfloat16 ``compute_dtype`` (qwen2.5, gemma3): logits atol 2.5e-2 on
  logits of magnitude ~1 (1.2e-2 measured: one or two bfloat16 ulps).
  The reference rounds every elementwise op of gelu and silu to bfloat16
  (and their constants: sqrt(2/pi) becomes 0.796875); torch's fused
  activations round once, so ~40% of the activations are one ulp apart.
  The train step: loss rtol 1e-4 (1.1e-5), grad_norm rtol 5e-3
  (8.8e-4), the first moments within 10% of each leaf's largest entry
  (4.1%), the updated parameters atol 1e-6 where the reference's first
  moment is >= 1e-4 (3.0e-8), every parameter within 2.2 x lr; the
  masters, gradients and moments stay float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.models import decode_step as _ref_decode
from repro.models import forward as _ref_forward
from repro.models import init_params as ref_init
from repro.models import layers as ref_layers
from repro.models import prefill as _ref_prefill
from repro.optim import AdamW as RefAdamW
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_train_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes
from repro_torch.models import (count_params, decode_step, forward,
                                init_params, loss_fn, prefill)
from repro_torch.models import layers
from repro_torch.optim import AdamW
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.train import init_train_state, make_train_step

# the reference's entry points, jitted (one compile instead of op-by-op
# dispatch; the same XLA arithmetic)
ref_forward = jax.jit(_ref_forward, static_argnums=2)
ref_prefill = jax.jit(_ref_prefill, static_argnums=(2, 3))
ref_decode = jax.jit(_ref_decode, static_argnums=4)

NEW = ["phi3-medium-14b", "command-r-35b", "gemma3-12b", "grok-1-314b",
       "llama4-scout-17b-a16e"]
MOE = ["grok-1-314b", "llama4-scout-17b-a16e"]
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_LOGIT_ATOL = 2.5e-2
SEQ = 40


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_WEIGHTS: dict = {}


def lm(name, **over):
    """(reference config, port config, reference numpy weights, port
    weights) of ``name``'s SMOKE config with ``over`` applied (JAX dtypes
    for the reference, torch dtypes for the port).  The execution knobs
    do not change the weights, which are drawn once for each config."""
    r_over = {k: (getattr(jnp, str(v).split(".")[-1])
                  if isinstance(v, torch.dtype) else v)
              for k, v in over.items()}
    rc = dataclasses.replace(ref_config(name, smoke=True), **r_over)
    pc = dataclasses.replace(get_config(name, smoke=True), **over)
    key = dataclasses.replace(rc, compute_dtype=None, attention_impl="chunked",
                              moe_capacity_factor=0.0)
    if key not in _WEIGHTS:
        rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(1), rc))
        _WEIGHTS[key] = rp, convert.lm_params_from_jax(rp, pc, "cpu")
    return (rc, pc, *_WEIGHTS[key])


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32), _np(b),
                               **(kw or TOL))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_config_mirrors_reference(name):
    """Field for field (dtypes aside) at full and SMOKE size, and the
    reference's parameter count: grok-1 and llama4 count every expert."""
    from repro.models import count_params as ref_count
    for smoke in (False, True):
        a, b = ref_config(name, smoke=smoke), get_config(name, smoke=smoke)
        for f in dataclasses.fields(a):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert b.param_dtype == torch.float32 and b.compute_dtype is None
        assert count_params(b) == ref_count(a)
    p = init_params(0, get_config(name, smoke=True), device="cpu")
    assert sum(x.numel() for x in p.parameters()) == count_params(
        get_config(name, smoke=True))
    assert len(ARCHS) == 10


# ---------------------------------------------------------------------------
# float32 parity: forward, prefill + decode, one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_forward_matches_reference(name):
    rc, pc, rp, pp = lm(name)
    toks = _tokens(rc, 2, SEQ, 3)
    want, want_aux = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, aux = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    assert got.shape == (2, SEQ, rc.vocab)
    _close(want, got)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert (float(aux) > 0) == (name in MOE)


@pytest.mark.parametrize("name", NEW)
def test_prefill_then_decode_matches_reference(name):
    """Prefill 30 tokens, then 3 decode steps with per-slot positions (the
    second slot 7 behind), against the reference's; the first slot's
    decode logits also against the reference's forward over the same
    tokens."""
    rc, pc, rp, pp = lm(name)
    toks = _tokens(rc, 2, 33, 4)
    fwd, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    want, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :30])},
                               rc, 48)
    with torch.inference_mode():
        got, pcache = prefill(pp, {"tokens": torch.from_numpy(
            toks[:, :30]).long()}, pc, 48)
        _close(want, got)
        _close(fwd[:, 29], got)
        assert len(pcache) == pc.n_layers
        pat = len(pc.block_pattern)
        for i, layer in enumerate(pcache):
            ref = rcache["scan"][i % pat]["k"][i // pat]
            _close(ref, layer["k"], atol=3e-5, rtol=1e-5)
        pos = np.array([30, 23], np.int32)
        for step in range(3):
            nxt = toks[:, 30 + step]
            want, rcache = ref_decode(rp, rcache, jnp.asarray(nxt),
                                      jnp.asarray(pos), rc)
            got, pcache = decode_step(pp, pcache, torch.from_numpy(
                nxt).long(), torch.from_numpy(pos), pc)
            _close(want, got)
            _close(fwd[0, 30 + step], got[0])
            pos = pos + 1


def _train_step_both(name, steps=1, **over):
    rc, pc, rp, _ = lm(name, **over)
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro_torch.data import SyntheticLM
    rds = RefSyntheticLM(vocab=rc.vocab, seq=32, global_batch=4, seed=0)
    pds = SyntheticLM(vocab=pc.vocab, seq=32, global_batch=4, seed=0)
    ref_opt = RefAdamW(lr=LR)
    rs = ref_init_state(jax.tree.map(jnp.asarray, rp), ref_opt)
    ref_step = jax.jit(ref_make_train_step(rc, ref_opt))
    opt = AdamW(lr=LR)
    ps = init_train_state(convert.lm_params_from_jax(rp, pc, "cpu"), opt)
    step = make_train_step(pc, opt)
    out = []
    for i in range(steps):
        rs, rm = ref_step(rs, rds.batch_at(i))
        ps, pm = step(ps, pds.batch_at(i, "cpu"))
        out.append(({k: float(v) for k, v in rm.items()},
                    {k: float(v) for k, v in pm.items()}))
    return pc, rs, ps, out


LR = 1e-3


def _assert_state_close(pc, rs, ps, m_atol, m_floor):
    """The first moments within ``m_atol`` (a float, or a fraction of
    each leaf's largest entry when given as ("rel", x)); the parameters
    atol 1e-6 where the reference's first moment is >= ``m_floor``, and
    within 2.2 x LR everywhere."""
    want = jax.tree_util.tree_flatten_with_path(rs.params)[0]
    got = jax.tree.leaves(convert.lm_tree_to_jax_layout(ps.params, pc))
    want_m = jax.tree.leaves(rs.opt.m)
    got_m = jax.tree.leaves(convert.lm_tree_to_jax_layout(ps.opt.m, pc))
    assert len(want) == len(got) == len(want_m) == len(got_m)
    for (path, a), b, ma, mb in zip(want, got, want_m, got_m):
        a, ma = np.asarray(a, np.float32), np.asarray(ma)
        msg = jax.tree_util.keystr(path)
        tol = (m_atol[1] * np.abs(ma).max() if isinstance(m_atol, tuple)
               else m_atol)
        np.testing.assert_allclose(ma, mb, atol=tol, rtol=0, err_msg=msg)
        sel = np.abs(ma) >= m_floor
        np.testing.assert_allclose(a[sel], b[sel], atol=1e-6, rtol=0,
                                   err_msg=msg)
        np.testing.assert_allclose(a, b, atol=2.2 * LR, rtol=0, err_msg=msg)


@pytest.mark.parametrize("name", NEW)
def test_train_step_matches_reference(name):
    pc, rs, ps, [(rm, pm)] = _train_step_both(name)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-6)
    np.testing.assert_allclose(pm["grad_norm"], rm["grad_norm"], rtol=2e-6)
    _assert_state_close(pc, rs, ps, m_atol=5e-8, m_floor=1e-6)


# ---------------------------------------------------------------------------
# banded and windowed attention
# ---------------------------------------------------------------------------


def _qkv(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


# (S, block, window, causal): the window smaller and larger than the
# block, a ragged last block, a band wider than S, no window, not causal
ATTN_CASES = [(80, 16, 8, True), (80, 16, 40, True), (75, 16, 20, True),
              (48, 32, 100, True), (75, 16, None, True),
              (75, 16, 20, False), (30, 64, 8, True)]


@pytest.mark.parametrize("S,block,window,causal", ATTN_CASES)
def test_banded_and_windowed_match_reference(S, block, window, causal):
    q, k, v = _qkv(2, 4, 2, S, 16, S + block)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.jit(lambda a, b, c: ref_layers.banded_attention(
        a, b, c, causal=causal, window=window, block=block))(jq, jk, jv)
    got = layers.banded_attention(tq, tk, tv, causal=causal, window=window,
                                  block=block)
    _close(want, got, atol=2e-6, rtol=0)
    if window is not None and causal:
        want = jax.jit(lambda a, b, c: ref_layers.windowed_attention(
            a, b, c, window=window, block=block))(jq, jk, jv)
        got = layers.windowed_attention(tq, tk, tv, window=window,
                                        block=block)
        _close(want, got, atol=2e-6, rtol=0)
        # the same attention as chunked_attention's, unless the band is
        # capped at S below window + block while the last q block is
        # ragged: then both packages miss the first keys (finding 9)
        b = min(block, S)
        band = min(S, -(-(window + b) // b) * b)
        exact = S % b == 0 or band >= window + b
        chunked = np.asarray(ref_layers.chunked_attention(
            jq, jk, jv, causal=True, window=window))
        assert np.allclose(chunked, _np(got), atol=2e-6, rtol=0) == exact


@pytest.mark.parametrize("impl", ["banded", "windowed"])
def test_attention_impls_route_as_reference(impl):
    """gemma3's SMOKE stack (window 16, local and global layers) with each
    impl: the reference's routing (``"windowed"`` without a window is
    chunked) and the same logits; bfloat16 inputs come back bfloat16."""
    rc, pc, rp, pp = lm("gemma3-12b")
    rc, pc = (dataclasses.replace(c, attention_impl=impl) for c in (rc, pc))
    toks = _tokens(rc, 2, SEQ, 5)
    want, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, _ = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(want, got)
    q = torch.zeros(1, 2, 8, 4, dtype=torch.bfloat16)
    assert layers.banded_attention(q, q, q, causal=True, window=2,
                                   block=4).dtype == torch.bfloat16
    assert layers.windowed_attention(q, q, q, window=2,
                                     block=4).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _ref_routing(p, x, top_k, cf):
    """The reference's routing, replayed with its own ops: choices, and
    per example the expert-sorted tokens, kept mask and slots."""
    E = p["w_up"].shape[0]
    B, S, _ = x.shape
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), -1)
    _, choices = jax.lax.top_k(probs, top_k)
    C = layers.moe_capacity(S, top_k, E, cf)
    metas = []
    for ce in np.asarray(choices):
        flat_e = jnp.asarray(ce.reshape(-1))
        order = jnp.argsort(flat_e)
        e_s = flat_e[order]
        rank = jnp.arange(S * top_k) - jnp.searchsorted(
            e_s, jnp.arange(E))[e_s]
        keep = rank < C
        metas.append((np.repeat(np.arange(S), top_k)[np.asarray(order)],
                      np.asarray(keep),
                      np.asarray(e_s * C + jnp.minimum(rank, C - 1))))
    return np.asarray(probs), np.asarray(choices), metas


@pytest.mark.parametrize("name,cf", [("grok-1-314b", 0.0),
                                     ("grok-1-314b", 1.25),
                                     ("llama4-scout-17b-a16e", 0.0),
                                     ("llama4-scout-17b-a16e", 1.25)])
def test_moe_apply_matches_reference(name, cf):
    """Layer 0's MoE on [3, 64, d] inputs: dropless (cf 0) and at the full
    configs' 1.25, where drops occur (asserted)."""
    rc, pc, rp, pp = lm(name)
    p_ref = jax.tree.map(lambda a: a[0], rp["stack"]["scan"][0]["ffn"])
    p = pp.stack[0].ffn
    # a shared offset skews every token toward the same experts, so the
    # full configs' capacity drops tokens
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 64, rc.d_model))
         + rng.standard_normal(rc.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda p_, x_: ref_layers.moe_apply(
        p_, x_, top_k=rc.top_k, capacity_factor=cf, act=rc.act))(
            p_ref, jnp.asarray(x))
    probs_r, choices_r, metas = _ref_routing(p_ref, jnp.asarray(x),
                                             rc.top_k, cf)
    with torch.inference_mode():
        tx = torch.from_numpy(x)
        got, aux = layers.moe_apply(p, tx, top_k=pc.top_k,
                                    capacity_factor=cf, act=pc.act)
        probs, choices, _, (t_s, _, keep, slot) = layers.moe_route(
            p, tx, pc.top_k, cf)
        logits = (tx @ p["router"]).numpy()
    # a flip at a near tie would not pass unseen: every decision's margin
    # (k-th against (k+1)-th router logit) is far above the logits' gap
    d_logit = np.abs(np.asarray(jnp.asarray(x) @ p_ref["router"])
                     - logits).max()
    srt = -np.sort(-logits, axis=-1)
    margin = (srt[..., rc.top_k - 1] - srt[..., rc.top_k]).min()
    assert margin > 100 * d_logit, (margin, d_logit)
    np.testing.assert_array_equal(choices.numpy(), choices_r)
    for b, (t_r, keep_r, slot_r) in enumerate(metas):
        np.testing.assert_array_equal(t_s[b].numpy(), t_r)
        np.testing.assert_array_equal(keep[b].numpy(), keep_r)
        np.testing.assert_array_equal(slot[b].numpy(), slot_r)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf > 0), dropped
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    _close(want, got)
    _close(probs_r, probs, atol=1e-6, rtol=0)


def test_moe_decode_never_drops_and_serves_as_reference():
    """One token a slot can never drop (C >= 8 >= top_k), so MoE decode
    through the slot engine needs nothing new: grok-1 SMOKE at the full
    configs' capacity factor 1.25 serves the reference engine's tokens
    and stats; its routing of a 4-slot decode batch keeps every entry."""
    rc, pc, rp, pp = lm("grok-1-314b", moe_capacity_factor=1.25)
    x = torch.randn(4, 1, pc.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with torch.inference_mode():
        _, _, C, (_, _, keep, _) = layers.moe_route(
            pp.stack[0].ffn, x, pc.top_k, pc.moe_capacity_factor)
    assert C == 8 and bool(keep.all())
    specs = [(i, np.arange(5 + 3 * i) % pc.vocab, 6) for i in range(5)]
    ref_eng = RefEngine(jax.tree.map(jnp.asarray, rp), rc,
                        RefServeConfig(batch_slots=3, max_len=64))
    eng = ServingEngine(pp, pc, ServeConfig(batch_slots=3, max_len=64))
    want = ref_eng.run([RefRequest(rid=r, prompt=p, max_new=m)
                        for r, p, m in specs])
    with torch.inference_mode():
        got = eng.run([Request(rid=r, prompt=p, max_new=m)
                       for r, p, m in specs])
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert eng.stats() == ref_eng.stats()


# ---------------------------------------------------------------------------
# bfloat16 compute_dtype (and param_dtype)
# ---------------------------------------------------------------------------


# a stack with an unrolled tail layer (one ("attn", "local") repeat, then
# one "attn"): the tail's 1-D norm scales and qkv biases stay float32
# (finding 10), and its bias promotes the residual stream to float32
TAIL = {"n_layers": 3, "block_pattern": ("attn", "local"), "window": 8}


@pytest.mark.parametrize("name,over", [("qwen2.5-14b", {}),
                                       ("gemma3-12b", {}),
                                       ("qwen2.5-14b", TAIL)],
                         ids=["qwen2.5-14b", "gemma3-12b", "qwen-tail"])
def test_bf16_forward_matches_reference(name, over):
    rc, pc, rp, pp = lm(name, compute_dtype=torch.bfloat16, **over)
    toks = _tokens(rc, 2, SEQ, 3)
    want, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, _ = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    assert got.dtype == (torch.float32 if over else torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in pp.parameters())
    _close(want, got, atol=BF16_LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "gemma3-12b"])
def test_bf16_train_step_matches_reference(name):
    """Gradients and AdamW moments stay float32 on float32 masters."""
    pc, rs, ps, [(rm, pm)] = _train_step_both(
        name, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-4)
    np.testing.assert_allclose(pm["grad_norm"], rm["grad_norm"], rtol=5e-3)
    assert all(p.dtype == torch.float32 for p in ps.params.parameters())
    assert all(m.dtype == torch.float32 for m in ps.opt.m.values())
    _assert_state_close(pc, rs, ps, m_atol=("rel", 0.1), m_floor=1e-4)


def test_bf16_serving_params_match_reference():
    """The reference's serving pairing (launch/build.py): param_dtype and
    compute_dtype bfloat16 with a bfloat16 cache; prefill, then decode
    against the reference's (scores summed in float32 over the bfloat16
    cache, as its preferred_element_type)."""
    rc, pc, rp, pp = lm("gemma3-12b", compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    assert pp.embed.dtype == torch.bfloat16
    toks = _tokens(rc, 2, 24, 6)
    from repro.models import init_cache as ref_init_cache
    from repro_torch.models import init_cache
    _, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :20])}, rc, 32)
    rcache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rcache)
    assert jax.tree.structure(rcache) == jax.tree.structure(
        ref_init_cache(rc, 2, 32, jnp.bfloat16))
    with torch.inference_mode():
        _, pcache = prefill(pp, {"tokens": torch.from_numpy(
            toks[:, :20]).long()}, pc, 32)
        pcache = [{k: v.to(torch.bfloat16) for k, v in c.items()}
                  for c in pcache]
        assert init_cache(pc, 2, 32, torch.bfloat16, "cpu")[0]["k"].dtype \
            == torch.bfloat16
        pos = np.array([20, 20], np.int32)
        for step in range(3):
            nxt = toks[:, 20 + step]
            want, rcache = ref_decode(rp, rcache, jnp.asarray(nxt),
                                      jnp.asarray(pos), rc)
            got, pcache = decode_step(pp, pcache, torch.from_numpy(
                nxt).long(), torch.from_numpy(pos), pc)
            assert got.dtype == torch.bfloat16
            _close(want, got, atol=BF16_LOGIT_ATOL, rtol=0)
            pos = pos + 1
    # the loss of a bfloat16-parameter model is a float32 scalar
    loss = loss_fn(pp, {"tokens": torch.from_numpy(toks).long(),
                        "labels": torch.from_numpy(toks).long()}, pc)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------


def _ported_names():
    """The dense and MoE architectures (the other families' caches:
    tests/test_torch_lm_encdec_vlm.py)."""
    from repro_torch.configs import ALIASES
    return [n for n in ALIASES
            if get_config(n).family in ("dense", "moe")]


@pytest.mark.parametrize("smoke_scale", [False, True])
def test_shapes_match_reference(smoke_scale):
    """input_specs, cache_specs and cell_supported for every ported arch
    x cell: the reference's shapes and dtypes, on the meta device."""
    names = _ported_names()
    assert len(names) == 6
    for name in names:
        rc, pc = ref_config(name), get_config(name)
        for cell in ref_shapes.SHAPES:
            assert shapes.cell_supported(pc, cell) == \
                ref_shapes.cell_supported(rc, cell)
            want = ref_shapes.input_specs(rc, cell, smoke_scale=smoke_scale)
            got = shapes.input_specs(pc, cell, smoke_scale=smoke_scale)
            flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
            flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
            assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
            for (_, a), (_, b) in zip(flat_w, flat_g):
                assert b.device.type == "meta"
                assert tuple(a.shape) == tuple(b.shape)
                assert str(a.dtype) == str(b.dtype).split(".")[-1]
            if ref_shapes.SHAPES[cell]["kind"] != "decode":
                continue
            for rdt, pdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                want = ref_shapes.cache_specs(rc, cell, dtype=rdt,
                                              smoke_scale=smoke_scale)
                got = shapes.cache_specs(pc, cell, dtype=pdt,
                                         smoke_scale=smoke_scale)
                pat = len(pc.block_pattern)
                assert len(got) == pc.n_layers
                for i, layer in enumerate(got):
                    for kv in ("k", "v"):
                        a = want["scan"][i % pat][kv]
                        assert layer[kv].device.type == "meta"
                        assert tuple(layer[kv].shape) == a.shape[1:]
                        assert layer[kv].dtype == pdt and a.dtype == rdt


# ---------------------------------------------------------------------------
# the training CLI takes the new names
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "llama4-scout-17b-a16e"])
def test_train_cli_takes_the_new_archs(arch, capsys):
    from repro_torch.launch import train
    train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "[train] done at step 2" in out
