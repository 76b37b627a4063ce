"""The recurrent families against the JAX package: recurrentgemma (RG-LRU
blocks with local attention, ``rglru, rglru, local``) and rwkv6 (RWKV-6
time and channel mix), each at its SMOKE size on the reference's weights
(``convert.lm_params_from_jax``): the layers (``rglru_apply`` sequential
and associative, ``rglru_decode``, ``_wkv_scan``, ``timemix_apply``,
``chanmix_apply``), ``forward``, ``prefill`` then three ``decode_step``s
with every cache leaf, one ``train_step``, the slot engine, remat of the
scans, and the bfloat16 ``compute_dtype``.  The port runs on one torch
thread.

Tolerances, each beside the largest difference measured on this CPU:

* float32 layer outputs and logits: atol = rtol = 1e-5, as
  ``tests/test_torch_models.py`` (layers up to 1.4e-6; logits 3.7e-6 for
  rwkv6, 2.5e-6 for recurrentgemma).  The scans run 70 steps, past one
  64-step chunk: a rounding apart in a step decays with alpha < 1
  (RG-LRU) or w < 1 (WKV).
* decode caches: RG-LRU's ``h`` and ``tail``, RWKV's ``shift_t``,
  ``shift_c`` and ``wkv`` and attention's ``k``, ``v``: atol 3e-5, rtol
  1e-5 (2.7e-5, RWKV's summed ``wkv`` state; 9.3e-6 for recurrentgemma).
* The associative scan (``cfg.assoc_scan``) is a log-depth tree in both
  packages, each grouping its products in its own order, so neither
  equals the sequential scan bitwise: each is held against its own
  reference form, outputs atol 1e-5 (1.2e-6), and the port's two forms
  against each other at the same tolerance.
* One ``train_step`` (AdamW, lr 1e-3), as
  ``tests/test_torch_lm_families.py`` holds it: loss and grad_norm rtol
  2e-6 (4.1e-7), the first moments atol 5e-8 (1.6e-8), for
  recurrentgemma.  rwkv6's gradients sum over its scan in another order
  than the reference's backward scan: the gradient of ``u``, a sum over
  every token of 64 x 64 products, carries 112.04 of the norm's 112.27
  and agrees to 5e-6 relative, so grad_norm rtol 1e-5 (3.7e-6) and the
  first moments within 1e-4 of each leaf's largest entry (1.2e-5); the
  loss is equal.
* Remat of the scans: the loss and every gradient bitwise, but RWKV's
  ``u``, whose chunks' parts sum in another order: rtol 1e-6 (1.2e-7).
* RG-LRU's deterministic ``lam``: rtol 1e-5 (3.6e-6): the port computes
  it in float64 and rounds once, the reference in float32 with XLA's own
  ``log`` / ``expm1``.  RWKV's constant leaves (``mu_*``, ``w0``, ``u``,
  ``ln_scale``) are equal.
* bfloat16 ``compute_dtype`` logits: atol 5e-2 (recurrentgemma 2.4e-2,
  rwkv6 2.8e-2).  A bfloat16 product that the two packages sum in
  another order comes out one ulp apart (RG-LRU's layer output: 2.0e-3
  on 0.31; RWKV's token-shift mixes and decays are equal), and the
  recurrences carry such flips of their inputs over 40 steps in their
  float32 states, where the dense families' 2.5e-2 (finding 11) has
  none to carry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import count_params as ref_count
from repro.models import decode_step as _ref_decode
from repro.models import forward as _ref_forward
from repro.models import init_params as ref_init
from repro.models import prefill as _ref_prefill
from repro.models import rglru as ref_rg
from repro.models import rwkv6 as ref_rw
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (count_params, decode_step, forward,
                                init_params, loss_fn, prefill)
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv6 as rw
from repro_torch.serving import Request, ServeConfig, ServingEngine

from test_torch_lm_families import _assert_state_close, _train_step_both

ref_forward = jax.jit(_ref_forward, static_argnums=2)
ref_prefill = jax.jit(_ref_prefill, static_argnums=(2, 3))
ref_decode = jax.jit(_ref_decode, static_argnums=4)

NAMES = ["recurrentgemma-2b", "rwkv6-7b"]
TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=3e-5, rtol=1e-5)
SEQ = 70                     # past one 64-step chunk of the scans
BF16_RECURRENT_ATOL = 5e-2


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
    weights) of ``name``'s SMOKE config with ``over`` applied; the
    weights are drawn once for each config."""
    r_over = {k: (getattr(jnp, str(v).split(".")[-1])
                  if isinstance(v, torch.dtype) else v)
              for k, v in over.items()}
    rc = dataclasses.replace(ref_config(name, smoke=True), **r_over)
    pc = dataclasses.replace(get_config(name, smoke=True), **over)
    if name not in _WEIGHTS:
        rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(1), rc))
        _WEIGHTS[name] = rp, convert.lm_params_from_jax(rp, pc, "cpu")
    return (rc, pc, *_WEIGHTS[name])


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32), _np(b),
                               **(kw or TOL))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _layer0(rp, pp):
    """The first layer's mixer and ffn in both layouts."""
    ref = jax.tree.map(lambda a: a[0], rp["stack"]["scan"][0])
    return ref, pp.stack[0]


# ---------------------------------------------------------------------------
# configs, counts, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_mirrors_reference(name):
    for smoke in (False, True):
        a, b = ref_config(name, smoke=smoke), get_config(name, smoke=smoke)
        for f in dataclasses.fields(a):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert count_params(b) == ref_count(a)
    pc = get_config(name, smoke=True)
    p = init_params(0, pc, device="cpu")
    assert sum(x.numel() for x in p.parameters()) == count_params(pc)


def test_deterministic_leaves_match_reference():
    """RG-LRU's lam and RWKV's constant leaves, from both inits."""
    for name in NAMES:
        rc, pc = ref_config(name, smoke=True), get_config(name, smoke=True)
        rp = ref_init(jax.random.PRNGKey(0), rc)["stack"]["scan"][0]
        pp = init_params(0, pc, device="cpu").stack[0]
        if name == "rwkv6-7b":
            for k in ("mu_base", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g",
                      "w0", "u", "ln_scale"):
                np.testing.assert_array_equal(np.asarray(rp["mixer"][k][0]),
                                              _np(pp.mixer[k]), err_msg=k)
            for k in ("mu_k", "mu_r"):
                np.testing.assert_array_equal(np.asarray(rp["ffn"][k][0]),
                                              _np(pp.ffn[k]), err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(rp["mixer"]["lam"][0]),
                                       _np(pp.mixer["lam"]), rtol=1e-5,
                                       atol=0)
    full = rg.rglru_init(torch.Generator().manual_seed(0), 8, 2560)["lam"]
    want = ref_rg.rglru_init(jax.random.PRNGKey(0), 8, 2560)["lam"].value
    np.testing.assert_allclose(np.asarray(want), _np(full), rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 5, SEQ])
@pytest.mark.parametrize("assoc", [False, True])
def test_rglru_apply_matches_reference(S, assoc):
    """Output, h_last and the conv tail (with S < 3 the tail holds the
    zero padding), from a zero and from a given state."""
    rc, pc, rp, pp = lm("recurrentgemma-2b")
    ref, blk = _layer0(rp, pp)
    x = _x(2, S, rc.d_model, S)
    h0 = _x(1, 2, rc.d_rnn, 9)[0]
    for h in (None, h0):
        fn = jax.jit(lambda p_, x_, h_: ref_rg.rglru_apply(
            p_, x_, h0=h_, assoc=assoc))
        want, (w_h, w_tail) = fn(ref["mixer"], jnp.asarray(x),
                                 None if h is None else jnp.asarray(h))
        with torch.inference_mode():
            got, (g_h, g_tail) = rg.rglru_apply(
                blk.mixer, torch.from_numpy(x),
                None if h is None else torch.from_numpy(h), assoc=assoc)
        _close(want, got)
        _close(w_h, g_h)
        _close(w_tail, g_tail)
        if S < 3:
            assert not g_tail[:, :3 - S].any()
    if assoc:
        with torch.inference_mode():
            seq, (h_seq, _) = rg.rglru_apply(blk.mixer, torch.from_numpy(x),
                                             torch.from_numpy(h0))
        _close(_np(seq), got)
        _close(_np(h_seq), g_h)


def test_rglru_decode_matches_reference():
    rc, pc, rp, pp = lm("recurrentgemma-2b")
    ref, blk = _layer0(rp, pp)
    x = _x(3, 1, rc.d_model, 1)
    h, tail = _x(1, 3, rc.d_rnn, 2)[0], _x(3, 3, rc.d_rnn, 3)
    want, (w_h, w_tail) = jax.jit(ref_rg.rglru_decode)(
        ref["mixer"], jnp.asarray(x), (jnp.asarray(h), jnp.asarray(tail)))
    with torch.inference_mode():
        got, (g_h, g_tail) = rg.rglru_decode(
            blk.mixer, torch.from_numpy(x),
            (torch.from_numpy(h), torch.from_numpy(tail)))
    _close(want, got)
    _close(w_h, g_h)
    _close(w_tail, g_tail)


def test_wkv_scan_matches_reference():
    """70 steps (a padded second chunk in the reference) from a given
    state: outputs and the final state."""
    rng = np.random.default_rng(4)
    B, S, H = 2, SEQ, 2
    r, k, v = (rng.standard_normal((B, S, H, 64)).astype(np.float32) * 0.3
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, S, H, 64)).astype(np.float32)
    u = rng.standard_normal((H, 64)).astype(np.float32) * 0.1
    st = rng.standard_normal((B, H, 64, 64)).astype(np.float32) * 0.1
    want, w_st = jax.jit(ref_rw._wkv_scan)(*(jnp.asarray(a) for a in
                                             (r, k, v, w, u, st)))
    with torch.inference_mode():
        got, g_st = rw._wkv_scan(*(torch.from_numpy(a) for a in
                                   (r, k, v, w, u, st)))
    _close(want, got)
    _close(w_st, g_st)


@pytest.mark.parametrize("S", [1, SEQ])
def test_timemix_and_chanmix_match_reference(S):
    """The time mix (with given shift and wkv states, as decode runs it
    at S = 1) and the channel mix."""
    rc, pc, rp, pp = lm("rwkv6-7b")
    ref, blk = _layer0(rp, pp)
    d = rc.d_model
    x = _x(2, S, d, 5) * 0.5
    shift = _x(1, 2, d, 6)[0]
    st = _x(2, 2, 64 * 64, 7).reshape(2, 2, 64, 64) * 0.1
    want, (w_last, w_st) = jax.jit(ref_rw.timemix_apply)(
        ref["mixer"], jnp.asarray(x), jnp.asarray(shift), jnp.asarray(st))
    want_c, wc_last = jax.jit(ref_rw.chanmix_apply)(
        ref["ffn"], jnp.asarray(x), jnp.asarray(shift))
    with torch.inference_mode():
        got, (g_last, g_st) = rw.timemix_apply(
            blk.mixer, torch.from_numpy(x), torch.from_numpy(shift),
            torch.from_numpy(st))
        got_c, gc_last = rw.chanmix_apply(blk.ffn, torch.from_numpy(x),
                                          torch.from_numpy(shift))
    _close(want, got)
    _close(w_st, g_st)
    _close(want_c, got_c)
    _close(w_last, g_last, atol=0, rtol=0)
    _close(wc_last, gc_last, atol=0, rtol=0)


def test_group_norm_uses_the_population_variance():
    """The time mix's per-head group norm: jnp.var (population), not
    torch.var's default unbiased estimate."""
    y = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(0))
    pop = y.var(-1, correction=0)
    assert torch.allclose(pop, ((y - y.mean(-1, keepdim=True)) ** 2).mean(-1))
    assert not torch.allclose(pop, y.var(-1))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    rc, pc, rp, pp = lm(name)
    toks = _tokens(rc, 2, SEQ, 3)
    want, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, aux = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    assert got.shape == (2, SEQ, rc.vocab) and float(aux) == 0.0
    _close(want, got)


def _ref_cache_layers(rcache, cfg):
    """The reference's stack cache as one dict per layer."""
    pat = len(cfg.block_pattern)
    n_rep = cfg.n_layers // pat
    out = [jax.tree.map(lambda a: a[r], rcache["scan"][j])
           for r in range(n_rep) for j in range(pat)]
    return out + list(rcache["tail"])


def _assert_caches_close(rcache, pcache, cfg):
    want = _ref_cache_layers(rcache, cfg)
    assert len(want) == len(pcache) == cfg.n_layers
    for i, (a, b) in enumerate(zip(want, pcache)):
        assert sorted(a) == sorted(b), i
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), (i, k)
            assert str(a[k].dtype) == str(b[k].dtype).split(".")[-1], (i, k)
            _close(a[k], b[k], **CACHE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_reference(name):
    """Prefill 60 tokens, then 3 decode steps with per-slot positions
    (the second slot 7 behind): logits and every cache leaf after each
    step; the first slot's decode logits also against the reference's
    forward over the same tokens (the recurrent state carries the whole
    prefix)."""
    rc, pc, rp, pp = lm(name)
    toks = _tokens(rc, 2, 63, 4)
    fwd, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    want, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :60])},
                               rc, 80)
    with torch.inference_mode():
        got, pcache = prefill(pp, {"tokens": torch.from_numpy(
            toks[:, :60]).long()}, pc, 80)
        _close(want, got)
        _assert_caches_close(rcache, pcache, pc)
        pos = np.array([60, 53], np.int32)
        for step in range(3):
            nxt = toks[:, 60 + step]
            want, rcache = ref_decode(rp, rcache, jnp.asarray(nxt),
                                      jnp.asarray(pos), rc)
            got, pcache = decode_step(pp, pcache, torch.from_numpy(
                nxt).long(), torch.from_numpy(pos), pc)
            _close(want, got)
            _close(fwd[0, 60 + step], got[0])
            _assert_caches_close(rcache, pcache, pc)
            pos = pos + 1


# rwkv6's gradients sum over the scan in another order (the reference's
# backward scan against autograd over the Python loop); u's, a sum over
# every token of 64 x 64 products with cancellation, carries 112 of the
# 112.3 of the gradient norm and agrees to 5e-6 relative
TRAIN_TOL = {"recurrentgemma-2b": (2e-6, 5e-8),
             "rwkv6-7b": (1e-5, ("rel", 1e-4))}


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    gnorm_rtol, m_atol = TRAIN_TOL[name]
    pc, rs, ps, [(rm, pm)] = _train_step_both(name)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-6)
    np.testing.assert_allclose(pm["grad_norm"], rm["grad_norm"],
                               rtol=gnorm_rtol)
    _assert_state_close(pc, rs, ps, m_atol=m_atol, m_floor=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_remat_scans_give_the_same_gradients(name):
    """Under grad with cfg.remat the scans run in checkpointed 64-step
    chunks (and each pattern repeat is checkpointed): the loss equals the
    one without remat bitwise, and so does every gradient but RWKV's
    ``u``, which sums its chunks' parts in another order (rtol 1e-6;
    1.2e-7 measured)."""
    _, pc, _, pp = lm(name)
    toks = torch.from_numpy(_tokens(pc, 2, SEQ, 8)).long()
    batch = {"tokens": toks, "labels": toks}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(pc, remat=remat)
        names, leaves = zip(*pp.named_parameters())
        loss = loss_fn(pp, batch, c)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for n, a, b in zip(names, out[0][1], out[1][1]):
        if n.endswith("mixer.u"):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b), n


@pytest.mark.parametrize("name", NAMES)
def test_serving_engine_matches_reference(name):
    """Five requests over three slots: the recurrent states of idle slots
    advance and are overwritten at admission, in both engines; the same
    tokens and stats."""
    rc, pc, rp, pp = lm(name)
    specs = [(i, np.arange(2 + 3 * i) % pc.vocab, 5) for i in range(5)]
    ref_eng = RefEngine(jax.tree.map(jnp.asarray, rp), rc,
                        RefServeConfig(batch_slots=3, max_len=32))
    eng = ServingEngine(pp, pc, ServeConfig(batch_slots=3, max_len=32))
    want = ref_eng.run([RefRequest(rid=r, prompt=p, max_new=m)
                        for r, p, m in specs])
    got = eng.run([Request(rid=r, prompt=p, max_new=m)
                   for r, p, m in specs])
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert eng.stats() == ref_eng.stats()
    if name == "rwkv6-7b":
        assert eng.cache[0]["wkv"].shape == (3, 2, 64, 64)
        assert eng.cache[0]["wkv"].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_matches_reference(name):
    rc, pc, rp, pp = lm(name, compute_dtype=torch.bfloat16)
    toks = _tokens(rc, 2, 40, 3)
    want, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, _ = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    assert all(p.dtype == torch.float32 for p in pp.parameters())
    _close(want, got, atol=BF16_RECURRENT_ATOL, rtol=0)
