"""The enc-dec and VLM families against the JAX package: whisper-medium
(a non-causal encoder over ``frames``, a decoder with self- and
cross-attention and learned positions) and llava-next (``patches`` before
the tokens), each at its SMOKE size on the reference's weights
(``convert.lm_params_from_jax``): ``forward`` (also through the flash
kernel's plain version against the reference's Pallas kernel in interpret
mode), ``prefill`` then three ``decode_step``s with every cache leaf, one
``train_step``, llava's loss over the token positions only, llava through
the slot engine (text only, as the reference's), whisper's failures in
the engine and the training CLI (no ``frames``: ROADMAP finding 13) and
its decode step past ``dec_max`` (NaN logits, the kv write dropped:
finding 12); the ``convert`` round trip and ``count_params`` of all ten
architectures; ``configs/shapes.py`` for the four new ones.  The port
runs on one torch thread.

Tolerances, each beside the largest difference measured on this CPU:

* float32 logits: atol = rtol = 1e-5, as ``tests/test_torch_models.py``
  (whisper 6.0e-7, llava 8.9e-7); kv caches, self and cross, atol 3e-5
  (2.7e-6).
* ``attention_impl="pallas"``: the flash kernel's plain version here, the
  reference's Pallas kernel in interpret mode: logits atol = rtol = 1e-5
  (whisper 4.8e-7, llava 7.7e-7).
* One ``train_step``: as ``tests/test_torch_lm_families.py``: loss and
  grad_norm rtol 2e-6 (1.5e-7), first moments atol 5e-8 (6.5e-9).
* bfloat16 ``compute_dtype`` logits: atol 2.5e-2, as the dense
  families' (ROADMAP finding 11; whisper 7.8e-3, llava 8.8e-3).
* The ``convert`` round trip: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.models import count_params as ref_count
from repro.models import decode_step as _ref_decode
from repro.models import forward as _ref_forward
from repro.models import init_params as ref_init
from repro.models import loss_fn as ref_loss
from repro.models import prefill as _ref_prefill
from repro.optim import AdamW as RefAdamW
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_train_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import ALIASES, get_config
from repro_torch.configs import shapes
from repro_torch.models import (cast_for_compute, count_params,
                                decode_step, forward, init_params, loss_fn,
                                prefill)
from repro_torch.optim import AdamW
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.train import init_train_state, make_train_step

from test_torch_lm_families import BF16_LOGIT_ATOL, LR, _assert_state_close

ref_forward = jax.jit(_ref_forward, static_argnums=2)
ref_prefill = jax.jit(_ref_prefill, static_argnums=(2, 3))
ref_decode = jax.jit(_ref_decode, static_argnums=4)

NAMES = ["whisper-medium", "llava-next-34b"]
NEW = ["recurrentgemma-2b", "rwkv6-7b", "whisper-medium", "llava-next-34b"]
TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=3e-5, rtol=1e-5)


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
    rc = dataclasses.replace(ref_config(name, smoke=True), **over)
    pc = dataclasses.replace(get_config(name, smoke=True), **over)
    if name not in _WEIGHTS:
        rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(1), rc))
        _WEIGHTS[name] = rp, convert.lm_params_from_jax(rp, pc, "cpu")
    return (rc, pc, *_WEIGHTS[name])


def _np(t):
    return t.detach().cpu().float().numpy()


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32), _np(b),
                               **(kw or TOL))


def batches(cfg, B, S, seed, labels=False):
    """The same batch for both packages: tokens, and ``frames`` (whisper)
    or ``patches`` (llava) drawn with numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in b.items()}
    port = {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}
    return ref, port


def _cache_pairs(rcache, pcache, cfg):
    """(reference leaf, port leaf, label) of every cache leaf."""
    if cfg.is_encdec:
        for part in ("self", "cross"):
            assert len(pcache[part]) == cfg.n_layers
            for i, layer in enumerate(pcache[part]):
                for k in ("k", "v"):
                    yield rcache[part][k][i], layer[k], f"{part}.{i}.{k}"
        return
    assert len(pcache) == cfg.n_layers
    for i, layer in enumerate(pcache):
        for k in ("k", "v"):
            yield rcache["scan"][0][k][i], layer[k], f"{i}.{k}"


def _assert_caches_close(rcache, pcache, cfg):
    for a, b, what in _cache_pairs(rcache, pcache, cfg):
        assert tuple(a.shape) == tuple(b.shape), what
        _close(a, b, err_msg=what, **CACHE_TOL)


# ---------------------------------------------------------------------------
# configs, counts, the convert round trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_mirrors_reference(name):
    for smoke in (False, True):
        a, b = ref_config(name, smoke=smoke), get_config(name, smoke=smoke)
        for f in dataclasses.fields(a):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    p = init_params(0, get_config(name, smoke=True), device="cpu")
    assert sum(x.numel() for x in p.parameters()) == count_params(
        get_config(name, smoke=True))


def test_count_params_of_all_ten_match_reference():
    assert len(ALIASES) == 10
    for name in ALIASES:
        for smoke in (False, True):
            assert count_params(get_config(name, smoke=smoke)) == \
                ref_count(ref_config(name, smoke=smoke)), (name, smoke)


@pytest.mark.parametrize("name", NEW)
def test_convert_round_trip_is_exact(name):
    """lm_params_from_jax then lm_tree_to_jax_layout gives the
    reference's tree back, leaf for leaf (nested LoRAs, the recurrent
    keys, whisper's stacks and positions); the names of the port's
    parameters key gradients the same way."""
    rc, pc, rp, pp = lm(name)
    back = convert.lm_tree_to_jax_layout(pp, pc)
    assert jax.tree.structure(back) == jax.tree.structure(rp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(rp)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    names = dict(pp.named_parameters())
    grads = convert.lm_tree_to_jax_layout(
        {k: torch.zeros_like(v) for k, v in names.items()}, pc)
    assert jax.tree.structure(grads) == jax.tree.structure(rp)
    if name == "whisper-medium":
        assert pp.stack is None and pp.pos is None
        assert {"enc_pos", "dec_pos", "enc_norm.scale",
                "decoder.1.cross.wk", "encoder.0.mixer.wq"} <= set(names)
    if name == "rwkv6-7b":
        assert "stack.0.mixer.lora_mix.a" in names


# ---------------------------------------------------------------------------
# forward, prefill + decode, one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, impl):
    rc, pc, rp, pp = lm(name, attention_impl=impl)
    rb, pb = batches(rc, 2, 12, 3)
    want, _ = ref_forward(rp, rb, rc)
    with torch.inference_mode():
        got, aux = forward(pp, pb, pc)
    assert got.shape == (2, 12 + rc.n_patches, rc.vocab)
    assert float(aux) == 0.0
    _close(want, got)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_reference(name):
    """Prefill 10 tokens (llava: after its patches; whisper: its self
    cache padded to dec_max whatever max_len, its cross cache the
    encoder's kv), then 3 decode steps with per-slot positions (the
    second slot 3 behind): logits and every cache leaf after each step."""
    rc, pc, rp, pp = lm(name)
    rb, pb = batches(rc, 2, 13, 4)
    r10 = dict(rb, tokens=rb["tokens"][:, :10])
    p10 = dict(pb, tokens=pb["tokens"][:, :10])
    want, rcache = ref_prefill(rp, r10, rc, 24)
    with torch.inference_mode():
        got, pcache = prefill(pp, p10, pc, 24)
        _close(want, got)
        _assert_caches_close(rcache, pcache, pc)
        if pc.is_encdec:
            assert pcache["self"][0]["k"].shape[2] == pc.dec_max
            assert pcache["cross"][0]["k"].shape[2] == pc.enc_seq
        off = rc.n_patches
        pos = np.array([10 + off, 7 + off], np.int32)
        for step in range(3):
            nxt = np.asarray(rb["tokens"][:, 10 + step])
            want, rcache = ref_decode(rp, rcache, jnp.asarray(nxt),
                                      jnp.asarray(pos), rc)
            got, pcache = decode_step(pp, pcache, torch.from_numpy(
                nxt).long(), torch.from_numpy(pos), pc)
            _close(want, got)
            _assert_caches_close(rcache, pcache, pc)
            pos = pos + 1


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    """One AdamW step on a batch with frames (whisper) or patches
    (llava)."""
    rc, pc, rp, _ = lm(name)
    rb, pb = batches(rc, 4, 16, 5, labels=True)
    ref_opt = RefAdamW(lr=LR)
    rs = ref_init_state(jax.tree.map(jnp.asarray, rp), ref_opt)
    rs, rm = jax.jit(ref_make_train_step(rc, ref_opt))(rs, rb)
    opt = AdamW(lr=LR)
    ps = init_train_state(convert.lm_params_from_jax(rp, pc, "cpu"), opt)
    ps, pm = make_train_step(pc, opt)(ps, pb)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=2e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=2e-6)
    _assert_state_close(pc, rs, ps, m_atol=5e-8, m_floor=1e-6)


def test_llava_loss_skips_the_patch_positions():
    """The loss scores the token positions only: it equals the
    reference's, and the cross entropy of the logits after the patches
    computed by hand; without patches the batch is text only."""
    rc, pc, rp, pp = lm("llava-next-34b")
    rb, pb = batches(rc, 2, 9, 6, labels=True)
    want = jax.jit(ref_loss, static_argnums=2)(rp, rb, rc)
    with torch.inference_mode():
        got = loss_fn(pp, pb, pc)
        logits, _ = forward(pp, pb, pc)
        assert logits.shape[1] == rc.n_patches + 9
        hand = torch.nn.functional.cross_entropy(
            logits[:, rc.n_patches:].reshape(-1, rc.vocab),
            pb["labels"].reshape(-1))
        text = {k: pb[k] for k in ("tokens", "labels")}
        text_want = jax.jit(ref_loss, static_argnums=2)(
            rp, {k: rb[k] for k in ("tokens", "labels")}, rc)
        text_got = loss_fn(pp, text, pc)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    np.testing.assert_allclose(float(got), float(hand), rtol=2e-6)
    np.testing.assert_allclose(float(text_got), float(text_want), rtol=2e-6)


# ---------------------------------------------------------------------------
# serving and the training CLI
# ---------------------------------------------------------------------------


def test_llava_serves_text_as_reference():
    """The slot engine builds {"tokens"} only, so llava serves text:
    the reference engine's tokens and stats."""
    rc, pc, rp, pp = lm("llava-next-34b")
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


def test_whisper_engine_fails_without_frames_as_reference():
    """Neither engine can serve whisper: admission prefills {"tokens"}
    only and the encoder needs "frames" (ROADMAP finding 13)."""
    rc, pc, rp, pp = lm("whisper-medium")
    ref_eng = RefEngine(jax.tree.map(jnp.asarray, rp), rc,
                        RefServeConfig(batch_slots=2, max_len=16))
    eng = ServingEngine(pp, pc, ServeConfig(batch_slots=2, max_len=16))
    with pytest.raises(KeyError, match="frames"):
        ref_eng.add_request(RefRequest(rid=0, prompt=np.arange(4)))
    with pytest.raises(KeyError, match="frames"):
        eng.add_request(Request(rid=0, prompt=np.arange(4)))
    assert eng.stats()["admitted"] == ref_eng.stats()["admitted"] == 1


def test_train_cli_fails_for_whisper_as_reference(monkeypatch):
    """Synthetic data has tokens and labels only: the reference's
    training CLI (on its unsharded path, ROADMAP finding 7) and the
    port's fail at whisper's first step for want of frames."""
    import sys

    import repro.launch.train as ref_train
    from repro_torch.launch import train

    def no_mesh(**kw):
        raise ValueError("no mesh")
    monkeypatch.setattr(ref_train, "make_host_mesh", no_mesh)
    flags = ["--arch", "whisper-medium", "--smoke", "--steps", "1",
             "--batch", "2", "--seq", "8"]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    with pytest.raises(KeyError, match="frames"):
        ref_train.main()
    with pytest.raises(KeyError, match="frames"):
        train.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "llava-next-34b"])
def test_train_cli_takes_the_new_archs(arch, capsys):
    from repro_torch.launch import train
    train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "[train] done at step 2" in out


def test_whisper_decode_past_dec_max_mirrors_reference():
    """ROADMAP finding 12: a decode step at pos == dec_max takes no
    position row (jnp.take fills NaN) and drops the self-attention kv
    write (JAX drops an out-of-bounds scatter): that slot's logits are
    NaN and its cache is unchanged, while a slot at an in-range position
    decodes as usual, in both packages."""
    rc, pc, rp, pp = lm("whisper-medium")
    rb, pb = batches(rc, 2, 8, 7)
    _, rcache = ref_prefill(rp, rb, rc, 16)
    with torch.inference_mode():
        _, pcache = prefill(pp, pb, pc, 16)
        before = [(c["k"].clone(), c["v"].clone()) for c in pcache["self"]]
        pos = np.array([rc.dec_max, 8], np.int32)
        nxt = np.array([3, 5], np.int32)
        want, rcache2 = ref_decode(rp, rcache, jnp.asarray(nxt),
                                   jnp.asarray(pos), rc)
        got, pcache = decode_step(pp, pcache, torch.from_numpy(nxt).long(),
                                  torch.from_numpy(pos), pc)
    want = np.asarray(want)
    assert np.isnan(want[0]).all() and np.isfinite(want[1]).all()
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1]).all()
    _close(want[1], got[1])
    for i, (k0, v0) in enumerate(before):
        assert torch.equal(pcache["self"][i]["k"][0], k0[0])
        assert torch.equal(pcache["self"][i]["v"][0], v0[0])
        assert not torch.equal(pcache["self"][i]["k"][1], k0[1])
        np.testing.assert_array_equal(
            np.asarray(rcache2["self"]["k"][i][0]),
            np.asarray(rcache["self"]["k"][i][0]))
    _assert_caches_close(rcache2, pcache, pc)


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------


def _ref_cache_leaves(tree, cfg):
    """The reference's decode cache as (label, shape, dtype) in the
    port's layout: one dict per layer (enc-dec: per part and layer)."""
    if cfg.is_encdec:
        return [(f"{part}.{i}.{k}", tree[part][k].shape[1:],
                 tree[part][k].dtype)
                for part in ("self", "cross") for i in range(cfg.n_layers)
                for k in ("k", "v")]
    pat = len(cfg.block_pattern)
    n_rep = cfg.n_layers // pat
    out = []
    for i in range(cfg.n_layers):
        r, j = divmod(i, pat)
        layer = (tree["scan"][j] if r < n_rep
                 else tree["tail"][i - n_rep * pat])
        for k in sorted(layer):
            a = layer[k]
            out.append((f"{i}.{k}", a.shape[1:] if r < n_rep else a.shape,
                        a.dtype))
    return out


def _port_cache_leaves(cache, cfg):
    if cfg.is_encdec:
        return [(f"{part}.{i}.{k}", tuple(c[k].shape), c[k].dtype)
                for part in ("self", "cross")
                for i, c in enumerate(cache[part]) for k in ("k", "v")]
    return [(f"{i}.{k}", tuple(c[k].shape), c[k].dtype)
            for i, c in enumerate(cache) for k in sorted(c)]


@pytest.mark.parametrize("smoke_scale", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_shapes_match_reference(name, smoke_scale):
    """input_specs (frames, patches, whisper's clamp to (enc_seq,
    dec_max)), cache_specs (the recurrent states, whisper's self and
    cross caches) and cell_supported: the reference's shapes and dtypes,
    in the port's layout on the meta device."""
    rc, pc = ref_config(name), get_config(name)
    for cell in ref_shapes.SHAPES:
        assert shapes.cell_supported(pc, cell) == \
            ref_shapes.cell_supported(rc, cell)
        want = ref_shapes.input_specs(rc, cell, smoke_scale=smoke_scale)
        S = ref_shapes.SHAPES[cell]["seq"]
        if rc.n_patches and smoke_scale and "batch" in want \
                and max(32, S // 512) < rc.n_patches:
            # llava's 576 patches do not fit a smoke-scale sequence (64):
            # the reference's token spec has a negative length (ROADMAP
            # finding 14), which a tensor cannot have
            assert want["batch"]["tokens"].shape[1] < 0
            with pytest.raises(RuntimeError, match="negative dimension"):
                shapes.input_specs(pc, cell, smoke_scale=smoke_scale)
            continue
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
            w = _ref_cache_leaves(want, rc)
            g = _port_cache_leaves(got, pc)
            assert [x[0] for x in w] == [x[0] for x in g]
            for (label, ws, wd), (_, gs, gd) in zip(w, g):
                assert tuple(ws) == gs, label
                assert str(wd) == str(gd).split(".")[-1], label
            leaves = (got["self"] + got["cross"] if pc.is_encdec else got)
            assert all(t.device.type == "meta" for c in leaves
                       for t in c.values())


@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_matches_reference(name):
    """compute_dtype bfloat16: whisper's encoder and decoder are stacked
    whole in the reference, so every 1-D leaf there (norm scales and
    biases) is cast too, and enc_norm and final_norm are not (ROADMAP
    finding 10): the logits come out in the reference's dtype and within
    its bfloat16 tolerance."""
    rc, pc, rp, pp = lm(name)
    rc = dataclasses.replace(rc, compute_dtype=jnp.bfloat16)
    pc = dataclasses.replace(pc, compute_dtype=torch.bfloat16)
    rb, pb = batches(rc, 2, 12, 8)
    want, _ = ref_forward(rp, rb, rc)
    with torch.inference_mode():
        got, _ = forward(pp, pb, pc)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    _close(want, got, atol=BF16_LOGIT_ATOL, rtol=0)
    view = cast_for_compute(pp, pc)
    if name == "whisper-medium":
        assert view.decoder[0].norm3["bias"].dtype == torch.bfloat16
        assert view.encoder[0].norm1["scale"].dtype == torch.bfloat16
        assert view.enc_norm["scale"].dtype == torch.float32
        assert view.dec_pos.dtype == torch.bfloat16
