"""The port's dense LM (qwen2.5 SMOKE) on the JAX package's own weights,
carried over by repro_torch.convert: forward, prefill (attention_impl
"chunked" and "pallas") with its kv cache, and decode_step with per-slot
positions, against the reference on the same tokens.

Tolerance atol = rtol = 1e-5 on logits of magnitude ~1: both sides are
float32, and the matrix products sum in another order (XLA's CPU dot
against PyTorch's CPU BLAS); the observed gap is ~1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import decode_step as ref_decode
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro.models import prefill as ref_prefill
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import (count_params, decode_step, forward,
                                init_cache, init_params, prefill)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def lm():
    rc = ref_config("qwen2.5-14b", smoke=True)
    pc = get_config("qwen2.5-14b", smoke=True)
    rp = ref_init(jax.random.PRNGKey(1), rc)
    pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc, "cpu")
    return rc, pc, rp, pp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               **(kw or TOL))


def test_config_mirrors_reference():
    for smoke in (False, True):
        a = ref_config("qwen2.5-14b", smoke=smoke)
        b = get_config("qwen2.5-14b", smoke=smoke)
        for f in dataclasses.fields(a):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert b.param_dtype == torch.float32 and b.compute_dtype is None
    full = get_config("qwen2.5-14b")
    from repro.models import count_params as ref_count
    assert count_params(full) == ref_count(ref_config("qwen2.5-14b"))
    # every architecture has a config now (rwkv6-7b was refused before)
    assert count_params(get_config("rwkv6-7b")) == ref_count(
        ref_config("rwkv6-7b"))


def test_forward_matches_reference(lm):
    rc, pc, rp, pp = lm
    toks = _tokens(rc, 2, 32, 3)
    want, _ = ref_forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, aux = forward(pp, {"tokens": torch.from_numpy(toks).long()}, pc)
    assert got.shape == (2, 32, rc.vocab) and float(aux) == 0.0
    _close(want, got)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_matches_reference(lm, impl):
    """Last-token logits and the padded kv cache of every layer; with
    "pallas" the port runs its flash kernel's plain version here."""
    rc, pc, rp, pp = lm
    rc, pc = (dataclasses.replace(c, attention_impl=impl) for c in (rc, pc))
    toks = _tokens(rc, 2, 27, 4)
    want, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks)}, rc, 40)
    FK.reset_launches()
    with torch.inference_mode():
        got, pcache = prefill(pp, {"tokens": torch.from_numpy(toks).long()},
                              pc, 40)
    assert FK.LAUNCHES["flash_attention"] == 0      # CPU: the plain version
    _close(want, got)
    assert len(pcache) == pc.n_layers
    for i, layer in enumerate(pcache):
        for name in ("k", "v"):
            ref = np.asarray(rcache["scan"][0][name][i])
            assert layer[name].shape == ref.shape == (2, 2, 40, 32)
            _close(ref, layer[name], atol=3e-5, rtol=1e-5)


def test_decode_with_vector_positions_matches_reference(lm):
    """Two slots at different positions (continuous batching): each slot
    writes its token's kv at its own position."""
    rc, pc, rp, pp = lm
    toks = _tokens(rc, 2, 24, 5)
    _, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :20])}, rc,
                            32)
    with torch.inference_mode():
        _, pcache = prefill(pp, {"tokens": torch.from_numpy(
            toks[:, :20]).long()}, pc, 32)
        pos = np.array([20, 13], np.int32)
        for step in range(3):
            nxt = toks[:, 20 + step]
            want, rcache = ref_decode(rp, rcache, jnp.asarray(nxt),
                                      jnp.asarray(pos), rc)
            got, pcache = decode_step(pp, pcache, torch.from_numpy(nxt).long(),
                                      torch.from_numpy(pos), pc)
            _close(want, got)
            pos = pos + 1
        for i, layer in enumerate(pcache):
            _close(rcache["scan"][0]["k"][i], layer["k"], atol=3e-5,
                   rtol=1e-5)


@pytest.mark.parametrize("pos", [[32, 32], [33, 40], [32, 7]],
                         ids=["at_max_len", "past_max_len", "mixed"])
def test_decode_past_the_cache_drops_the_write(lm, pos):
    """A position >= max_len (32) drops its kv write, as the reference's
    scatter does, instead of raising: the logits at the decode tolerance,
    the cache as the reference leaves it (an in-range slot beside it
    still writes)."""
    rc, pc, rp, pp = lm
    toks = _tokens(rc, 2, 21, 9)
    _, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks[:, :20])}, rc,
                            32)
    pos = np.array(pos, np.int32)
    with torch.inference_mode():
        _, pcache = prefill(pp, {"tokens": torch.from_numpy(
            toks[:, :20]).long()}, pc, 32)
        before = [c["k"].clone() for c in pcache]
        want, rcache = ref_decode(rp, rcache, jnp.asarray(toks[:, 20]),
                                  jnp.asarray(pos), rc)
        got, pcache = decode_step(pp, pcache,
                                  torch.from_numpy(toks[:, 20]).long(),
                                  torch.from_numpy(pos), pc)
    _close(want, got)
    for i, layer in enumerate(pcache):
        for name in ("k", "v"):
            _close(rcache["scan"][0][name][i], layer[name], atol=3e-5,
                   rtol=1e-5)
        for b, p in enumerate(pos):
            if p >= 32:
                assert torch.equal(layer["k"][b], before[i][b])


def test_prefill_then_decode_matches_forward(lm):
    """The reference's own consistency check, on the port alone: decode
    after prefill(S-1) gives forward's last logits (tolerance as the
    reference's test_prefill_decode_matches_forward: 2e-3)."""
    _, pc, _, pp = lm
    toks = torch.from_numpy(_tokens(pc, 2, 16, 6)).long()
    with torch.inference_mode():
        full, _ = forward(pp, {"tokens": toks}, pc)
        _, cache = prefill(pp, {"tokens": toks[:, :15]}, pc, 24)
        logits, _ = decode_step(pp, cache, toks[:, -1], 15, pc)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def test_init_and_cache_shapes():
    pc = get_config("qwen2.5-14b", smoke=True)
    p = init_params(0, pc, device="cpu")
    assert sum(x.numel() for x in p.parameters()) == count_params(pc)
    assert all(x.requires_grad for x in p.parameters())     # trainable
    assert float(p.embed.std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(init_params(0, pc, device="cpu").embed, p.embed)
    cache = init_cache(pc, 3, 16, device="cpu")
    assert [tuple(c["k"].shape) for c in cache] == [(3, 2, 16, 32)] * 2


def test_unported_variants_raise(lm):
    """The variants the port refused until the recurrent, enc-dec and VLM
    families were ported: recurrent blocks (rwkv, rglru), the enc-dec and
    VLM families and learned absolute positions.  Each now builds and
    runs one forward on the CPU, with finite logits of the expected
    shape, and no architecture's config is refused."""
    rc, pc, rp, pp = lm
    S = 6
    for kw in ({"block_pattern": ("rwkv",), "n_heads": 2, "n_kv_heads": 2,
                "d_head": 64, "norm": "ln", "use_rope": False},
               {"block_pattern": ("rglru", "rglru", "local"), "d_rnn": 64,
                "window": 4},
               {"family": "encdec", "n_enc_layers": 2, "enc_seq": 16,
                "dec_max": 32},
               {"family": "vlm", "n_patches": 4},
               {"learned_pos": 64}):
        cfg = dataclasses.replace(pc, **kw)
        p = init_params(0, cfg, device="cpu")
        assert sum(x.numel() for x in p.parameters()) == count_params(cfg)
        batch = {"tokens": torch.arange(2 * S).reshape(2, S)}
        if cfg.is_encdec:
            batch["frames"] = torch.ones(2, cfg.enc_seq, cfg.d_model)
        if cfg.n_patches:
            batch["patches"] = torch.ones(2, cfg.n_patches, cfg.d_model)
        with torch.inference_mode():
            logits, _ = forward(p, batch, cfg)
        assert logits.shape == (2, S + cfg.n_patches, cfg.vocab), kw
        assert bool(torch.isfinite(logits).all()), kw
    for name in ("rwkv6-7b", "recurrentgemma-2b", "whisper-medium",
                 "llava-next-34b"):
        assert get_config(name).name == name
