"""repro_torch.random against jax.random: keys, splits, bits, uniforms and
Bernoulli draws are bit-identical in both threefry modes."""

import jax
import numpy as np
import pytest
import torch

from repro_torch import random as prng

SEEDS = (0, 1, 7, 42, 123456, 2**31 - 1, -1, -987654)
MODES = (True, False)


@pytest.fixture(params=MODES, ids=["partitionable", "original"])
def mode(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(mode, seed):
    jk, tk = _keys(seed)
    assert tk.dtype == torch.int64 and tk.shape == (2,)
    np.testing.assert_array_equal(_np(jk), tk.numpy())


@pytest.mark.parametrize("num", [1, 2, 3, 4, 7, 16])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_split(mode, seed, num):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(
        _np(jax.random.split(jk, num)),
        prng.split(tk, num, partitionable=mode).numpy())


def test_split_chain(mode):
    """The step body's per-step 3-way split, chained over 200 steps."""
    jk, tk = _keys(7)
    for _ in range(200):
        jks = jax.random.split(jk, 3)
        tks = prng.split(tk, 3, partitionable=mode)
        jk, tk = jks[0], tks[0]
    np.testing.assert_array_equal(_np(jks), tks.numpy())


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (20,), (3, 5), (1000,),
                                   (4097,)])
def test_bits_and_uniform(mode, shape):
    for seed in SEEDS[:4]:
        jk, tk = _keys(seed)
        np.testing.assert_array_equal(
            _np(jax.random.bits(jk, shape, dtype=np.uint32)),
            prng.random_bits(tk, shape, partitionable=mode).numpy())
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = prng.uniform(tk, shape, partitionable=mode).numpy()
        assert tu.dtype == np.float32
        np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("p", [150.0 * 0.1 * 1e-3, 5.0 * 0.1 * 1e-3, 0.5,
                               0.999])
def test_bernoulli(mode, p):
    for seed in SEEDS[::2]:
        for shape in ((20,), (1500,), (4, 9)):
            jk, tk = _keys(seed)
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(jk, p, shape)),
                prng.bernoulli(tk, p, shape, partitionable=mode).numpy())


def test_seed_out_of_range():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
