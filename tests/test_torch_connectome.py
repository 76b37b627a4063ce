"""Host builders of the port against the JAX package, array for array:
synthetic_flywire, from_edges, quantize_weights, the blocked-ELL tile
store (after the int16 cast and the source-major layout) and convert."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core import compress as ref_compress
from repro.core import connectome as ref_conn
from repro.kernels.spike_prop import ops as ref_ops
from repro_torch import convert
from repro_torch.core import compress, connectome
from repro_torch.kernels.spike_prop import ops

ARRAYS = ("in_indptr", "in_indices", "in_weights", "out_indptr",
          "out_indices", "out_weights")


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _same_connectome(a, b):
    assert a.n == b.n
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("n,seed,syn", [(300, 0, None), (1500, 3, 45_000),
                                        (2000, 11, None), (4000, 5, 20_000)])
def test_synthetic_flywire_equal(n, seed, syn):
    _same_connectome(ref_conn.synthetic_flywire(n, syn, seed),
                     connectome.synthetic_flywire(n, syn, seed))


def test_from_edges_and_quantize_equal():
    rng = np.random.default_rng(0)
    n = 500
    pre = rng.integers(0, n, 20_000)
    post = rng.integers(0, n, 20_000)          # many duplicate pairs
    w = rng.integers(-3000, 3000, 20_000)
    a, b = ref_conn.from_edges(n, pre, post, w), connectome.from_edges(
        n, pre, post, w)
    _same_connectome(a, b)
    assert a.stats() == b.stats()
    for bits in (9, 6, 12):
        np.testing.assert_array_equal(
            ref_compress.quantize_weights(a.in_weights, bits),
            compress.quantize_weights(b.in_weights, bits))
    assert compress.WEIGHT_BITS == ref_compress.WEIGHT_BITS


def test_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    kw = {"target_synapses": 5000}
    assert os.path.basename(connectome.cache_path(400, 2, **kw)) == \
        os.path.basename(ref_conn.cache_path(400, 2, **kw))
    a = connectome.synthetic_flywire_cached(400, 2, **kw)
    assert os.path.exists(connectome.cache_path(400, 2, **kw))
    _same_connectome(a, connectome.synthetic_flywire_cached(400, 2, **kw))
    _same_connectome(a, ref_conn.synthetic_flywire(400, 5000, 2))


def _same_store(ref_bs, port_bs):
    np.testing.assert_array_equal(ref_bs.blk_id, port_bs.blk_id.numpy())
    w = port_bs.weights
    assert w.dtype == torch.int16
    np.testing.assert_array_equal(
        ref_bs.weights, w.permute(0, 1, 3, 2).to(torch.float32).numpy())
    assert (ref_bs.n, ref_bs.n_sb) == (port_bs.n, port_bs.n_sb)
    assert ref_bs.occupancy == port_bs.occupancy
    assert ref_bs.tiles_stored == port_bs.tiles_stored


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n,seed", [(700, 1), (1500, 3)])
def test_build_blocked_equal(n, seed, quantized):
    rc = ref_conn.synthetic_flywire(n, seed=seed)
    pc = connectome.synthetic_flywire(n, seed=seed)
    q = ref_compress.quantize_weights(rc.in_weights) if quantized else None
    ref_bs = ref_ops.build_blocked(rc, q)
    _same_store(ref_bs, ops.build_blocked(pc, q, "cpu"))
    _same_store(ref_bs, convert.blocked_from_jax(ref_bs, "cpu"))


def test_tile_coo_equal_on_sparse_pairs():
    """Targets and sources from different spaces, blocks left empty."""
    rng = np.random.default_rng(2)
    tgt = rng.integers(0, 3 * 128, 3000)
    src = rng.integers(0, 5 * 128, 3000)
    keep = np.unique(tgt * 10_000 + src, return_index=True)[1]
    tgt, src = tgt[keep], src[keep]
    src[tgt < 128] %= 128                 # target block 0 sees one source block
    keep = np.unique(tgt * 10_000 + src, return_index=True)[1]
    tgt, src = tgt[keep], src[keep]
    w = rng.integers(-500, 500, len(tgt))
    rb, rw = ref_ops.tile_coo(tgt, src, w.astype(np.float32), 3, 5)
    pb, pw = ops.tile_coo(tgt, src, w, 3, 5)
    np.testing.assert_array_equal(rb, pb.numpy())
    np.testing.assert_array_equal(rw, pw.permute(0, 1, 3, 2).float().numpy())


def test_int16_range_check_raises():
    c = connectome.from_edges(300, np.array([0, 5]), np.array([7, 200]),
                              np.array([40_000, 1]))
    with pytest.raises(ValueError, match="int16"):
        ops.build_blocked(c, device="cpu")
    with pytest.raises(ValueError, match="int16"):
        ops.tile_coo(np.array([1]), np.array([2]), np.array([-40_000]), 1, 1)
    with pytest.raises(ValueError, match="integers"):
        ops.tile_coo(np.array([1]), np.array([2]), np.array([0.5]), 1, 1)
    bad = ref_ops.build_blocked(ref_conn.from_edges(
        300, np.array([0]), np.array([7]), np.array([40_000])))
    with pytest.raises(ValueError, match="int16"):
        convert.blocked_from_jax(bad, "cpu")


def test_convert_connectome_and_csr():
    from repro.core.engine import SimConfig as RefCfg
    from repro.core.engines import get_engine as ref_engine
    from repro_torch.core import SimConfig
    from repro_torch.core.engines import get_engine
    rc = ref_conn.synthetic_flywire(600, seed=4)
    pc = convert.connectome_from_jax(rc)
    _same_connectome(rc, pc)
    for bits in (None, 9):
        rs = ref_engine("csr").build(rc, RefCfg(quantize_bits=bits))
        ps = get_engine("csr").build(pc, SimConfig(quantize_bits=bits), "cpu")
        cs = convert.csr_from_jax(rs, "cpu")
        for f in ("src", "tgt", "w"):
            np.testing.assert_array_equal(np.asarray(getattr(rs, f)),
                                          getattr(ps, f).numpy())
            assert torch.equal(getattr(ps, f), getattr(cs, f))
        assert ps.n == cs.n == rs.n
