"""The port's compaction functions (repro_torch.core.compaction) against
the JAX package's (repro.core.compaction), array-equal on seeded numpy
inputs: ample and starved capacities, empty and full spike vectors, and
slot_owner against searchsorted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compaction as ref
from repro_torch.core import compaction as port


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread.  Its CPU runs are many small
    ops; under the parallel test run every worker's threads contend for
    the cores, and a 100-step event run took 82 s with 8 threads a worker
    and six workers, 0.55 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape
    np.testing.assert_array_equal(want, got)


def _spikes(n, density, seed):
    if density == "empty":
        return np.zeros(n, bool)
    if density == "full":
        return np.ones(n, bool)
    return np.random.default_rng(seed).random(n) < density


CASES = [(n, dens) for n in (128, 1000, 5000)
         for dens in ("empty", 0.002, 0.05, "full")]


@pytest.mark.parametrize("n,density", CASES)
@pytest.mark.parametrize("budget", ["ample", "starved"])
def test_two_level_active_matches_reference(n, density, budget):
    s = _spikes(n, density, n)
    if budget == "ample":
        cap = max(8, int(s.sum()) + 4)
        bcap = ref.derived_block_capacity(n, cap)
    else:
        cap, bcap = 5, 2
    want = ref.two_level_active(jnp.asarray(s), cap, bcap)
    got = port.two_level_active(torch.from_numpy(s), cap, bcap)
    assert got.dtype == torch.int32
    _eq(want, got)
    kept = got.numpy()[got.numpy() < n]
    assert np.all(np.diff(kept) > 0)          # ascending


@pytest.mark.parametrize("cap,bcap", [(4, 64), (64, 2), (3, 1), (6, 3)])
def test_two_level_overflow_prefix(cap, bcap):
    s = np.random.default_rng(7).random(2000) < 0.02
    _eq(ref.two_level_active(jnp.asarray(s), cap, bcap),
        port.two_level_active(torch.from_numpy(s), cap, bcap))


@pytest.mark.parametrize("size", [1, 7, 64, 400])
def test_compact_is_bounded_where(size):
    m = np.random.default_rng(size).random(300) < 0.1
    want = jnp.where(jnp.asarray(m), size=size, fill_value=-5)[0]
    _eq(want.astype(jnp.int32), port.compact(torch.from_numpy(m), size, -5))


@pytest.mark.parametrize("seed", range(4))
def test_slot_owner_matches_reference_and_searchsorted(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, size=40) * (rng.random(40) < 0.7)
    seg_end = np.cumsum(lens).astype(np.int32)
    budget = int(seg_end[-1]) + rng.integers(-20, 20)
    budget = max(budget, 1)
    got = port.slot_owner(torch.from_numpy(seg_end), budget)
    _eq(ref.slot_owner(jnp.asarray(seg_end), budget), got)
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(seg_end, np.arange(budget), "right"))


def _fanout(n, seed):
    rng = np.random.default_rng(seed)
    fo = rng.integers(0, 30, size=n)
    fo[rng.random(n) < 0.05] = 300                # a few hubs
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(fo)
    return indptr


@pytest.mark.parametrize("density", [0.0, 0.01, 0.2, 1.0])
@pytest.mark.parametrize("budget", [64, 100_000])
def test_ragged_slots_matches_reference(density, budget):
    n = 600
    indptr = _fanout(n, 3)
    s = _spikes(n, density, 11)
    cap = 48
    bcap = ref.derived_block_capacity(n, cap)
    ids_r = ref.two_level_active(jnp.asarray(s), cap, bcap)
    ids_p = port.two_level_active(torch.from_numpy(s), cap, bcap)
    kw = dict(invalid_from=n, gather_size=int(indptr[-1]))
    want = ref.ragged_slots(ids_r, jnp.asarray(indptr), budget, **kw)
    got = port.ragged_slots(ids_p, torch.from_numpy(indptr), budget, **kw)
    _eq(want[0], got[0].to(torch.int32))
    _eq(want[1], got[1])
    assert int(want[2]) == int(got[2])
    _eq(ref.active_fanout_total(jnp.asarray(s), jnp.asarray(indptr)),
        port.active_fanout_total(torch.from_numpy(s), torch.from_numpy(indptr)))


def test_block_helpers_match():
    for n in (1, 127, 128, 129, 139_255):
        assert port.n_blocks(n) == ref.n_blocks(n)
        for k in (1, 64, 512, 5000):
            assert (port.derived_block_capacity(n, k)
                    == ref.derived_block_capacity(n, k))
    assert port.BLOCK == ref.BLOCK
