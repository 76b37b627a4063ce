"""The spike_prop kernels' plain versions against the Pallas kernels (in
interpret mode), bitwise, and the wrappers' CPU path.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectome as ref_conn
from repro.core.neuron import FLYWIRE_LIF as RP
from repro.exp.stimulus import StimDrive as RefDrive
from repro.kernels.spike_prop import kernel as ref_kernel
from repro.kernels.spike_prop import ops as ref_ops
from repro_torch import convert
from repro_torch.core.neuron import FLYWIRE_LIF as P
from repro_torch.core.neuron import LIFState
from repro_torch.exp.stimulus import StimDrive
from repro_torch.kernels.spike_prop import kernel as K
from repro_torch.kernels.spike_prop import ops

from test_torch_cuda import missing_tile_store, straddle_spikes

ACTIVITY = {"silent": 0.0, "sparse": 0.02, "all": 1.0}
CHANNELS = [(g, v, f) for g in (0, 1) for v in (0, 1) for f in (0, 1)]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def store():
    """An n=800 network (7 x 7 tiles) in both packages' layouts."""
    c = ref_conn.synthetic_flywire(800, seed=2)
    bs = ref_ops.build_blocked(c)
    return c, bs, convert.blocked_from_jax(bs, "cpu")


def _spikes(n, activity, seed=0):
    return np.random.default_rng(seed).random(n) < ACTIVITY[activity]


def _rows(n_tb, fx, seed):
    rng = np.random.default_rng(seed)
    shape = (n_tb, 128)
    refrac = rng.integers(-1, RP.ref_steps + 1, shape).astype(np.int32)
    if fx:
        v = rng.integers(-2 * RP.fx_v_th, 2 * RP.fx_v_th, shape)
        g = rng.integers(-(1 << 24), 1 << 24, shape)
        v, g = v.astype(np.int32), g.astype(np.int32)
        vin = rng.integers(-40, 41, shape).astype(np.int32)
    else:
        v = rng.normal(3.0, 4.0, shape).astype(np.float32)
        g = rng.normal(0.0, 2.0, shape).astype(np.float32)
        vin = rng.normal(0.0, 5.0, shape).astype(np.float32)
    gstim = (rng.integers(-3, 4, shape) * 60).astype(np.float32)
    force = (rng.random(shape) < 0.05).astype(np.int32)
    return (v, g, refrac), (gstim, vin, force)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("activity", list(ACTIVITY))
def test_plain_deliver_matches_pallas(store, activity):
    c, bs, pbs = store
    s = _spikes(c.n, activity)
    spk, nspk = ref_ops.pad_spike_blocks(jnp.asarray(s), bs.n, bs.n_sb)
    want = ref_kernel.spike_deliver_pallas(
        jnp.asarray(bs.blk_id), jnp.asarray(bs.weights), spk, nspk,
        interpret=True)
    pspk, pnspk = ops.pad_spike_blocks(torch.from_numpy(s), bs.n, bs.n_sb)
    np.testing.assert_array_equal(np.asarray(spk), pspk.numpy())
    np.testing.assert_array_equal(np.asarray(nspk), pnspk.numpy())
    _same(want, K.spike_deliver_plain(pbs.blk_id, pbs.weights, pspk,
                                      pnspk).numpy())


@pytest.mark.parametrize("activity", list(ACTIVITY))
@pytest.mark.parametrize("channels", CHANNELS,
                         ids=lambda ch: "gvf" if ch == (1, 1, 1) else
                         "".join(k for k, on in zip("gvf", ch) if on) or "none")
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_plain_fused_matches_pallas(store, fx, channels, activity):
    c, bs, pbs = store
    s = _spikes(c.n, activity, seed=1)
    (v, g, refrac), stim = _rows(bs.blk_id.shape[0], fx,
                                 seed=hash((fx, channels)) % 1000)
    stim = [x if on else None for x, on in zip(stim, channels)]
    spk = ref_ops.spike_blocks(jnp.asarray(s), bs.n, bs.n_sb)
    want = ref_kernel.fused_deliver_lif_pallas(
        jnp.asarray(bs.blk_id), jnp.asarray(bs.weights), spk, v, g, refrac,
        *stim, params=RP, fixed_point=fx, interpret=True)
    got = K.fused_deliver_lif_plain(
        pbs.blk_id, pbs.weights, *ops.pad_spike_blocks(torch.from_numpy(s),
                                                       bs.n, bs.n_sb),
        _t(v), _t(g), _t(refrac), *(_t(x) for x in stim), params=P,
        fixed_point=fx)
    for a, b in zip(want, got):
        _same(a, b.numpy())


@pytest.mark.parametrize("kernel,fx", [("deliver", None), ("fused", False),
                                       ("fused", True)],
                         ids=["deliver", "fused-f32", "fused-q19_12"])
def test_plain_versions_match_pallas_with_straddling_units(store, kernel,
                                                           fx):
    """The spike pattern of the card's unit-straddling case (1-3 spiking
    columns in every source block): both plain versions, bitwise against
    the Pallas kernels."""
    c, bs, pbs = store
    s = straddle_spikes(np.random.default_rng(4), c.n)
    per_block = np.add.reduceat(s, np.arange(0, c.n, 128))
    assert per_block.min() >= 1 and per_block.max() <= 3
    spk, nspk = ref_ops.pad_spike_blocks(jnp.asarray(s), bs.n, bs.n_sb)
    pspk, pnspk = ops.pad_spike_blocks(torch.from_numpy(s), bs.n, bs.n_sb)
    if kernel == "deliver":
        want = [ref_kernel.spike_deliver_pallas(
            jnp.asarray(bs.blk_id), jnp.asarray(bs.weights), spk, nspk,
            interpret=True)]
        got = [K.spike_deliver_plain(pbs.blk_id, pbs.weights, pspk, pnspk)]
    else:
        (v, g, refrac), stim = _rows(bs.blk_id.shape[0], fx, seed=5)
        want = ref_kernel.fused_deliver_lif_pallas(
            jnp.asarray(bs.blk_id), jnp.asarray(bs.weights), spk, v, g,
            refrac, *stim, params=RP, fixed_point=fx, interpret=True)
        got = K.fused_deliver_lif_plain(
            pbs.blk_id, pbs.weights, pspk, pnspk, _t(v), _t(g), _t(refrac),
            *(_t(x) for x in stim), params=P, fixed_point=fx)
    for a, b in zip(want, got):
        _same(a, b.numpy())


@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_fused_step_matches_reference(store, fx):
    """ops.fused_step (row padding, the Q19.12 v_mv conversion) against the
    reference's, on an unpadded n and a drive with every channel."""
    c, bs, pbs = store
    rng = np.random.default_rng(3)
    n = c.n
    s = rng.random(n) < 0.05
    if fx:
        lif = (rng.integers(-200_000, 200_000, n).astype(np.int32),
               rng.integers(-(1 << 22), 1 << 22, n).astype(np.int32),
               rng.integers(0, 3, n).astype(np.int32))
    else:
        lif = (rng.normal(3, 4, n).astype(np.float32),
               rng.normal(0, 2, n).astype(np.float32),
               rng.integers(0, 3, n).astype(np.int32))
    drive = ((rng.random(n) < 0.1) * np.float32(10.5)).astype(np.float32), \
        (rng.integers(0, 2, n) * 180.0).astype(np.float32), rng.random(n) < 0.02
    from repro.core.neuron import LIFState as RefLIF
    rst, rspk = ref_ops.fused_step(
        jnp.asarray(bs.blk_id), jnp.asarray(bs.weights),
        ref_ops.spike_blocks(jnp.asarray(s), n, bs.n_sb), RefLIF(*lif),
        RefDrive(*drive), n, RP, fx, True)
    pst, pspk = ops.fused_step(
        pbs.blk_id, pbs.weights, *ops.pad_spike_blocks(torch.from_numpy(s),
                                                       n, bs.n_sb),
        LIFState(*(_t(x) for x in lif)), StimDrive(*(_t(x) for x in drive)),
        n, P, fx)
    for a, b in zip(rst, pst):
        _same(a, b.numpy())
    _same(rspk, pspk.numpy())


def _rows_ascending_pads_last(blk_id, n_sb):
    for row in np.asarray(blk_id):
        real = row[row < n_sb]
        assert np.all(np.diff(real) > 0)            # ascending, no repeat
        assert np.all(row[len(real):] == n_sb)      # pads after them


def test_blk_id_rows_ascending_pads_last(store):
    """The fused kernel finds a live source block's slot by binary search
    of its target block's blk_id row: every row must be strictly ascending
    with the pad slots (n_sb) last.  The port's tile_coo, the reference's
    store carried over, and a store with an empty target block."""
    c, bs, pbs = store
    own = ops.build_blocked(convert.connectome_from_jax(c), device="cpu")
    for blk_id in (own.blk_id, pbs.blk_id):
        _rows_ascending_pads_last(blk_id, bs.n_sb)
    blk_id, _ = missing_tile_store("cpu")
    _rows_ascending_pads_last(blk_id, 3)
    assert (blk_id[1] == 3).all() and (blk_id[[0, 2]] < 3).any()


@pytest.mark.parametrize("row,ok", [
    ([0, 2, 3, 3], True),
    ([3, 3, 3, 3], True),
    ([0, 1, 2, 3], True),
    ([2, 0, 3, 3], False),      # out of order
    ([0, 3, 2, 3], False),      # a pad before a stored tile
    ([1, 1, 3, 3], False),      # a source block twice
    ([0, 4, 3, 3], False),      # an id past the pad
])
def test_check_row_order(row, ok):
    """The stores the fused kernel may be given are checked where they are
    built (tile_coo) or carried over (convert.blocked_from_jax): a row out
    of order raises there, not as lost deliveries on the card."""
    blk_id = np.array([[0, 1, 3, 3], row], dtype=np.int32)
    if ok:
        ops.check_row_order(blk_id, 3)
        return
    with pytest.raises(ValueError):
        ops.check_row_order(blk_id, 3)
    ref = ref_ops.BlockedSynapses(
        blk_id=blk_id, weights=np.zeros((2, 4, 128, 128), np.float32), n=384,
        n_tb=2, n_sb=3, occupancy=0.0)
    with pytest.raises(ValueError, match="blk_id"):
        convert.blocked_from_jax(ref, device="cpu")


@pytest.mark.parametrize("which", ["synthetic", "empty_block"])
def test_binary_search_finds_exactly_the_stored_tiles(store, which):
    """The kernel's slot search on these rows: lower_bound of a source
    block in a row lands on its slot iff the (target, source) block pair
    has a stored tile, and on a pad or a larger id otherwise."""
    if which == "synthetic":
        blk_id, n_sb = store[2].blk_id.numpy(), store[1].n_sb
    else:
        blk_id, n_sb = missing_tile_store("cpu")[0].numpy(), 3
    for row in blk_id:
        stored = set(row[row < n_sb].tolist())
        for sb in range(n_sb):
            e = int(np.searchsorted(row, sb, side="left"))
            found = e < len(row) and row[e] == sb
            assert found == (sb in stored)


@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_plain_fused_on_empty_target_block_and_one_live_block(fx):
    """One live source block, with a target block that holds no tile for
    it: that block gets no drive, the others theirs; the plain fused
    version against the unfused composition."""
    blk_id, weights = missing_tile_store("cpu")
    s = torch.zeros(384, dtype=torch.bool)
    s[[130, 140, 200]] = True                        # source block 1 only
    spk, nspk = ops.pad_spike_blocks(s, 384, 3)
    assert int((nspk > 0).sum()) == 1
    drive = K.spike_deliver_plain(blk_id, weights, spk, nspk)
    assert torch.all(drive[1] == 0) and drive.abs().sum() > 0
    (v, g, refrac), _ = _rows(3, fx, 8)
    got = K.fused_deliver_lif_plain(blk_id, weights, spk, nspk, _t(v), _t(g),
                                    _t(refrac), params=P, fixed_point=fx)
    lif = LIFState(_t(v).reshape(-1), _t(g).reshape(-1),
                   _t(refrac).reshape(-1))
    from repro_torch.core.neuron import lif_step, lif_step_fx
    if fx:
        want, spikes = lif_step_fx(lif, drive.reshape(-1).round().to(
            torch.int32), P)
    else:
        want, spikes = lif_step(lif, drive.reshape(-1), P)
    for a, b in zip(got, (*want, spikes.to(torch.int32))):
        _same(a.reshape(-1).numpy(), b.numpy())


def test_spike_deliver_matches_dense(store):
    c, bs, _ = store
    pbs = ops.build_blocked(convert.connectome_from_jax(c), device="cpu")
    s = torch.from_numpy(_spikes(c.n, "sparse", seed=4))
    want = torch.from_numpy(c.dense()) @ s.to(torch.float32)
    assert torch.equal(ops.spike_deliver(pbs, s), want)


def test_wrappers_on_cpu_take_the_plain_path(store, monkeypatch):
    """No build and no launch for CPU tensors: the kernel library is never
    loaded, the counts stay at 0, and the results are the plain ones."""
    from repro_torch.kernels import build

    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build a kernel")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build", no_build)
    c, bs, pbs = store
    K.reset_launches()
    spk, nspk = ops.pad_spike_blocks(torch.from_numpy(_spikes(c.n, "all")),
                                     bs.n, bs.n_sb)
    assert torch.equal(K.spike_deliver_tiles(pbs.blk_id, pbs.weights, spk,
                                             nspk),
                       K.spike_deliver_plain(pbs.blk_id, pbs.weights, spk,
                                             nspk))
    (v, g, r), _ = _rows(bs.blk_id.shape[0], True, 5)
    a = K.fused_deliver_lif(pbs.blk_id, pbs.weights, spk, nspk, _t(v),
                            _t(g), _t(r), params=P, fixed_point=True)
    b = K.fused_deliver_lif_plain(pbs.blk_id, pbs.weights, spk, nspk, _t(v),
                                  _t(g), _t(r), params=P, fixed_point=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 0}


def test_wrappers_reject_bad_inputs(store):
    c, bs, pbs = store
    spk, nspk = ops.pad_spike_blocks(torch.zeros(c.n, dtype=torch.bool),
                                     bs.n, bs.n_sb)
    with pytest.raises(ValueError, match="int16"):
        K.spike_deliver_tiles(pbs.blk_id, pbs.weights.float(), spk, nspk)
    with pytest.raises(ValueError, match="nspk"):
        K.spike_deliver_tiles(pbs.blk_id, pbs.weights, spk, nspk.long())
    with pytest.raises(ValueError, match="contiguous"):
        K.spike_deliver_tiles(pbs.blk_id.t().contiguous().t(), pbs.weights,
                              spk, nspk)
    v = torch.zeros(pbs.blk_id.shape[0], 128)
    with pytest.raises(ValueError, match="v"):
        K.fused_deliver_lif(pbs.blk_id, pbs.weights, spk, nspk, v, v,
                            v.int(), params=P, fixed_point=True)
    meta = [x.to("meta") for x in (pbs.blk_id, pbs.weights, spk, nspk)]
    with pytest.raises(ValueError, match="no kernel"):
        K.spike_deliver_tiles(*meta)


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Nothing is built at import: with no nvcc and no CUDA toolkit on the
    path, the modules import and the CPU path runs."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.spike_prop import kernel, ops\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.core.connectome import synthetic_flywire\n"
        "c = synthetic_flywire(300, seed=1)\n"
        "bs = ops.build_blocked(c, device='cpu')\n"
        "out = ops.spike_deliver(bs, torch.ones(300, dtype=torch.bool))\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "    raise SystemExit('nvcc found')\n"
        "except RuntimeError:\n"
        "    print('ok', float(out.abs().sum()) > 0)\n")
    env = {"PATH": str(tmp_path), "PYTHONPATH": SRC,
           "CUDA_HOME": str(tmp_path / "none"), "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok True"


def test_nvcc_absent_here_is_reported_not_hidden():
    """Where there is no nvcc the build raises; it never falls back."""
    from repro_torch.kernels import build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build([K.SOURCES["spike_deliver"] + ".missing.cu"])
