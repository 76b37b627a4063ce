"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  The file
imports no JAX, so it also runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SimConfig, build_synapses, simulate
from repro_torch.core.connectome import synthetic_flywire
from repro_torch.core.neuron import FLT_MIN, LIFState
from repro_torch.core.neuron import FLYWIRE_LIF as P
from repro_torch.exp import ProbeSpec, build_scenario
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.lif import kernel as LK
from repro_torch.kernels.lif import lif_update
from repro_torch.kernels.spike_prop import kernel as K
from repro_torch.kernels.spike_prop import ops

ACTIVITY = {"silent": 0.0, "sparse": 0.02, "dense": 0.3, "all": 1.0}
CHANNELS = [(g, v, f) for g in (0, 1) for v in (0, 1) for f in (0, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda")


def _rows(n_tb, fx, rng, dev):
    shape = (n_tb, 128)
    refrac = rng.integers(-1, P.ref_steps + 1, shape).astype(np.int32)
    if fx:
        v = rng.integers(-2 * P.fx_v_th, 2 * P.fx_v_th, shape).astype(np.int32)
        g = rng.integers(-(1 << 24), 1 << 24, shape).astype(np.int32)
        vin = rng.integers(-40, 41, shape).astype(np.int32)
    else:
        v = rng.normal(3.0, 4.0, shape).astype(np.float32)
        g = rng.normal(0.0, 2.0, shape).astype(np.float32)
        vin = rng.normal(0.0, 5.0, shape).astype(np.float32)
    gstim = (rng.integers(-3, 4, shape) * 60).astype(np.float32)
    force = (rng.random(shape) < 0.05).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return [t(v), t(g), t(refrac)], [t(gstim), t(vin), t(force)]


@pytest.mark.cuda
@pytest.mark.parametrize("activity", list(ACTIVITY))
@pytest.mark.parametrize("quantized", [False, True])
def test_kernels_match_plain(cuda, activity, quantized):
    """Tolerance 0: both kernels are bitwise equal to their plain
    versions, in both precisions, for every subset of the channels."""
    c = synthetic_flywire(1800, seed=2)
    w = np.clip(c.in_weights, -256, 255) if quantized else None
    bs = ops.build_blocked(c, w, cuda)
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.random(c.n) < ACTIVITY[activity]).to(cuda)
    spk, nspk = ops.pad_spike_blocks(s, bs.n, bs.n_sb)
    a = K.spike_deliver_tiles(bs.blk_id, bs.weights, spk, nspk)
    b = K.spike_deliver_plain(bs.blk_id, bs.weights, spk, nspk)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    dense = torch.from_numpy(c.dense()).to(cuda) if not quantized else None
    if dense is not None:
        assert torch.equal(a.reshape(-1)[:c.n], dense @ s.to(torch.float32))
    for fx in (False, True):
        state, stim = _rows(bs.n_tb, fx, rng, cuda)
        for channels in CHANNELS:
            ch = [x if on else None for x, on in zip(stim, channels)]
            kw = dict(params=P, fixed_point=fx)
            a = K.fused_deliver_lif(bs.blk_id, bs.weights, spk, nspk, *state,
                                    *ch, **kw)
            b = K.fused_deliver_lif_plain(bs.blk_id, bs.weights, spk, nspk,
                                          *state, *ch, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (fx,
                                                                  channels)


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_simulate_engines_agree_on_the_card(cuda, fx):
    """blocked and blocked_fused through their kernels, bitwise equal to
    csr on the card and to the CPU run, with every launch counted."""
    c = synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False) \
        if fx else {}
    probes = ProbeSpec(raster=True, pop_rate=True)
    out = {}
    for engine in ("csr", "blocked", "blocked_fused"):
        cfg = SimConfig(engine=engine, **kw)
        stim = build_scenario("sugar_feeding", c, cfg)
        K.reset_launches()
        out[engine] = simulate(c, cfg, 300, seed=7, stimulus=stim,
                               probes=probes)
        torch.cuda.synchronize()
        if engine == "blocked":
            assert K.LAUNCHES == {"spike_deliver": 300,
                                  "fused_deliver_lif": 0}
        if engine == "blocked_fused":
            assert K.LAUNCHES == {"spike_deliver": 0,
                                  "fused_deliver_lif": 300}
    cpu = simulate(c, SimConfig(engine="csr", **kw), 300, seed=7,
                   stimulus=build_scenario("sugar_feeding", c, SimConfig(
                       **kw)), probes=probes, device="cpu")
    assert int(cpu.counts.sum()) > 0
    for r in out.values():
        assert torch.equal(r.counts.cpu(), cpu.counts)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state,
                                                            cpu.state))
        assert torch.equal(r.raster.cpu(), cpu.raster)
        assert torch.equal(r.records["pop_rate_hz"].cpu(),
                           cpu.records["pop_rate_hz"])


@pytest.mark.cuda
def test_build_synapses_on_the_card(cuda):
    c = synthetic_flywire(700, seed=1)
    syn = build_synapses(c, SimConfig(engine="blocked"))
    cpu = build_synapses(c, SimConfig(engine="blocked"), "cpu")
    assert syn.weights.device.type == "cuda"
    assert torch.equal(syn.weights.cpu(), cpu.weights)
    assert torch.equal(syn.blk_id.cpu(), cpu.blk_id)


def _subnormal_f32(rng, shape):
    """Float32 values of which about a third are subnormal, a third tiny
    normals and a third ordinary."""
    x = rng.normal(0.0, 3.0, shape)
    pick = rng.integers(0, 3, shape)
    x = np.where(pick == 0, rng.uniform(-1, 1, shape) * FLT_MIN, x)
    x = np.where(pick == 1, rng.uniform(-4, 4, shape) * FLT_MIN, x)
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_lif_kernels_match_plain_at_flywire_size(cuda, fx):
    """Tolerance 0, n = 139,255, with float32 inputs that are or become
    subnormal (the flush-to-zero of XLA's CPU code)."""
    rng = np.random.default_rng(3)
    n = 139_255
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    refrac = t(rng.integers(-1, P.ref_steps + 1, n).astype(np.int32))
    force = t((rng.random(n) < 0.05).astype(np.int32))
    if fx:
        v = t(rng.integers(-2 * P.fx_v_th, 2 * P.fx_v_th, n).astype(np.int32))
        g = t(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32))
        g_in = t(rng.integers(-(1 << 19), 1 << 19, n).astype(np.int32))
        v_in = t(rng.integers(-40, 41, n).astype(np.int32))
        fn, plain = LK.lif_update_fx32, LK.lif_update_fx_ref
    else:
        v, g, g_in, v_in = (t(_subnormal_f32(rng, n)) for _ in range(4))
        fn, plain = LK.lif_update_f32, LK.lif_update_ref
    args = (v, g, refrac, g_in, v_in, force)
    a, b = fn(*args, params=P), plain(*args, params=P)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if not fx:      # flushes happened: zero g out of nonzero g, no spike
        assert int(((a[1] == 0) & (a[3] == 0) & (g != 0)).sum()) > 500


@pytest.mark.cuda
def test_lif_entry_point_trajectory_on_the_card(cuda):
    """200 quiet steps from subnormal-bound state through the entry point,
    bitwise equal to the CPU run, every launch counted."""
    rng = np.random.default_rng(4)
    n = 5000
    st = LIFState(v=torch.from_numpy(rng.normal(0, 5, n).astype(np.float32)),
                  g=torch.from_numpy((rng.exponential(3, n) * 1e-37
                                      ).astype(np.float32)),
                  refrac=torch.zeros(n, dtype=torch.int32))
    dev = LIFState(*(x.to(cuda) for x in st))
    g_in = torch.zeros(n)
    LK.reset_launches()
    for _ in range(200):
        st, s_cpu = lif_update(st, g_in, P)
        dev, s_dev = lif_update(dev, g_in.to(cuda), P)
    torch.cuda.synchronize()
    assert LK.LAUNCHES == {"lif_update_f32": 200, "lif_update_fx32": 0}
    assert all(torch.equal(x.cpu(), y) for x, y in zip(dev, st))
    assert torch.equal(s_dev.cpu(), s_cpu)


@pytest.mark.cuda
def test_fused_kernel_flushes_like_plain(cuda):
    """The fused delivery->LIF kernel on subnormal state and stimulus,
    bitwise against its plain version."""
    c = synthetic_flywire(1800, seed=2)
    bs = ops.build_blocked(c, None, cuda)
    rng = np.random.default_rng(6)
    s = torch.from_numpy(rng.random(c.n) < 0.02).to(cuda)
    spk, nspk = ops.pad_spike_blocks(s, bs.n, bs.n_sb)
    shape = (bs.n_tb, 128)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    v, g, gstim, vin = (t(_subnormal_f32(rng, shape)) for _ in range(4))
    refrac = t(rng.integers(-1, 3, shape).astype(np.int32))
    kw = dict(params=P, fixed_point=False)
    a = K.fused_deliver_lif(bs.blk_id, bs.weights, spk, nspk, v, g, refrac,
                            gstim, vin, None, **kw)
    b = K.fused_deliver_lif_plain(bs.blk_id, bs.weights, spk, nspk, v, g,
                                  refrac, gstim, vin, None, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,D,causal,window", [
    (1, 2, 2, 256, 64, True, None), (2, 4, 2, 128, 64, True, None),
    (1, 2, 1, 200, 32, True, None), (1, 2, 2, 256, 64, False, None),
    (1, 2, 2, 512, 64, True, 128), (1, 4, 4, 384, 128, True, 96),
    (1, 4, 2, 160, 24, True, None), (1, 4, 2, 1500, 256, True, 1024),
    (1, 40, 8, 1000, 128, True, None)])
def test_flash_kernel_matches_attention_ref(cuda, B, H, Hkv, Sq, D, causal,
                                            window):
    """atol 2e-4 (the JAX package's tolerance for its kernel): the sweep of
    tests/test_kernels.py, d_head 24 and 256 with a 1,024 window, and the
    qwen2.5-14b shapes (40 heads over 8 kv heads of 128)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(Sq + D)
    q = torch.randn(B, H, Sq, D, device=cuda, generator=g)
    k = torch.randn(B, Hkv, Sq, D, device=cuda, generator=g)
    v = torch.randn(B, Hkv, Sq, D, device=cuda, generator=g)
    FK.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    plain = FK.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 1
    assert float((out - ref).abs().max()) <= 2e-4
    assert float((out - plain).abs().max()) <= 2e-4


def missing_tile_store(dev):
    """Target block 1 (of 3) holds no tile, block 0 none from source block
    2: a live source block that some target blocks have no tile for.  The
    CPU tests of test_torch_spike_prop.py use it too."""
    rng = np.random.default_rng(5)
    tgt = np.concatenate([rng.integers(0, 128, 500),
                          rng.integers(256, 384, 500)])
    src = np.concatenate([rng.integers(0, 256, 500),
                          rng.integers(0, 384, 500)])
    w = rng.integers(-256, 256, 1000).astype(np.float32)
    return ops.tile_coo(tgt, src, w, 3, 3, dev)


def straddle_spikes(rng, n):
    """One to three spiking neurons in every source block: live tiles of
    1-3 spiking columns each, whose rows fill the kernels' 32-row staging
    units only together, so a unit spans several tiles (chip_smoke.py has
    the same case)."""
    s = np.zeros(n, bool)
    for lo in range(0, n, 128):
        block = np.arange(lo, min(n, lo + 128))
        s[rng.choice(block, min(len(block), rng.integers(1, 4)),
                     replace=False)] = True
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_live_block", "missing_tiles",
                                  "straddling_units"])
@pytest.mark.parametrize("kernel,fx", [("spike_deliver", None),
                                       ("fused_deliver_lif", False),
                                       ("fused_deliver_lif", True)],
                         ids=["deliver", "fused-f32", "fused-q19_12"])
def test_fused_kernel_live_list_cases(cuda, case, kernel, fx):
    """Tolerance 0: both delivery kernels' live-list edge cases against
    their plain versions, every channel present: exactly one live source
    block; a live block that some target blocks hold no tile for; and
    live tiles of 1-3 spiking columns whose rows straddle several 32-row
    staging units, batches and both windows of 128 source blocks.  (Every
    block live is test_kernels_match_plain's "all".)"""
    rng = np.random.default_rng(9)
    if case == "missing_tiles":
        blk_id, weights = missing_tile_store(cuda)
        assert bool((blk_id[1] == 3).all())
        assert not bool((blk_id[0] == 2).any())
        n, n_sb = 384, 3
        s = np.zeros(n, bool)
        s[[260, 300, 383]] = True
    else:
        c = synthetic_flywire(17_000 if case == "straddling_units" else 1800,
                              seed=2)
        bs = ops.build_blocked(c, None, cuda)
        blk_id, weights, n, n_sb = bs.blk_id, bs.weights, c.n, bs.n_sb
        if case == "straddling_units":
            s = straddle_spikes(rng, n)
        else:
            s = np.zeros(n, bool)
            s[[700, 701, 767]] = True
    spk, nspk = ops.pad_spike_blocks(torch.from_numpy(s).to(cuda), n, n_sb)
    if case == "straddling_units":
        rows = nspk[blk_id.long()].sum(dim=1)
        assert n_sb > 128 and int(nspk.max()) <= 3
        assert int(rows.min()) > 2 * 32
    else:
        assert int((nspk > 0).sum()) == 1
    K.reset_launches()
    if kernel == "spike_deliver":
        a = (K.spike_deliver_tiles(blk_id, weights, spk, nspk),)
        b = (K.spike_deliver_plain(blk_id, weights, spk, nspk),)
    else:
        state, stim = _rows(blk_id.shape[0], fx, rng, cuda)
        kw = dict(params=P, fixed_point=fx)
        a = K.fused_deliver_lif(blk_id, weights, spk, nspk, *state, *stim,
                                **kw)
        b = K.fused_deliver_lif_plain(blk_id, weights, spk, nspk, *state,
                                      *stim, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_wrappers_reject_misaligned_weights(cuda):
    """The kernels copy tile rows 16 bytes at a time: a store whose
    weights do not start on 16 bytes is refused, not read wrong."""
    c = synthetic_flywire(700, seed=1)
    bs = ops.build_blocked(c, None, cuda)
    flat = torch.empty(bs.weights.numel() + 1, dtype=torch.int16,
                       device=cuda)
    weights = flat[1:].view(bs.weights.shape)
    weights.copy_(bs.weights)
    spk, nspk = ops.pad_spike_blocks(torch.ones(c.n, dtype=torch.bool,
                                                device=cuda), c.n, bs.n_sb)
    state, _ = _rows(bs.n_tb, False, np.random.default_rng(0), cuda)
    K.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.spike_deliver_tiles(bs.blk_id, weights, spk, nspk)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.fused_deliver_lif(bs.blk_id, weights, spk, nspk, *state, params=P,
                            fixed_point=False)
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window", [
    (1, 4, 2, 100, 170, 32, True, None),      # Sq, Skv off the tiles
    (2, 2, 1, 77, 77, 32, False, None),
    (1, 2, 1, 150, 93, 256, True, None),      # D 256: 32-key tiles
    (1, 2, 2, 130, 250, 256, False, 40),
    (1, 2, 2, 90, 90, 30, True, None),        # D % 4 != 0: 4-byte copies
])
def test_flash_kernel_ragged_shapes(cuda, B, H, Hkv, Sq, Skv, D, causal,
                                    window):
    """atol 2e-4 against the plain version (query i at position i, as the
    TPU kernel places it) at lengths that are not multiples of the query
    or key tile, at the smallest and largest head dims; against
    attention_ref too where Sq == Skv."""
    g = torch.Generator(device=cuda).manual_seed(Sq * Skv + D)
    q = torch.randn(B, H, Sq, D, device=cuda, generator=g)
    k = torch.randn(B, Hkv, Skv, D, device=cuda, generator=g)
    v = torch.randn(B, Hkv, Skv, D, device=cuda, generator=g)
    FK.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    plain = FK.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 1
    assert torch.isfinite(out).all()
    assert float((out - plain).abs().max()) <= 2e-4
    if Sq == Skv:
        ref = attention_ref(q, k, v, causal=causal, window=window)
        assert float((out - ref).abs().max()) <= 2e-4
