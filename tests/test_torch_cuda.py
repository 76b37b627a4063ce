"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  The file
imports no JAX, so it also runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
from repro_torch.kernels.threefry import kernel as TFK
from repro_torch.kernels.threefry import ref as TFR

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


@pytest.mark.cuda
def test_event_engine_matches_csr_on_the_card(cuda):
    """The ``event`` engine (compaction, bounded gather, index_add_ with
    atomics) bitwise equal to csr on the card, and to its own CPU run."""
    c = synthetic_flywire(20_000, seed=2)
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
    probes = ProbeSpec(raster=True)
    out = {}
    for engine, dev in (("csr", cuda), ("event", cuda), ("event", "cpu")):
        cfg = SimConfig(engine=engine, **kw)
        out[engine, str(dev)] = simulate(
            c, cfg, 200, seed=7, probes=probes, device=dev,
            stimulus=build_scenario("sugar_feeding", c, cfg,
                                    background_hz=20.0))
    ref = out["event", "cpu"]
    assert int(ref.counts.sum()) > 0 and int(ref.dropped) == 0
    for r in out.values():
        assert torch.equal(r.counts.cpu(), ref.counts)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state,
                                                            ref.state))
        assert torch.equal(r.raster.cpu(), ref.raster)


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
@pytest.mark.parametrize("n_parts", [4, 3])
def test_distributed_schemes_agree_on_the_card(cuda, n_parts, fx):
    """simulate_distributed at n = 20,000 (P = 3 has 16 pad neurons): the
    bitmap, event, blocked and blocked_fused runs bitwise equal on the
    card, the blocked ones launching their kernel once per partition and
    step, and equal to the port's own CPU run (bitmap)."""
    from repro_torch.core import (DistConfig, build_dcsr, even_partition,
                                  simulate_distributed)
    c = synthetic_flywire(20_000, seed=2)
    d = build_dcsr(c, even_partition(c, n_parts), quantize_bits=9)
    sim = SimConfig(engine="csr", quantize_bits=9, fixed_point=fx,
                    poisson_to_v=not fx)
    stim = build_scenario("sugar_feeding", c, sim, background_hz=20.0)
    T = 60
    probes = ProbeSpec(raster=True, pop_rate=True)

    def run(scheme, engine, dev):
        K.reset_launches()
        return simulate_distributed(
            d, DistConfig(sim=dataclasses.replace(sim, engine=engine),
                          scheme=scheme), T, seed=3, stimulus=stim,
            probes=probes, device=dev)
    out = {}
    for label, scheme, engine in (("bitmap", "bitmap", "csr"),
                                  ("event", "event", "csr"),
                                  ("blocked", "blocked", "csr"),
                                  ("blocked_fused", "blocked",
                                   "blocked_fused")):
        out[label] = run(scheme, engine, cuda)
        torch.cuda.synchronize()
        want = {"spike_deliver": n_parts * T if label == "blocked" else 0,
                "fused_deliver_lif": (n_parts * T if label == "blocked_fused"
                                      else 0)}
        assert K.LAUNCHES == want, label
    cpu = run("bitmap", "csr", "cpu")
    assert int(cpu.counts.sum()) > 0 and cpu.dropped == 0
    assert out["blocked"].stats["tiles_live"] > 0
    for k in ("tiles_live", "tiles_skipped"):
        assert int(out["blocked"].stats[k]) == int(
            out["blocked_fused"].stats[k])
    for label, r in out.items():
        assert torch.equal(r.counts.cpu(), cpu.counts), label
        assert r.dropped == cpu.dropped, label
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state,
                                                            cpu.state)), label
        assert torch.equal(r.raster.cpu(), cpu.raster), label
        assert torch.equal(r.records["pop_rate_hz"].cpu(),
                           cpu.records["pop_rate_hz"]), label


def _lane_spikes(n, fracs, rng, dev):
    """[B, n] spikes, lane b spiking a fraction fracs[b] (own draws)."""
    return torch.from_numpy(np.stack([rng.random(n) < f for f in fracs])
                            ).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_kernels_lane_batch_match_plain(cuda, quantized):
    """Both kernels at B = 3 lanes (silent, 2% and 30% spiking) in one
    launch each: bitwise equal to their plain versions, and lane b equal
    to the single-lane call on lane b's spikes and state (tolerance 0)."""
    c = synthetic_flywire(1800, seed=2)
    w = np.clip(c.in_weights, -256, 255) if quantized else None
    bs = ops.build_blocked(c, w, cuda)
    rng = np.random.default_rng(1)
    spk, nspk = ops.pad_spike_blocks(
        _lane_spikes(c.n, (0.0, 0.02, 0.3), rng, cuda), bs.n, bs.n_sb)
    assert spk.shape == (3, bs.n_sb + 1, 128) and nspk.shape == (3,
                                                                 bs.n_sb + 1)
    store = (bs.blk_id, bs.weights)
    K.reset_launches()
    a = K.spike_deliver_tiles(*store, spk, nspk)
    assert K.LAUNCHES["spike_deliver"] == 1 and a.shape == (3, bs.n_tb, 128)
    assert torch.equal(a, K.spike_deliver_plain(*store, spk, nspk))
    for b in range(3):
        assert torch.equal(a[b], K.spike_deliver_tiles(*store, spk[b],
                                                       nspk[b]))
    for fx in (False, True):
        lanes = [_rows(bs.n_tb, fx, rng, cuda) for _ in range(3)]
        state = [torch.stack([ln[0][i] for ln in lanes]) for i in range(3)]
        stim = [torch.stack([ln[1][i] for ln in lanes]) for i in range(3)]
        for channels in ((0, 0, 0), (1, 1, 1), (0, 1, 0)):
            ch = [x if on else None for x, on in zip(stim, channels)]
            kw = dict(params=P, fixed_point=fx)
            K.reset_launches()
            out = K.fused_deliver_lif(*store, spk, nspk, *state, *ch, **kw)
            assert K.LAUNCHES["fused_deliver_lif"] == 1
            plain = K.fused_deliver_lif_plain(*store, spk, nspk, *state, *ch,
                                              **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(out, plain)), (
                fx, channels)
            for b in range(3):
                one = K.fused_deliver_lif(
                    *store, spk[b], nspk[b], *(x[b] for x in state),
                    *(None if x is None else x[b] for x in ch), **kw)
                assert all(torch.equal(x[b], y) for x, y in zip(out, one))


@pytest.mark.cuda
def test_lane_batch_of_one_is_the_single_call(cuda):
    """B = 1 gives the single-lane call's result bit for bit."""
    c = synthetic_flywire(1800, seed=2)
    bs = ops.build_blocked(c, None, cuda)
    rng = np.random.default_rng(2)
    spk, nspk = ops.pad_spike_blocks(_lane_spikes(c.n, (0.05,), rng, cuda),
                                     bs.n, bs.n_sb)
    store = (bs.blk_id, bs.weights)
    assert torch.equal(K.spike_deliver_tiles(*store, spk, nspk)[0],
                       K.spike_deliver_tiles(*store, spk[0], nspk[0]))
    for fx in (False, True):
        state, stim = _rows(bs.n_tb, fx, rng, cuda)
        kw = dict(params=P, fixed_point=fx)
        one = K.fused_deliver_lif(*store, spk[0], nspk[0], *state, *stim,
                                  **kw)
        batch = K.fused_deliver_lif(*store, spk, nspk,
                                    *(x[None] for x in state),
                                    *(x[None] for x in stim), **kw)
        assert all(torch.equal(x[0], y) for x, y in zip(batch, one))


@pytest.mark.cuda
def test_delivery_kernels_keep_nine_blocks_an_sm(cuda):
    """With the lane axis both delivery kernels still fit 9 resident blocks
    of 128 threads an SM: at most 56 registers a thread and 19,216 B of
    shared memory a block (cuobjdump counts the 1 KB the card reserves for
    each block)."""
    import os
    import re
    import subprocess
    from repro_torch.kernels import build
    build.build(list(K.SOURCES.values()))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name, src in K.SOURCES.items():
        res = subprocess.run(
            [cuobjdump, "-res-usage", build.library_path(src)], check=True,
            capture_output=True, text=True, timeout=300).stdout
        use = [(int(r), int(s)) for r, s in re.findall(
            r"REG:(\d+) STACK:\d+ SHARED:(\d+)", res)]
        assert use, res
        assert all(r <= 56 and s <= 19_216 + 1_024 for r, s in use), (name,
                                                                      use)


@pytest.mark.cuda
def test_run_trials_on_the_card(cuda):
    """run_trials at B = 3 through csr, event, blocked and blocked_fused,
    bitwise equal to each other and to the CPU run, each delivery kernel
    launched once a step for all three lanes."""
    from repro_torch.exp import run_trials
    c = synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
    probes = ProbeSpec(raster=True, pop_rate=True, voltage=(0, 7, 1499))
    T, seeds = 200, (0, 5, 9)

    def run(engine, dev):
        cfg = SimConfig(engine=engine, **kw)
        K.reset_launches()
        return run_trials(c, cfg, T, seeds=seeds, probes=probes, device=dev,
                          stimulus=build_scenario("sugar_feeding", c, cfg,
                                                  background_hz=20.0))
    cpu = run("csr", "cpu")
    assert all(int(x.sum()) > 0 for x in cpu.counts)
    for engine in ("csr", "event", "blocked", "blocked_fused"):
        r = run(engine, cuda)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {
            "spike_deliver": T if engine == "blocked" else 0,
            "fused_deliver_lif": T if engine == "blocked_fused" else 0}
        assert torch.equal(r.counts.cpu(), cpu.counts), engine
        assert torch.equal(r.dropped.cpu(), cpu.dropped), engine
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state,
                                                            cpu.state))
        for k, v in cpu.records.items():
            assert torch.equal(r.records[k].cpu(), v), (engine, k)


@pytest.mark.cuda
def test_run_dist_trials_on_the_card(cuda):
    """run_dist_trials at P = 3 (16 pad neurons), B = 2: the four scheme
    variants bitwise equal to each other and to the CPU run, tile counters
    per lane equal, one kernel launch per partition and step."""
    from repro_torch.core import DistConfig, build_dcsr, even_partition
    from repro_torch.exp import run_dist_trials
    c = synthetic_flywire(20_000, seed=2)
    d = build_dcsr(c, even_partition(c, 3), quantize_bits=9)
    sim = SimConfig(engine="csr", quantize_bits=9, fixed_point=True,
                    poisson_to_v=False)
    stim = build_scenario("sugar_feeding", c, sim, background_hz=20.0)
    T = 40

    def run(scheme, engine, dev):
        K.reset_launches()
        return run_dist_trials(
            d, DistConfig(sim=dataclasses.replace(sim, engine=engine),
                          scheme=scheme), T, seeds=(3, 4), stimulus=stim,
            probes=ProbeSpec(raster=True), device=dev)
    cpu = run("bitmap", "csr", "cpu")
    assert all(int(x.sum()) > 0 for x in cpu.counts)
    out = {}
    for label, scheme, engine in (("bitmap", "bitmap", "csr"),
                                  ("event", "event", "csr"),
                                  ("blocked", "blocked", "csr"),
                                  ("blocked_fused", "blocked",
                                   "blocked_fused")):
        out[label] = r = run(scheme, engine, cuda)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {
            "spike_deliver": 3 * T if label == "blocked" else 0,
            "fused_deliver_lif": 3 * T if label == "blocked_fused" else 0}
        assert torch.equal(r.counts.cpu(), cpu.counts), label
        assert torch.equal(r.dropped.cpu(), cpu.dropped), label
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state,
                                                            cpu.state))
        assert torch.equal(r.records["raster"].cpu(), cpu.records["raster"])
    for k in ("tiles_live", "tiles_skipped"):
        assert out["blocked"].stats[k].shape == (2,)
        assert torch.equal(out["blocked"].stats[k],
                           out["blocked_fused"].stats[k])


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True])
def test_fused_kernel_fractional_gstim(cuda, fx):
    """The fused kernel on RampDrive's fractional stimulus (60 x k / 200
    weight units, exact halves included, so Q19.12 rounds half to even),
    bitwise against its plain version."""
    from repro_torch.exp.stimulus import RampDrive
    c = synthetic_flywire(1800, seed=2)
    bs = ops.build_blocked(c, None, cuda)
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.random(c.n) < 0.05).to(cuda)
    spk, nspk = ops.pad_spike_blocks(s, bs.n, bs.n_sb)
    (v, g, refrac), _ = _rows(bs.n_tb, fx, rng, cuda)
    ramp = RampDrive(weights=torch.ones(1), t_ramp=200)
    gates = np.array([ramp.gate(int(t)) for t in rng.integers(0, 210, v.shape
                                                               ).ravel()])
    gstim = torch.from_numpy((np.float32(60.0) * gates).astype(np.float32)
                             .reshape(v.shape)).to(cuda)
    assert bool((gstim.frac() == 0.5).any())
    kw = dict(params=P, fixed_point=fx)
    a = K.fused_deliver_lif(bs.blk_id, bs.weights, spk, nspk, v, g, refrac,
                            gstim, None, None, **kw)
    b = K.fused_deliver_lif_plain(bs.blk_id, bs.weights, spk, nspk, v, g,
                                  refrac, gstim, None, None, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_chunked_resumed_opto_ramp_on_the_card(cuda, tmp_path):
    """opto_ramp in Q19.12 through blocked_fused on the card, in chunks
    of 70 steps, killed after two and resumed (background checkpoint
    writes), bitwise equal to its unchunked run and to csr; one fused
    kernel launch a step."""
    c = synthetic_flywire(n=3000, target_synapses=90_000, seed=3)
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
    T = 300

    def run(engine, t=T, **extra):
        cfg = SimConfig(engine=engine, **kw)
        return simulate(c, cfg, t, seed=1, device=cuda,
                        probes=ProbeSpec(raster=True),
                        stimulus=build_scenario("opto_ramp", c, cfg,
                                                t_on_ms=2.0, ramp_ms=15.0,
                                                t_off_ms=27.0), **extra)
    want = run("csr")
    assert int(want.counts.sum()) > 0
    K.reset_launches()
    whole = run("blocked_fused")
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_deliver_lif"] == T
    ck = dict(chunk_steps=70, checkpoint_dir=str(tmp_path / "ck"),
              async_checkpoint=True)
    run("blocked_fused", 140, **ck)
    resumed = run("blocked_fused", resume=True, **ck)
    for r in (whole, resumed):
        assert torch.equal(r.counts, want.counts)
        assert torch.equal(r.raster, want.raster)
        assert torch.equal(r.dropped, want.dropped)
        assert all(torch.equal(x, y) for x, y in zip(r.state, want.state))


@pytest.mark.cuda
def test_sim_server_packed_equals_solo_on_the_card(cuda):
    """A SimServer on blocked_fused (Q19.12) packs four same-signature
    requests into one batch: one fused kernel launch a step for the four
    lanes, and each request bitwise its solo simulate() on the card and
    the CPU server's result; a crash-once request is retried and
    completes."""
    from repro_torch.core.exchange import ExchangeFault
    from repro_torch.core.health import BackoffPolicy
    from repro_torch.serving import (COMPLETED, SimRequest, SimServeConfig,
                                     SimServer)
    c = synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    cfg = SimConfig(engine="blocked_fused", fixed_point=True,
                    quantize_bits=9, poisson_to_v=False)
    T = 100
    serve = SimServeConfig(max_batch=4, chunk_steps=25,
                           backoff=BackoffPolicy(base_s=0.0, jitter=0.0))
    fired = []

    def hook(start, stop):
        if start == 25 and not fired:
            fired.append(start)
            raise ExchangeFault("injected")

    def workload():
        reqs = [SimRequest(scenario="sugar_feeding", t_steps=T, seed=s,
                           params={"background_hz": 20.0},
                           probes=ProbeSpec(raster=True, pop_rate=True))
                for s in range(4)]
        reqs.append(SimRequest(scenario="step_response", t_steps=T, seed=9,
                               fault_hook=hook))
        return reqs

    K.reset_launches()
    srv = SimServer(c, cfg, serve, sleep=lambda s: None, device=cuda)
    reqs = srv.run(workload())
    torch.cuda.synchronize()
    assert [r.status for r in reqs] == [COMPLETED] * 5
    assert reqs[4].attempts == 1
    # 4 lanes in one batch (T launches), the crasher: 25 steps before its
    # hook fired at the second chunk, then T on its retry
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 2 * T + 25}
    cpu = SimServer(c, cfg, serve, sleep=lambda s: None, device="cpu").run(
        workload())
    stim = build_scenario("sugar_feeding", c, srv.cfg, background_hz=20.0)
    for r, w in zip(reqs, cpu):
        assert torch.equal(r.result.counts.cpu(), w.result.counts)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(r.result.state,
                                                            w.result.state))
        for k, v in w.result.records.items():
            assert torch.equal(r.result.records[k].cpu(), v), k
    for r in reqs[:4]:
        solo = simulate(c, srv.cfg, T, seed=r.seed, stimulus=stim,
                        probes=r.probes, device=cuda)
        assert torch.equal(solo.counts, r.result.counts)
        assert torch.equal(solo.raster, r.result.raster)
        assert all(torch.equal(x, y) for x, y in zip(solo.state,
                                                     r.result.state))


@pytest.mark.cuda
def test_faulty_blocked_recovered_on_the_card(cuda, tmp_path):
    """faulty(inner="blocked") with the fused kernel at P = 4: partition 1
    fails at step 30, run_resilient restarts from the step-25
    checkpoint, and the result is bitwise the clean unfused blocked run;
    one fused launch per partition and step run."""
    from repro_torch.core import (DistConfig, FaultSpec, build_dcsr,
                                  configure_faulty, even_partition,
                                  run_resilient, simulate_distributed)
    c = synthetic_flywire(6000, seed=2)
    d = build_dcsr(c, even_partition(c, 4), quantize_bits=9)
    sim = SimConfig(engine="blocked_fused", quantize_bits=9,
                    fixed_point=True, poisson_to_v=False)
    stim = build_scenario("sugar_feeding", c, sim, background_hz=20.0)
    T = 100

    def run(scheme, engine, **kw):
        return simulate_distributed(
            d, DistConfig(sim=dataclasses.replace(sim, engine=engine),
                          scheme=scheme), T, seed=1, stimulus=stim,
            probes=ProbeSpec(raster=True), device=cuda, **kw)

    clean = run("blocked", "csr")
    assert int(clean.counts.sum()) > 0
    configure_faulty(inner="blocked", spec=FaultSpec(partition=1,
                                                     fail_at=(30,)))
    td = str(tmp_path / "ck")
    attempts = []

    def attempt(resume, cap):
        attempts.append(resume)
        return run("faulty", "blocked_fused", chunk_steps=25,
                   checkpoint_dir=td, resume=resume is not None)

    K.reset_launches()
    try:
        got = run_resilient(attempt, checkpoint_dir=td, sleep=lambda s: None)
    finally:
        configure_faulty()
    torch.cuda.synchronize()
    assert attempts == [None, 25]
    # 25 steps before the failure (raised before its chunk ran), the
    # other T - 25 after the resume
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 4 * T}
    assert torch.equal(got.counts, clean.counts)
    assert torch.equal(got.raster, clean.raster)
    assert got.dropped == clean.dropped
    assert all(torch.equal(x, y) for x, y in zip(got.state, clean.state))


@pytest.mark.cuda
@pytest.mark.parametrize("engine,kw", [("dense", {}), ("ell", {}),
                                       ("ell", dict(ell_width_cap=16)),
                                       ("binned", {})],
                         ids=lambda x: str(x))
def test_exact_engines_on_the_card(cuda, engine, kw):
    """Tolerance 0: ``deliver`` on the card equals the CPU's (the ``ell``
    rows over the cap summed in the same order), and a 200-step run of
    ``dense``, uncapped ``ell`` and ``binned`` equals ``csr`` in counts,
    state, dropped and raster; on a batch of 3 lanes too."""
    c = synthetic_flywire(2000, target_synapses=60_000, seed=0)
    cfg = SimConfig(engine=engine, fixed_point=True, quantize_bits=9,
                    poisson_to_v=False, **kw)
    from repro_torch.core.engines import get_engine
    eng = get_engine(engine)
    rng = np.random.default_rng(4)
    spk = torch.from_numpy(np.stack([rng.random(c.n) < p
                                     for p in (0.01, 0.2, 1.0)]))
    on_card = eng.deliver(eng.build(c, cfg, cuda), spk.to(cuda), cfg)[0]
    on_cpu = eng.deliver(eng.build(c, cfg, "cpu"), spk, cfg)[0]
    assert torch.equal(on_card.cpu().view(torch.int32),
                       on_cpu.view(torch.int32))
    if kw:
        return                       # capped ell samples: not held to csr
    stim = build_scenario("sugar_feeding", c, cfg, background_hz=20.0)
    probes = ProbeSpec(raster=True)
    csr = dataclasses.replace(cfg, engine="csr")
    want = simulate(c, csr, 200, seed=3, stimulus=stim, probes=probes,
                    device=cuda)
    got = simulate(c, cfg, 200, seed=3, stimulus=stim, probes=probes,
                   device=cuda)
    assert int(want.counts.sum()) > 0
    for a, b in zip((want.counts, want.dropped, want.raster, *want.state),
                    (got.counts, got.dropped, got.raster, *got.state)):
        assert torch.equal(a, b)
    from repro_torch.exp import run_trials
    lanes = run_trials(c, cfg, 60, seeds=[3, 4, 5], stimulus=stim,
                       device=cuda)
    ref = run_trials(c, csr, 60, seeds=[3, 4, 5], stimulus=stim,
                     device=cuda)
    assert torch.equal(lanes.counts, ref.counts)
    assert all(torch.equal(a, b) for a, b in zip(lanes.state, ref.state))


@pytest.mark.cuda
def test_core_mesh_nccl_world_one_equals_simulate(cuda, tmp_path):
    """One rank under nccl (world size 1): the P = 1 partitioning through
    ``bitmap`` and the fused ``blocked`` scheme on a deterministic drive
    (``step_response``) equals ``simulate()`` with ``csr``, tolerance 0
    (a Poisson drive would differ: the partition's key is split from the
    seed)."""
    import torch.distributed as dist
    from repro_torch.core import (DistConfig, build_dcsr, even_partition,
                                  simulate_distributed)
    from repro_torch.core.distributed import make_core_mesh
    c = synthetic_flywire(2000, target_synapses=60_000, seed=0)
    cfg = SimConfig(engine="csr", fixed_point=True, quantize_bits=9,
                    poisson_to_v=False)
    stim = build_scenario("step_response", c, cfg)
    probes = ProbeSpec(raster=True)
    d = build_dcsr(c, even_partition(c, 1), quantize_bits=9)
    one = simulate(c, cfg, 300, seed=0, stimulus=stim, probes=probes,
                   device=cuda)
    assert int(one.counts.sum()) > 0
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_core_mesh(1, backend="nccl")
        assert mesh.device.type == "cuda" and mesh.backend == "nccl"
        for scheme, engine in (("bitmap", "csr"),
                               ("blocked", "blocked_fused")):
            res = simulate_distributed(
                d, DistConfig(sim=dataclasses.replace(cfg, engine=engine),
                              scheme=scheme),
                300, seed=0, stimulus=stim, probes=probes, mesh=mesh)
            assert torch.equal(res.counts, one.counts.long())
            assert torch.equal(res.raster, one.raster)
            assert all(torch.equal(a, b) for a, b in zip(res.state,
                                                         one.state))
        with pytest.raises(ValueError, match="not 'gloo'"):
            make_core_mesh(1, backend="gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_flash_entry_refuses_a_gradient_on_the_card(cuda):
    """The kernel has no backward (nor has the TPU kernel): under grad an
    operand that requires grad raises before any launch; under no_grad
    and inference_mode the kernel launches as before."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda) for s in ((1, 8, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64)))
    FK.reset_launches()
    want = flash_attention(q, k, v)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*args)
        with pytest.raises(RuntimeError, match="no backward"):
            FK.flash_attention_gqa(*args, scale=0.125, causal=True,
                                   window=None)
        with torch.no_grad():
            assert torch.equal(flash_attention(*args), want)
        with torch.inference_mode():
            assert torch.equal(flash_attention(*args), want)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 7


@pytest.mark.cuda
def test_training_steps_on_the_card_match_the_cpu(cuda):
    """Three SMOKE-size AdamW steps (float32, no TF32, 4 microbatches on
    the third) on the card against the same steps on the CPU: loss rtol
    1e-5, parameters atol 2e-3 (the reference's own accumulation-order
    tolerance; AdamW turns a gradient entry near zero that the two
    devices sum in another order into an update of up to ~lr).  Two runs
    on the card are bitwise equal, so a resumed run can equal an
    uninterrupted one."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2.5-14b", smoke=True)
    cpu_params = init_params(0, cfg, "cpu")
    ds = SyntheticLM(vocab=cfg.vocab, seq=32, global_batch=8)
    opt = AdamW(lr=cosine_schedule(3e-3, 1, 3))
    steps = [make_train_step(cfg, opt), make_train_step(cfg, opt),
             make_train_step(cfg, opt, microbatches=4)]

    def run(params, device):
        state = init_train_state(params, opt)
        losses = []
        for i, step in enumerate(steps):
            state, m = step(state, ds.batch_at(i, device))
            losses.append(float(m["loss"]))
        return state, losses

    on_card = [run(copy.deepcopy(cpu_params).to(cuda), cuda)
               for _ in range(2)]
    on_cpu = run(cpu_params, "cpu")
    np.testing.assert_allclose(on_card[0][1], on_cpu[1], rtol=1e-5)
    assert on_card[0][1] == on_card[1][1]
    for (name, a), b, c in zip(on_card[0][0].params.named_parameters(),
                               on_card[1][0].params.parameters(),
                               on_cpu[0].params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b), name
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   c.detach().numpy(), atol=2e-3,
                                   err_msg=name)


def _ftz(t):
    """Subnormal float32 entries flushed to (signed) zero."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny,
                       t * 0.0, t)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_apply_with_drops_on_the_card_matches_the_cpu(cuda, arch):
    """``moe_apply`` on the card against its CPU run, at the full configs'
    capacity factor 1.25 on inputs skewed toward a few experts (so tokens
    drop).  Inputs and router are small multiples of 2^-6, so the router
    logits are exact on both devices and the routing (choices, sorted
    tokens, kept mask, slots) is bitwise equal.  The dispatch and the
    combine are scatter-adds of one token (plus exact zeros) a slot and
    at most top_k <= 2 gated terms a token, so they are bitwise equal too
    (the combine fed the CPU's expert outputs and gates), and two card
    runs of the whole layer are bitwise equal.  The whole layer's output
    is held at atol 1e-5 (its GEMMs sum in another order on each
    device).  Integer router logits (spread ~50) give gates so small that
    gated terms fall below float32's normal range: the card's float
    atomics flush those to zero, the CPU keeps them, so there the card
    equals the CPU's combine of the flushed terms."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              moe_capacity_factor=1.25)
    p_cpu = init_params(0, cfg, "cpu").stack[0].ffn
    g = torch.Generator().manual_seed(3)
    router = torch.randint(-3, 4, p_cpu["router"].shape, generator=g).float()
    x_cpu = (torch.randint(-2, 3, (3, 64, cfg.d_model), generator=g)
             + torch.randint(-1, 2, (cfg.d_model,), generator=g)).float()
    k, cf, E = cfg.top_k, cfg.moe_capacity_factor, cfg.n_experts
    eo = torch.randn(3, E * 64 * k, cfg.d_model, generator=g)

    def on(device, p):
        return {n: (v.to(device) if isinstance(v, torch.Tensor)
                    else {m: w.to(device) for m, w in v.items()})
                for n, v in p.items()}

    def combine_ftz(eo, route, S):
        # moe_combine with its gated terms flushed before the scatter
        B, _, d = eo.shape
        t_s, g_s, keep, slot = route
        eo_g = torch.gather(eo, 1, slot[..., None].expand(*slot.shape, d))
        terms = _ftz(torch.where(keep[..., None], eo_g * g_s[..., None],
                                 0.0))
        tok = t_s + (torch.arange(B) * S)[:, None]
        out = torch.zeros(B * S, d).index_add_(0, tok.reshape(-1),
                                               terms.reshape(-1, d))
        return _ftz(out).reshape(B, S, d)

    for scale, extreme in ((2.0 ** -6, False), (1.0, True)):
        with torch.no_grad():
            p_cpu["router"].copy_(router * scale)
        p_card, x_card = on(cuda, p_cpu), x_cpu.to(cuda)
        with torch.inference_mode():
            _, choices, C, route = L.moe_route(p_cpu, x_cpu, k, cf)
            r_card = L.moe_route(p_card, x_card, k, cf)
            assert torch.equal(choices, r_card[1].cpu()) and C == r_card[2]
            for a, b in zip(route, r_card[3]):
                if a.dtype != torch.float32:                   # t, keep, slot
                    assert torch.equal(a, b.cpu())
            assert int((~route[2]).sum()) > 0                  # drops occur
            assert torch.equal(L.moe_dispatch(x_cpu, route, E, C),
                               L.moe_dispatch(x_card, r_card[3], E,
                                              C).cpu())
            eo_c = eo[:, :E * C]
            on_card = L.moe_combine(eo_c.to(cuda), tuple(
                t.to(cuda) for t in route), 64).cpu()
            if extreme:
                # top-2 gates reach below 2^-126 times the expert outputs;
                # top-1 gates are all 1
                flushed = combine_ftz(eo_c, route, 64)
                exact = L.moe_combine(eo_c, route, 64)
                assert torch.equal(flushed, exact) == (k == 1)
                assert torch.equal(on_card, flushed)
                continue
            assert torch.equal(on_card, L.moe_combine(eo_c, route, 64))
            out_cpu, aux_cpu = L.moe_apply(p_cpu, x_cpu, top_k=k,
                                           capacity_factor=cf, act=cfg.act)
            runs = [L.moe_apply(p_card, x_card, top_k=k, capacity_factor=cf,
                                act=cfg.act) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        np.testing.assert_allclose(runs[0][0].cpu().numpy(),
                                   out_cpu.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(runs[0][1]), float(aux_cpu),
                                   rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S,D,causal,window", [
    (16, 16, 1500, 64, False, None),       # whisper-medium's encoder
    (10, 1, 1024, 256, True, 2048),        # recurrentgemma-2b's local
    (10, 1, 2048, 256, True, 2048)])       # layers: one kv head for 10
def test_flash_kernel_at_the_recurrent_and_encdec_shapes(cuda, H, Hkv, S, D,
                                                         causal, window):
    """The kernel against its plain version at the shapes the new
    families give it: non-causal over 1,500 frames (not a multiple of the
    64-query block) at D 64, and a 10:1 GQA group at D 256 with a 2,048
    window.  atol 2e-4, the JAX package's tolerance for its kernel."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn(1, H, S, D, device=cuda, generator=g)
    k = torch.randn(1, Hkv, S, D, device=cuda, generator=g)
    v = torch.randn(1, Hkv, S, D, device=cuda, generator=g)
    FK.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    plain = FK.flash_attention_plain(q, k, v, scale=D ** -0.5,
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 1
    assert float((out - plain).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_recurrentgemma_decode_on_the_card_matches_the_cpu(cuda):
    """recurrentgemma SMOKE (RG-LRU blocks and a local-attention layer
    through the flash kernel) on the card against the CPU: a 40-token
    prefill and 3 decode steps, logits and every cache leaf atol 1e-4
    (float32 without TF32; the card's GEMMs and the kernel's 3xTF32
    products sum in other orders than the CPU's); one flash launch, for
    the one local layer."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                              attention_impl="pallas")
    cpu_params = init_params(0, cfg, "cpu")
    card_params = copy.deepcopy(cpu_params).to(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 43),
                         generator=torch.Generator().manual_seed(0))

    def run(params, device):
        out = []
        t = toks.to(device)
        with torch.inference_mode():
            logits, cache = prefill(params, {"tokens": t[:, :40]}, cfg, 64)
            out.append(logits)
            for i in range(3):
                logits, cache = decode_step(params, cache, t[:, 40 + i],
                                            40 + i, cfg)
                out.append(logits)
        return out, cache

    FK.reset_launches()
    card, card_cache = run(card_params, cuda)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 1
    cpu, cpu_cache = run(cpu_params, "cpu")
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
    for i, (a, b) in enumerate(zip(card_cache, cpu_cache)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(),
                                       atol=1e-4, err_msg=f"{i}.{k}")


@pytest.mark.cuda
def test_counter_on_the_card_equals_the_meta_count(cuda):
    """repro_torch.launch.hlo.count over a real SMOKE qwen2.5 prefill with
    the flash kernel (attention_impl="pallas") on the card equals the
    same call counted on meta tensors: FLOPs, bytes, launches and peak;
    flash is charged once a layer, and launched once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import hlo
    from repro_torch.models import init_params, prefill
    from repro_torch.models.model import _abstract_module
    cfg = dataclasses.replace(get_config("qwen2.5-14b", smoke=True),
                              attention_impl="pallas")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48)))
    costs = {}
    for dev in ("meta", "cuda"):
        params = (_abstract_module(cfg) if dev == "meta"
                  else init_params(0, cfg, device=cuda))
        t = tokens.to(dev)
        FK.reset_launches()
        with torch.inference_mode(), hlo.count(dev, resident=(params, t)) \
                as c:
            prefill(params, {"tokens": t}, cfg, 64)
        torch.cuda.synchronize()
        costs[dev] = c.cost
        launched = FK.LAUNCHES["flash_attention"]
    meta, card = costs["meta"], costs["cuda"]
    assert card.kernels == meta.kernels == {"flash_attention": cfg.n_layers}
    assert launched == cfg.n_layers
    assert (card.flops, card.bytes, card.launches, card.peak_bytes) == \
        (meta.flops, meta.bytes, meta.launches, meta.peak_bytes)


# ---------------------------------------------------------------------------
# the threefry kernel
# ---------------------------------------------------------------------------

THREEFRY_LEADS = [(), (3,), (4, 3), (32,), (1024,)]
THREEFRY_SIZES = (1, 7, 20, 1000, 139_255)
THREEFRY_PS = (0.0, 0.0015, 0.02, 0.5, 1.0)


def _threefry_keys(lead, dev, seed=0):
    words = np.random.default_rng(seed).integers(0, 2**32, lead + (2,))
    return torch.from_numpy(words.astype(np.int64)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("lead", THREEFRY_LEADS, ids=str)
def test_threefry_split_matches_plain(cuda, mode, lead):
    """split for num 1..16, bitwise the int64 chain on the card, one
    launch a call; a strided key (the carry's view of the last split)
    splits as its copy does."""
    from repro_torch import random as prng
    k = _threefry_keys(lead, cuda)
    TFK.reset_launches()
    for num in range(1, 17):
        got = prng.split(k, num, partitionable=mode)
        assert got.shape == lead + (num, 2)
        assert torch.equal(got, TFR.split_ref(k, num, mode)), num
    view = prng.split(k, 3, partitionable=mode)[..., 0, :]
    assert torch.equal(prng.split(view, 3, partitionable=mode),
                       TFR.split_ref(view.contiguous(), 3, mode))
    torch.cuda.synchronize()
    assert TFK.LAUNCHES == {"threefry_split": 18, "threefry_bits": 0,
                            "threefry_bernoulli": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("lead", THREEFRY_LEADS, ids=str)
def test_threefry_draws_match_plain(cuda, mode, lead):
    """random_bits, uniform and bernoulli (every p, and poisson_drive
    with a shared mask) over odd and even sizes up to FlyWire's n, bitwise
    the int64 chain on the card."""
    from repro_torch import random as prng
    from repro_torch.core.neuron import poisson_drive
    k = _threefry_keys(lead, cuda, seed=len(lead))
    rng = np.random.default_rng(1)
    TFK.reset_launches()
    for size in THREEFRY_SIZES:
        bits = TFR.random_bits_ref(k, size, mode)
        assert torch.equal(prng.random_bits(k, (size,), partitionable=mode),
                           bits), size
        u = TFR.uniform_from_bits(bits)
        assert torch.equal(prng.uniform(k, (size,), partitionable=mode), u)
        mask = torch.from_numpy(rng.random(size) < 0.6).to(cuda)
        for p in THREEFRY_PS:
            want = u < float(np.float32(p))
            got = prng.bernoulli(k, p, (size,), partitionable=mode)
            assert torch.equal(got, want), (size, p)
            # poisson_drive's p is rate * dt * 1e-3: the same float here
            got = poisson_drive(k, size, p * 1e3, 1.0, mask,
                                partitionable=mode)
            want = u < float(np.float32(p * 1e3 * 1.0 * 1e-3))
            assert torch.equal(got, want & mask), (size, p, "mask")
        del bits, u
    torch.cuda.synchronize()
    n = len(THREEFRY_SIZES)
    assert TFK.LAUNCHES == {"threefry_split": 0, "threefry_bits": 2 * n,
                            "threefry_bernoulli": 2 * n * len(THREEFRY_PS)}


@pytest.mark.cuda
def test_threefry_counted_on_the_card_as_on_meta(cuda):
    """Under hlo.count a draw on the card charges what it charges on
    meta: one launch, the same bytes."""
    from repro_torch import random as prng
    from repro_torch.launch import hlo
    costs = {}
    for dev in ("meta", cuda):
        k = torch.zeros((32, 2), dtype=torch.int64, device=dev)
        with hlo.count(dev, resident=(k,)) as c:
            prng.bernoulli(k, 0.02, (139_255,))
            prng.split(k, 3)
        costs[torch.device(dev).type] = c.cost
    meta, card = costs["meta"], costs["cuda"]
    assert card.kernels == meta.kernels == {"threefry_bernoulli": 1,
                                            "threefry_split": 1}
    assert (card.flops, card.bytes, card.launches, card.peak_bytes) == \
        (meta.flops, meta.bytes, meta.launches, meta.peak_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario,draws", [("background_storm", 2),
                                            ("sugar_feeding", 1)])
def test_threefry_kernel_drives_run_trials(cuda, scenario, draws):
    """20 steps of run_trials on 4 lanes: each step splits the keys and
    draws each stimulus part in one launch apiece (storm: split, sugar,
    background; sugar: split, sugar), and counts and final state are the
    CPU run's, whose draws are the int64 chain."""
    from repro_torch.exp import run_trials
    c = synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    cfg = SimConfig(engine="blocked_fused", fixed_point=True,
                    quantize_bits=9, poisson_to_v=False)
    T, seeds = 20, (0, 1, 2, 3)

    def run(dev):
        TFK.reset_launches()
        return run_trials(c, cfg, T, seeds=seeds, device=dev,
                          stimulus=build_scenario(scenario, c, cfg))
    cpu = run("cpu")
    assert TFK.LAUNCHES == dict.fromkeys(TFK.SOURCES, 0)
    assert int(cpu.counts.sum()) > 0
    r = run(cuda)
    torch.cuda.synchronize()
    assert TFK.LAUNCHES == {"threefry_split": T, "threefry_bits": 0,
                            "threefry_bernoulli": draws * T}
    assert torch.equal(r.counts.cpu(), cpu.counts)
    assert torch.equal(r.dropped.cpu(), cpu.dropped)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(r.state, cpu.state))
