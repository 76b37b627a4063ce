"""The blocked_fused engine's local step per synapse, on the CPU.

:func:`repro_torch.kernels.fanout.fanout_step`'s plain version (the one the
CPU runs) is held bitwise against the tile path's plain version
(``ops.fused_step`` -> ``fused_deliver_lif_plain``) over both precisions,
one and four lanes, no, sparse and every source spiking, each subset of
the drive channels, weights that cancel to an exact zero and a spiking
source with no fan-out; ``run_trials`` through ``blocked_fused`` is held
bitwise against ``csr``; the ``syn_events`` counter against the delayed
spikes' summed out-degree.  The kernels themselves are held against it on
the card (``tests/test_torch_fanout_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SimConfig, build_synapses, init_carry
from repro_torch.core.connectome import Connectome, synthetic_flywire
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.blocked_fused import build_fanout
from repro_torch.core.neuron import FLYWIRE_LIF as P
from repro_torch.core.neuron import LIFState
from repro_torch.exp import ProbeSpec, StimDrive, build_scenario, run_trials
from repro_torch.kernels import fanout
from repro_torch.kernels.spike_prop import ops

N = 300                 # two full target blocks and a ragged third
CANCEL = 5              # target 5 gets +7 from source 11 and -7 from 12
MUTE = 13               # a source with no fan-out
ACTIVITY = {"none": 0.0, "sparse": 0.03, "all": 1.0}
CHANNELS = [(g, v, f) for g in (0, 1) for v in (0, 1) for f in (0, 1)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _network(seed=4) -> Connectome:
    """A random network of unique (target, source) pairs with integer
    weights in [-255, 255]; source MUTE sends nothing, and target CANCEL's
    only inputs are +7 and -7."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, N, (6000, 2)), axis=0)
    tgt, src = pairs[:, 0], pairs[:, 1]
    keep = (src != MUTE) & (tgt != CANCEL)
    tgt, src = tgt[keep], src[keep]
    w = rng.integers(-255, 256, len(tgt))
    tgt = np.concatenate([tgt, [CANCEL, CANCEL]])
    src = np.concatenate([src, [11, 12]])
    w = np.concatenate([w, [7, -7]])
    order = np.lexsort((src, tgt))
    tgt, src, w = tgt[order], src[order], w[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(tgt, minlength=N))])
    return Connectome(n=N, in_indptr=indptr, in_indices=src.astype(np.int32),
                      in_weights=w.astype(np.int32))


@pytest.fixture(scope="module")
def store():
    c = _network()
    return {fx: build_synapses(c, SimConfig(engine="blocked_fused",
                                            fixed_point=fx, quantize_bits=9),
                               "cpu")
            for fx in (False, True)}


def _state(B, fx, rng):
    shape = (B, N)
    refrac = torch.from_numpy(
        rng.integers(-1, P.ref_steps + 1, shape).astype(np.int32))
    if fx:
        v = rng.integers(-2 * P.fx_v_th, 2 * P.fx_v_th, shape)
        g = rng.integers(-(1 << 24), 1 << 24, shape)
        v, g = v.astype(np.int32), g.astype(np.int32)
    else:
        tiny = float(np.finfo(np.float32).tiny)
        v = rng.normal(3.0, 4.0, shape).astype(np.float32)
        g = rng.normal(0.0, 2.0, shape).astype(np.float32)
        g[:, ::7] = rng.uniform(-2, 2, g[:, ::7].shape) * tiny
        g[:, CANCEL] = -0.0
        refrac[:, CANCEL] = 0
    return LIFState(v=torch.from_numpy(v), g=torch.from_numpy(g),
                    refrac=refrac)


def _drive(B, channels, rng, shared):
    gs, vm, fo = channels
    lead = (N,) if shared else (B, N)
    return StimDrive(
        g_units=torch.from_numpy(
            (rng.integers(-3, 4, lead) * 60.37).astype(np.float32))
        if gs else None,
        v_mv=torch.from_numpy(rng.normal(0.0, 5.0, lead).astype(np.float32))
        if vm else None,
        force=torch.from_numpy(rng.random(lead) < 0.05) if fo else None)


def _spikes(B, activity, rng):
    s = rng.random((B, N)) < ACTIVITY[activity]
    if activity == "sparse":
        s[:, [11, 12, MUTE]] = True
    return torch.from_numpy(s)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("channels", CHANNELS,
                         ids=[f"g{g}v{v}f{f}" for g, v, f in CHANNELS])
@pytest.mark.parametrize("activity", list(ACTIVITY))
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_plain_step_equals_the_tile_plain(store, fx, lanes, activity,
                                          channels):
    """Tolerance 0: the per-synapse step's plain version gives the tile
    path's state and spikes bit for bit (the four-lane drive shared by the
    lanes where the activity is sparse)."""
    syn = store[fx]
    rng = np.random.default_rng([lanes, len(activity), *channels])
    lif = _state(lanes, fx, rng)
    drive = _drive(lanes, channels, rng, lanes == 4 and activity == "sparse")
    spikes = _spikes(lanes, activity, rng)
    got, got_spk, events = fanout.fanout_step(
        syn.indptr, syn.tgt, syn.w, spikes, lif, drive, P, fx)
    want, want_spk = ops.fused_step(
        syn.blk_id, syn.weights, *ops.pad_spike_blocks(spikes, N, syn.n_sb),
        lif, drive, N, P, fx)
    for a, b, name in zip(got, want, ("v", "g", "refrac")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert got_spk.dtype == torch.bool and torch.equal(got_spk, want_spk)
    deg = syn.indptr[1:] - syn.indptr[:-1]
    assert torch.equal(events, (spikes.long() * deg).sum(dim=1))


def test_cancelling_weights_and_a_mute_source(store):
    """The sums the step works from: target CANCEL's +7 and -7 give an
    exact int32 zero, and source MUTE, spiking alone, adds nothing and
    counts no event."""
    syn = store[True]
    spikes = torch.zeros((2, N), dtype=torch.bool)
    spikes[0, [11, 12]] = True
    spikes[1, MUTE] = True
    sums, events = fanout.fanout_sums(spikes, syn.indptr, syn.tgt, syn.w)
    assert sums.dtype == torch.int32 and int(sums[0, CANCEL]) == 0
    assert not sums[1].any() and int(events[1]) == 0
    deg = syn.indptr[1:] - syn.indptr[:-1]
    assert int(deg[MUTE]) == 0 and int(events[0]) == int(deg[11] + deg[12])


def test_fanout_list_is_the_transposed_store(store):
    """build_fanout: every synapse once, grouped by source, each source's
    synapses in target order, with the quantized weight."""
    c = _network()
    indptr, tgt, w = build_fanout(c, np.clip(c.in_weights, -256, 255), "cpu")
    assert (indptr.dtype, tgt.dtype, w.dtype) == (torch.int64, torch.int32,
                                                  torch.int16)
    src = np.repeat(np.arange(N), np.diff(indptr.numpy()))
    got = sorted(zip(src, tgt.tolist(), w.tolist()))
    want = sorted(zip(c.in_indices.tolist(),
                      np.repeat(np.arange(N), c.fan_in).tolist(),
                      np.clip(c.in_weights, -256, 255).tolist()))
    assert got == want
    for s in range(N):
        row = tgt[indptr[s]:indptr[s + 1]]
        assert torch.equal(row, torch.sort(row).values)


def test_check_fanout_refuses_a_fan_out_past_the_scan():
    fanout.check_fanout(torch.tensor([0, 5, 5 + (1 << 19) - 1]))
    with pytest.raises(ValueError, match="wider"):
        fanout.check_fanout(torch.tensor([0, 1 << 19]))


def test_step_needs_a_kernel_device():
    spikes = torch.zeros((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fanout.fanout_step(None, None, None, spikes, None, StimDrive(), P,
                           False)


@pytest.fixture(scope="module")
def net():
    return synthetic_flywire(n=1000, target_synapses=25_000, seed=5)


@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_run_trials_blocked_fused_equals_csr(net, fx):
    """60 steps (over three 18-step delays) of background_storm at three
    lanes: counts, state and rasters bit for bit csr's; syn_events the
    summed out-degree of the spikes delivered (those of steps 0..T-D-1)."""
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False) \
        if fx else dict(quantize_bits=9)
    T, seeds = 60, (1, 8, 21)
    out = {}
    for engine in ("csr", "blocked_fused"):
        cfg = SimConfig(engine=engine, **kw)
        out[engine] = run_trials(
            net, cfg, T, seeds=seeds, device="cpu",
            probes=ProbeSpec(raster=True),
            stimulus=build_scenario("background_storm", net, cfg,
                                    background_hz=200.0))
    want, got = out["csr"], out["blocked_fused"]
    assert int(want.counts.sum()) > 0
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.dropped, want.dropped)
    for a, b in zip(got.state, want.state):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got.records["raster"], want.records["raster"])


@pytest.mark.parametrize("lanes", [1, 3])
def test_syn_events_count_the_delayed_fan_out(net, lanes):
    """The carry's syn_events after T steps: each lane's spikes of the
    first T - D steps (the ones delivered) times their sources' out-degree;
    one lane without a lane axis through simulate, as run_trials' lane."""
    from repro_torch.core import simulate
    cfg = SimConfig(engine="blocked_fused", fixed_point=True,
                    quantize_bits=9, poisson_to_v=False)
    T, D = 50, P.delay_steps
    stim = build_scenario("background_storm", net, cfg, background_hz=200.0)
    seeds = tuple(range(3, 3 + lanes))
    res = [simulate(net, cfg, T, seed=s, stimulus=stim, device="cpu",
                    probes=ProbeSpec(raster=True)) for s in seeds]
    deg = torch.from_numpy(np.diff(net.out_indptr)).long()
    for s, r in zip(seeds, res):
        delivered = r.raster[:T - D].long().sum(dim=0)
        assert int(delivered.sum()) > 0
        assert r.stats["syn_events"].dtype == torch.int64
        assert int(r.stats["syn_events"]) == int((delivered * deg).sum())


@pytest.mark.parametrize("engine,keys", [
    ("csr", []), ("blocked", []), ("blocked_fused", ["syn_events"]),
    ("delay_event", ["drive_events", "syn_events"])])
def test_carry_stats_keys(engine, keys):
    """The carry's stats on the local path are the engine's init_stats
    (and the health sentinels, here off): [B] int64 each."""
    cfg = SimConfig(engine=engine)
    stim = build_scenario("sugar_feeding", synthetic_flywire(
        n=200, target_synapses=2000, seed=1), cfg)
    depth = 4 if engine == "delay_event" else None
    carry = init_carry(200, cfg, stim, [0, 1], "cpu", depth)
    assert sorted(carry.stats) == keys
    for v in carry.stats.values():
        assert v.dtype == torch.int64 and v.shape == (2,) and not v.any()
    assert hasattr(get_engine(engine), "init_stats") == bool(keys)
