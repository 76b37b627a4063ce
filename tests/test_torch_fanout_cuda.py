"""The blocked_fused engine's per-synapse kernels against their plain
version and against the fused tile kernel, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  The file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fanout_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import SimConfig, build_synapses, simulate
from repro_torch.core.connectome import synthetic_flywire
from repro_torch.core.neuron import FLYWIRE_LIF as P
from repro_torch.core.neuron import LIFState
from repro_torch.exp import ProbeSpec, StimDrive, build_scenario, run_trials
from repro_torch.kernels import fanout
from repro_torch.kernels.fanout import kernel as FOK
from repro_torch.kernels.spike_prop import kernel as K
from repro_torch.kernels.spike_prop import ops

#: (lanes, share of the sources spiking, drive): storm's ~1.7% with its
#: forced background on 32 lanes, sugar's ~0.1 spikes a lane-step with a
#: g drive on 20 neurons on 1,024 lanes, every source spiking on 4.
CASES = {"storm": (32, 0.017, "force"), "sugar": (1024, 1e-6, "sugar"),
         "all": (4, 1.0, "all")}


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


@pytest.fixture(scope="module")
def net():
    """~100 synapses a neuron, FlyWire's heavy-tailed fan-out."""
    return synthetic_flywire(n=20_000, target_synapses=2_000_000, seed=6)


def _state(B, n, fx, rng, dev):
    refrac = rng.integers(-1, P.ref_steps + 1, (B, n)).astype(np.int32)
    if fx:
        v = rng.integers(-2 * P.fx_v_th, 2 * P.fx_v_th, (B, n))
        g = rng.integers(-(1 << 24), 1 << 24, (B, n))
        v, g = v.astype(np.int32), g.astype(np.int32)
    else:
        v = rng.normal(3.0, 4.0, (B, n)).astype(np.float32)
        g = rng.normal(0.0, 2.0, (B, n)).astype(np.float32)
        g[:, ::9] *= float(np.finfo(np.float32).tiny)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return LIFState(v=t(v), g=t(g), refrac=t(refrac))


def _drive(kind, B, n, rng, dev):
    if kind == "force":
        return StimDrive(force=torch.from_numpy(rng.random((B, n)) < 0.02
                                                ).to(dev))
    if kind == "sugar":
        g = np.zeros((B, n), np.float32)
        g[:, :20] = (rng.random((B, 20)) < 0.015) * 180.0
        return StimDrive(g_units=torch.from_numpy(g).to(dev))
    return StimDrive(
        g_units=torch.from_numpy(rng.normal(0, 50, n).astype(np.float32)
                                 ).to(dev),
        v_mv=torch.from_numpy(rng.normal(0, 3, (B, n)).astype(np.float32)
                              ).to(dev),
        force=torch.from_numpy(rng.random(n) < 0.05).to(dev))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_and_the_tile_kernel(cuda, net, case, fx):
    """Tolerance 0: two steps of the scatter and LIF kernels give the plain
    version's and the fused tile kernel's state and spikes, and the plain
    version's syn_events; the sums are all zero again after each step."""
    B, share, kind = CASES[case]
    n = net.n
    syn = build_synapses(net, SimConfig(engine="blocked_fused",
                                        fixed_point=fx, quantize_bits=9),
                         cuda)
    rng = np.random.default_rng([B, int(fx)])
    lif = _state(B, n, fx, rng, cuda)
    acc = fanout.Accumulator()
    for step in range(2):
        spikes = torch.from_numpy(rng.random((B, n)) < share).to(cuda)
        if case == "sugar":
            spikes[rng.integers(0, B, 100), rng.integers(0, n, 100)] = True
        drive = _drive(kind, B, n, rng, cuda)
        FOK.reset_launches()
        got, got_spk, events = fanout.fanout_step(
            syn.indptr, syn.tgt, syn.w, spikes, lif, drive, P, fx, acc)
        torch.cuda.synchronize()
        assert FOK.LAUNCHES == {"fanout_scatter": 1, "fanout_lif": 1}
        assert not acc.buf.any()
        plain, plain_spk, plain_events = fanout.fanout_step_ref(
            syn.indptr, syn.tgt, syn.w, spikes, lif, drive, P, fx)
        tile, tile_spk = ops.fused_step(
            syn.blk_id, syn.weights,
            *ops.pad_spike_blocks(spikes, n, syn.n_sb), lif, drive, n, P, fx)
        assert int(events.sum()) > 0, case
        assert torch.equal(events, plain_events), case
        assert torch.equal(got_spk, plain_spk) and torch.equal(got_spk,
                                                               tile_spk)
        for a, b, c in zip(got, plain, tile):
            assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a),
                                                                   _bits(c))
        lif = got


@pytest.mark.cuda
def test_scatter_reads_a_slot_at_any_byte_offset(cuda, net):
    """The scatter reads its slot 16 bytes at a time from a 16-byte
    boundary: slots of a ring starting at every offset within 16 bytes
    give the plain sums and events."""
    syn = build_synapses(net, SimConfig(engine="blocked_fused",
                                        fixed_point=True, quantize_bits=9),
                         cuda)
    n = net.n
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.random(3 * n + 16) < 0.01).to(cuda)
    acc = fanout.Accumulator()
    lif = _state(2, n, True, rng, cuda)
    for head in range(16):
        spikes = flat[head:head + 2 * n].view(2, n)
        got = fanout.fanout_step(syn.indptr, syn.tgt, syn.w, spikes, lif,
                                 StimDrive(), P, True, acc)
        want = fanout.fanout_step_ref(syn.indptr, syn.tgt, syn.w, spikes,
                                      lif, StimDrive(), P, True)
        assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert not acc.buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_blocked_fused_trials_run_the_fanout_kernels(cuda, fx):
    """run_trials and simulate on blocked_fused launch the scatter and the
    LIF kernel once a step and the fused tile kernel never; bitwise csr's
    on the card and the CPU's, syn_events the CPU's."""
    c = synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    kw = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False) \
        if fx else dict(quantize_bits=9)
    T, seeds = 200, (0, 5, 9)

    def run(engine, dev):
        cfg = SimConfig(engine=engine, **kw)
        return run_trials(c, cfg, T, seeds=seeds, device=dev,
                          probes=ProbeSpec(raster=True),
                          stimulus=build_scenario("background_storm", c, cfg,
                                                  background_hz=200.0))
    want = run("csr", cuda)
    K.reset_launches()
    FOK.reset_launches()
    got = run("blocked_fused", cuda)
    torch.cuda.synchronize()
    assert FOK.LAUNCHES == {"fanout_scatter": T, "fanout_lif": T}
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 0}
    cpu = run("blocked_fused", "cpu")
    assert int(want.counts.sum()) > 0
    for r in (got, cpu):
        assert torch.equal(r.counts.cpu(), want.counts.cpu())
        assert all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(r.state, want.state))
        assert torch.equal(r.records["raster"].cpu(),
                           want.records["raster"].cpu())
    cfg = SimConfig(engine="blocked_fused", **kw)
    stim = build_scenario("background_storm", c, cfg, background_hz=200.0)
    one, one_cpu = (simulate(c, cfg, T, seed=5, stimulus=stim, device=d)
                    for d in (cuda, "cpu"))
    assert int(one.stats["syn_events"]) == int(one_cpu.stats["syn_events"])
    assert int(one.stats["syn_events"]) > 0
    assert torch.equal(one.counts.cpu(), cpu.counts[1])


@pytest.mark.cuda
def test_the_partitioned_path_keeps_the_tile_kernel(cuda):
    """At P = 12 blocked_fused runs the fused tile kernel, one launch a
    partition and step, and no fan-out kernel."""
    from repro_torch.core import (DistConfig, build_dcsr, even_partition,
                                  simulate_distributed)
    c = synthetic_flywire(6000, seed=2)
    d = build_dcsr(c, even_partition(c, 12), quantize_bits=9)
    sim = SimConfig(engine="blocked_fused", quantize_bits=9,
                    fixed_point=True, poisson_to_v=False)
    stim = build_scenario("sugar_feeding", c, sim, background_hz=20.0)
    T = 40

    def run(engine):
        return simulate_distributed(
            d, DistConfig(sim=dataclasses.replace(sim, engine=engine),
                          scheme="blocked"), T, seed=1, stimulus=stim,
            probes=ProbeSpec(raster=True), device=cuda)
    clean = run("csr")
    K.reset_launches()
    FOK.reset_launches()
    got = run("blocked_fused")
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"spike_deliver": 0, "fused_deliver_lif": 12 * T}
    assert FOK.LAUNCHES == {"fanout_scatter": 0, "fanout_lif": 0}
    assert torch.equal(got.counts, clean.counts)
    assert torch.equal(got.raster, clean.raster)
