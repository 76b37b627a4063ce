"""The delay_event engine's CUDA kernels against their plain versions, on
the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  The file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_delay_event_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from portbench import spec as bench_spec  # noqa: E402
from repro_torch.core import (LIFParams, SimConfig, build_synapses,  # noqa: E402
                              from_fanout)
from repro_torch.core.neuron import LIFState  # noqa: E402
from repro_torch.exp import (CountDraw, StimDrive,  # noqa: E402
                             poisson_count_table, run_trials)
from repro_torch.kernels.delay_event import kernel as DK  # noqa: E402

P = LIFParams(tau_m=10.0, tau_g=0.5, tau_ref=2.0, v0=-65.0, v_r=-65.0,
              v_th=-50.0, w_scale=0.088, dt=0.1, delay=0.1)
CHANNELS = [(c, g, v, f) for c in (0, 1) for g in (0, 1) for v in (0, 1)
            for f in (0, 1)]


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


def _network(n, fanout, depth, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * fanout, n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    nnz = int(indptr[-1])
    return from_fanout(n, indptr, rng.integers(0, n, nnz).astype(np.int32),
                       rng.integers(-256, 256, nnz).astype(np.int32),
                       rng.integers(1, depth, nnz).astype(np.int8))


def _state(B, n, fx, rng):
    refrac = rng.integers(-1, P.ref_steps + 1, (B, n)).astype(np.int32)
    if fx:
        v = rng.integers(P.fx_v0, P.fx_v_th + (1 << 15), (B, n))
        g = rng.integers(-(1 << 22), 1 << 22, (B, n))
        v, g = v.astype(np.int32), g.astype(np.int32)
    else:
        v = rng.uniform(-66.0, -49.0, (B, n)).astype(np.float32)
        g = rng.normal(0.0, 20.0, (B, n)).astype(np.float32)
    return [torch.from_numpy(x) for x in (v, g, refrac)]


def _drive(B, n, channels, rng):
    c, g, v, f = channels
    pop = torch.from_numpy((np.arange(n) * 3 // n).astype(np.int32))
    table = torch.from_numpy(poisson_count_table((1.2, 2.32, 0.4)))
    bits = torch.from_numpy(rng.integers(0, 1 << 32, (B, n)))
    return StimDrive(
        counts=CountDraw(bits, pop, table, 40.0) if c else None,
        g_units=torch.from_numpy((rng.integers(-3, 4, n) * 60)
                                 .astype(np.float32)) if g else None,
        v_mv=torch.from_numpy(rng.normal(0, 2, (B, n)).astype(np.float32))
        if v else None,
        force=torch.from_numpy(rng.random((B, n)) < 0.05) if f else None)


def _to(drive, dev):
    def t(x):
        return None if x is None else x.to(dev)
    cnt = drive.counts
    return StimDrive(
        v_mv=t(drive.v_mv), g_units=t(drive.g_units), force=t(drive.force),
        counts=None if cnt is None else cnt._replace(
            bits=cnt.bits.to(dev), pop=cnt.pop.to(dev),
            table=cnt.table.to(dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("fx", [True, False])
def test_a_step_matches_plain(cuda, fx, channels):
    rng = np.random.default_rng(sum(channels) + 10 * fx)
    B, n, D = 5, 3000, 41
    c = _network(n, 300, D, 1)
    cfg = SimConfig(params=P, engine="delay_event", fixed_point=fx,
                    quantize_bits=9)
    syn_cpu, syn = build_synapses(c, cfg, "cpu"), build_synapses(c, cfg,
                                                                 cuda)
    assert syn.depth == D and torch.equal(syn.words.cpu(), syn_cpu.words)
    lif = _state(B, n, fx, rng)
    pending = torch.from_numpy(rng.integers(-500, 500, (D, B, n))
                               .astype(np.int32))
    drive = _drive(B, n, channels, rng)
    for ptr in (0, 17, D - 1):
        want_p = pending.clone()
        want = DK.delay_step(syn_cpu, want_p, ptr, LIFState(*lif), drive, P,
                             fx)
        got_p = pending.to(cuda)
        got = DK.delay_step(syn, got_p, ptr,
                            LIFState(*(x.to(cuda) for x in lif)),
                            _to(drive, cuda), P, fx)
        torch.cuda.synchronize()
        assert int(want[1].sum()) > 0
        for a, b in zip(want[0], got[0]):
            assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
        assert torch.equal(want[1], got[1].cpu())
        assert torch.equal(want_p, got_p.cpu())
        for k in ("syn_events", "drive_events"):
            assert torch.equal(want[2][k], got[2][k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("fx", [True, False])
def test_run_trials_on_the_card_equals_the_cpu(cuda, fx):
    conf = bench_spec.config(bench_spec.ROOT, "pd14-q19")
    fam = bench_spec.family(bench_spec.ROOT, conf)
    conf = fam.small(conf)
    conf = {**conf, "model": {**conf["model"], "fixed_point": fx}}
    traffic = bench_spec.traffic(bench_spec.ROOT, "bg8-b1024")
    net = fam.network(conf["network"], os.path.join(
        bench_spec.ROOT, "build", "portbench"))
    c = from_fanout(net["n"], net["out_indptr"], net["out_indices"],
                    net["out_weights"], net["out_delays"])
    cfg = fam.program_config(conf)
    stim = fam.program_stimulus(conf, traffic, net)
    seeds = [5, 2**31 - 9, 77]
    want = run_trials(c, cfg, 250, seeds=seeds, stimulus=stim,
                      chunk_steps=50, device="cpu")
    DK.reset_launches()
    got = run_trials(c, cfg, 250, seeds=seeds, stimulus=stim.to(cuda),
                     chunk_steps=50, device=cuda)
    torch.cuda.synchronize()
    assert DK.LAUNCHES == {"pending_lif": 250, "delay_deliver": 250}
    assert int(want.counts.sum()) > 0
    for a, b in zip([want.counts, want.dropped, *want.state],
                    [got.counts, got.dropped, *got.state]):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
