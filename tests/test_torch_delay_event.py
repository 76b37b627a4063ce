"""The ``delay_event`` engine (per-synapse delays into a ring of pending
input) and the ``PoissonCount`` drive, on the CPU (the kernels' plain
versions), held against the benchmark's plain reference of the cortical
microcircuit (``portbench/reference/pd14.py``, plain PyTorch that loads
nothing of the port) on seeded small networks:

* Q19.12 and float32, 3 lanes, 300 steps: spike counts and every field
  of the final state, the pending ring included, bitwise;
* chunked equals unchunked; a run killed mid-way and resumed from its
  checkpoints equals an uninterrupted one;
* a hand-built net whose delays of 1 and D - 1 steps land on exactly the
  steps they should;
* the count draws bitwise the reference's, their means within 3 standard
  errors of each population's lambda over 10**6 draws; every other engine
  refuses a count drive;
* the engine's Q19.12 step (its decay products in 64 bits) bitwise the
  reference's where the 32-bit products would wrap;
* the ``syn_events`` / ``drive_events`` counters in the ``chunk`` events
  equal the reference's totals;
* the partitioned runners and the server refuse the engine."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from portbench import spec as bench_spec  # noqa: E402
from portbench.reference import pd14 as ref_pd14  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core import (DistConfig, LIFParams, SimConfig,  # noqa: E402
                              build_dcsr, from_fanout, simulate,
                              simulate_distributed)
from repro_torch.core.engines.delay_event import (pack_words,  # noqa: E402
                                                  word_layout)
from repro_torch.core.partition import even_partition  # noqa: E402
from repro_torch.core.neuron import LIFState, lif_step_fx  # noqa: E402
from repro_torch.exp import (Compose, PoissonCount, StimDrive,  # noqa: E402
                             count_events, poisson_count_table,
                             run_dist_trials, run_trials)
from repro_torch.kernels.delay_event import unpack  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

SEEDS = [11, 2**31 - 5, 4242]
T = 300


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tests run several to a machine: one intra-op thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _family():
    conf = bench_spec.config(bench_spec.ROOT, "pd14-q19")
    return bench_spec.family(bench_spec.ROOT, conf), conf


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The microcircuit at the benchmark's small size (1,544 neurons,
    119,729 synapses), its configuration and traffic."""
    fam, conf = _family()
    conf = fam.small(conf)
    traffic = bench_spec.traffic(bench_spec.ROOT, "bg8-b1024")
    net = fam.network(conf["network"], str(tmp_path_factory.mktemp("net")))
    return fam, conf, traffic, net


def _conf(conf, fixed_point):
    return {**conf, "model": {**conf["model"], "fixed_point": fixed_point}}


def _program(net, conf, traffic):
    """The port's network, config and stimulus, built from the arrays with
    the port's own API."""
    m = conf["model"]
    c = from_fanout(net["n"], net["out_indptr"], net["out_indices"],
                    net["out_weights"], net["out_delays"])
    cfg = SimConfig(params=LIFParams(
        tau_m=m["tau_m"], tau_g=m["tau_g"], tau_ref=m["tau_ref"], v0=m["v0"],
        v_r=m["v_r"], v_th=m["v_th"], w_scale=m["w_scale"], dt=m["dt"],
        delay=m["dt"]), engine="delay_event", fixed_point=m["fixed_point"],
        quantize_bits=m["weight_bits"], poisson_to_v=False)
    bounds = np.asarray(net["pop_bounds"])
    pop = torch.from_numpy(np.repeat(np.arange(len(bounds) - 1),
                                     np.diff(bounds)).astype(np.int32))
    rate = traffic["drive"][0]["rate_hz"]
    lam = tuple(k * rate * m["dt"] * 1e-3 for k in conf["drive"]["k_ext"])
    stim = Compose((PoissonCount(pop=pop, lam=lam,
                                 weight=ref_pd14.w_ext_units(conf)),))
    return c, cfg, stim


def _fields(res):
    return [res.counts, res.dropped, *res.state]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("fixed_point", [True, False],
                         ids=["q19_12", "float32"])
def test_program_equals_the_reference(small, fixed_point):
    fam, conf, traffic, net = small
    conf = _conf(conf, fixed_point)
    c, cfg, stim = _program(net, conf, traffic)
    got = run_trials(c, cfg, T, seeds=SEEDS, stimulus=stim, chunk_steps=50,
                     device="cpu")
    want = ref_pd14.simulate(net, conf, traffic["drive"], SEEDS, T, "cpu")
    assert int(want.counts.sum()) > 0
    assert int(want.pending.ne(0).sum()) > 0
    assert got.state._fields == ("v", "g", "refrac", "pending")
    assert got.state.pending.shape == (len(SEEDS), c.n,
                                       int(net["out_delays"].max()) + 1)
    _assert_bitwise(_fields(got), [want.counts, want.dropped, want.v,
                                   want.g, want.refrac, want.pending])


def test_chunked_equals_unchunked(small):
    _, conf, traffic, net = small
    c, cfg, stim = _program(net, conf, traffic)
    one = run_trials(c, cfg, 150, seeds=SEEDS, stimulus=stim, device="cpu")
    chunked = run_trials(c, cfg, 150, seeds=SEEDS, stimulus=stim,
                         chunk_steps=7, device="cpu")
    assert int(one.counts.sum()) > 0
    _assert_bitwise(_fields(one), _fields(chunked))


class _Killed(Exception):
    pass


def test_kill_and_resume_equals_an_uninterrupted_run(small, tmp_path):
    _, conf, traffic, net = small
    c, cfg, stim = _program(net, conf, traffic)
    want = simulate(c, cfg, 160, seed=SEEDS[1], stimulus=stim,
                    device="cpu")
    assert int(want.counts.sum()) > 0
    td = str(tmp_path / "ck")
    seen = []

    def kill_at_the_third_boundary(rec):
        if rec["type"] == "chunk":
            seen.append(rec["step"])
            if len(seen) == 3:
                raise _Killed
    with pytest.raises(_Killed):
        with obs.telemetry(kill_at_the_third_boundary):
            simulate(c, cfg, 160, seed=SEEDS[1], stimulus=stim,
                     chunk_steps=20, checkpoint_dir=td, device="cpu")
    assert ckpt.latest_step(td) == 40
    got = simulate(c, cfg, 160, seed=SEEDS[1], stimulus=stim, chunk_steps=20,
                   checkpoint_dir=td, resume=True, device="cpu")
    assert ckpt.latest_step(td) == 160
    assert got.state.pending.shape[0] == c.n      # one lane: [n, D]
    _assert_bitwise([want.counts, want.dropped, *want.state],
                    [got.counts, got.dropped, *got.state])


class _ForceAt:
    """Forces neuron ``i`` to spike at step ``t`` (its key unused)."""
    n_keys = 1

    def __init__(self, i, t):
        self.i, self.t = i, t

    def init_state(self, n):
        return ()

    def to(self, device):
        return self

    def step(self, state, keys, t, n, p, *, partitionable=True):
        force = torch.zeros(keys.shape[:-2] + (n,), dtype=torch.bool)
        force[..., self.i] = t == self.t
        return state, StimDrive(force=force)


def test_delays_of_one_and_d_minus_one_steps_land_on_their_steps():
    """Neuron 0 spikes at step 0 alone; its synapse of delay 1 reaches
    neuron 1 at step 1, its synapse of delay D - 1 = 9 reaches neuron 2
    at step 9, neither earlier."""
    D = 10
    c = from_fanout(3, [0, 2, 2, 2], np.array([1, 2], np.int32),
                    np.array([3, 5], np.int32), np.array([1, D - 1], np.int8))
    cfg = SimConfig(engine="delay_event", fixed_point=True, quantize_bits=9,
                    params=LIFParams(dt=0.1, delay=0.1))
    stim = Compose((_ForceAt(0, 0),))

    def run(t):
        return run_trials(c, cfg, t, seeds=[7], stimulus=stim, device="cpu")
    after0 = run(1)
    assert after0.counts.tolist() == [[1, 0, 0]]
    pending = after0.state.pending[0]                   # [n, D]
    assert pending.shape == (3, D)
    want = torch.zeros((3, D), dtype=torch.int32)
    want[1, 1], want[2, D - 1] = 3, 5
    assert torch.equal(pending, want)
    g = torch.stack([run(t).state.g[0] for t in range(1, D + 1)])  # [D, 3]
    # g after step t - 1: neuron 1's input at step 1, neuron 2's at D - 1
    assert (g[:1, 1] == 0).all() and (g[1:, 1] != 0).all()
    assert (g[:D - 1, 2] == 0).all() and g[D - 1, 2] != 0
    assert int(run(D).state.pending.abs().sum()) == 0


def test_the_packed_word_round_trips():
    tbits, wbits = word_layout(77169, 64, -256, 255)
    assert (tbits, wbits) == (17, 9)
    tgt = torch.tensor([0, 77168, 5, 131071 & 77168])
    w = torch.tensor([-256, 255, -1, 0])
    d = torch.tensor([1, 63, 17, 2])
    back = unpack(pack_words(tgt, w, d, tbits, wbits), tbits, wbits)
    for a, b in zip(back, (tgt, w, d)):
        assert torch.equal(a, b.long())
    with pytest.raises(ValueError, match="do not fit"):
        word_layout(77169, 65, -256, 255)


def test_count_draws_are_the_references(small):
    _, conf, traffic, net = small
    _, _, stim = _program(net, conf, traffic)
    (part,) = stim.parts
    assert torch.equal(part.table, ref_pd14.count_table(part.lam))
    assert torch.equal(torch.from_numpy(poisson_count_table(part.lam)),
                       part.table)
    keys = prng.split(prng.PRNGKey(2**31 - 77), 4)           # [4, 3] lanes
    n = len(part.pop)
    _, drive = stim.step(stim.init_state(n), prng.split(keys, 3)[:, 1:], 0,
                         n, LIFParams(v0=-65.0))
    mine = count_events(drive.counts)
    theirs_words = ref_pd14.words(prng.split(keys, 3)[:, 1], n)
    assert torch.equal(drive.counts.bits, theirs_words)
    thr = part.table[part.pop.long()]
    theirs = (theirs_words[..., None] >= thr).sum(-1).to(torch.int32)
    assert torch.equal(mine, theirs)


@pytest.mark.parametrize("engine", ["csr", "blocked_fused"])
def test_other_engines_refuse_a_count_drive(engine):
    c = _dense_net()
    stim = Compose((PoissonCount(pop=torch.zeros(c.n, dtype=torch.int32),
                                 lam=(1.5,), weight=40.0),))
    cfg = SimConfig(engine=engine, fixed_point=True)
    with pytest.raises(ValueError, match="delay_event"):
        run_trials(c, cfg, 3, seeds=[1, 2], stimulus=stim, device="cpu")


def test_the_wide_fixed_point_step_is_the_references(small):
    """Q19.12 states of |g| up to 4,000 weight units, where the 32-bit
    decay product wraps: the engine's step equals the reference's
    (``reference/pd14.py::lif_fx``) bit for bit, its g decays by 0.8 as
    the float step's does, and the 32-bit step differs."""
    from portbench.reference import sim as ref_sim
    _, conf, _, _ = small
    m = conf["model"]
    p = LIFParams(**{k: m[k] for k in ("tau_m", "tau_g", "tau_ref", "v0",
                                       "v_r", "v_th", "w_scale", "dt")},
                  delay=m["dt"])
    rng = np.random.default_rng(5)
    shape = (3, 20_000)
    v = torch.from_numpy(rng.integers(p.fx_v0 - (300 << 12),
                                      p.fx_v_th, shape).astype(np.int32))
    g = torch.from_numpy(rng.integers(-4000 << 12, 4000 << 12,
                                      shape).astype(np.int32))
    refrac = torch.from_numpy(rng.integers(0, 3, shape).astype(np.int32))
    g_in = torch.from_numpy(rng.integers(-600, 600, shape).astype(np.int32))
    st = LIFState(v=v, g=g, refrac=refrac)
    wide, spk = lif_step_fx(st, g_in, p, wide=True)
    model = ref_sim.Model(**{k: m[k] for k in (
        "tau_m", "tau_g", "tau_ref", "v0", "v_r", "v_th", "w_scale", "dt",
        "fixed_point", "weight_bits")}, delay=m["dt"])
    rv, rg, rr, rspk = ref_pd14.lif_fx(v, g, refrac, g_in, model,
                                       model.fx(12))
    assert torch.equal(wide.v, rv) and torch.equal(wide.g, rg)
    assert torch.equal(wide.refrac, rr) and torch.equal(spk, rspk)
    moved = (refrac == 0) & ~spk
    g1 = g.double() + g_in.double() * 4096
    assert torch.allclose(wide.g.double()[moved], 0.8 * g1[moved],
                          atol=4.0)
    narrow, _ = lif_step_fx(st, g_in, p)
    assert not torch.equal(narrow.g, wide.g)
    small_g = moved & (g1.abs() < 150 * 4096)
    assert torch.equal(narrow.g[small_g], wide.g[small_g])



def test_count_means_are_lambda_within_three_standard_errors():
    lam = (0.05, 1.2, 1.68, 2.32)
    per = 250_000                                   # 10**6 draws in all
    pop = torch.arange(len(lam), dtype=torch.int32).repeat_interleave(per)
    stim = PoissonCount(pop=pop, lam=lam, weight=1.0)
    keys = prng.split(prng.PRNGKey(3), 3)[None, 1:]
    _, drive = stim.step((), keys, 0, len(pop), None)
    counts = count_events(drive.counts).reshape(len(lam), per).double()
    for p, mean in enumerate(lam):
        se = (mean / per) ** 0.5
        assert abs(float(counts[p].mean()) - mean) < 3 * se, (p, mean)
        assert abs(float(counts[p].var()) - mean) < 0.02 * mean + 0.002


def test_chunk_counters_equal_the_references_totals(small):
    _, conf, traffic, net = small
    c, cfg, stim = _program(net, conf, traffic)
    events = []
    with obs.telemetry(lambda rec: events.append(rec)):
        run_trials(c, cfg, 150, seeds=SEEDS, stimulus=stim, chunk_steps=50,
                   device="cpu")
    chunks = [e for e in events if e["type"] == "chunk"]
    want = ref_pd14.simulate(net, conf, traffic["drive"], SEEDS, 150, "cpu",
                             record=True)
    assert len(chunks) == 3
    for key, stat in (("syn_events", "syn_events"),
                      ("drive_events", "drive_events")):
        assert chunks[-1]["counters"][key] == int(want.stats[stat].sum()) > 0
        assert sum(ch["delta"][key] for ch in chunks) == \
            chunks[-1]["counters"][key]
        assert chunks[1]["delta"][key] == \
            int(want.stats[stat][50:100].sum())
    build = [e for e in events if e["type"] == "span"
             and e["name"] == "build"]
    assert build and build[0]["attrs"]["depth"] == \
        int(net["out_delays"].max()) + 1
    assert build[0]["attrs"]["store_bytes"] == \
        8 * (c.n + 1) + 4 * c.nnz


def test_the_partitioned_runners_and_the_server_refuse_it(small):
    from repro_torch.serving import SimServer
    _, conf, traffic, net = small
    c, cfg, stim = _program(net, conf, traffic)
    with pytest.raises(ValueError, match="delay_event"):
        SimServer(c, cfg, device="cpu")
    flat = _dense_net()
    d = build_dcsr(flat, even_partition(flat, 2))
    dcfg = DistConfig(sim=cfg, scheme="event")
    with pytest.raises(ValueError, match="delay_event"):
        simulate_distributed(d, dcfg, 5, device="cpu")
    with pytest.raises(ValueError, match="delay_event"):
        run_dist_trials(d, dcfg, 5, seeds=[1, 2], device="cpu")


def _dense_net():
    from repro_torch.core import synthetic_flywire
    return synthetic_flywire(n=40, target_synapses=200, seed=1)
