"""The port's supervisor and fault injection against the JAX package's:
``BackoffPolicy`` and ``escalate_capacity`` value for value;
``run_resilient`` through crashes (restart events and waits), a drop-rate
escalation on a starved ``event`` budget (events, capacities and the
converged result bitwise the reference's), poison re-raised at once and
an escalation declined without a capacity; and the ``faulty`` exchange
scheme at P = 4 on inner ``event`` and ``blocked`` (the latter with the
fused kernel): an injected partition failure recovered from the newest
checkpoint bitwise equal to the clean run and to the reference's
recovered run, restarts exhausted, dropped and corrupted payloads
bitwise equal to the reference's faulty run in both threefry modes, and
``configure_faulty``'s guards.  The network is tests/test_health.py's
(n = 400, 8,000 synapses, four even partitions).  Every comparison is
with a live reference run in a pinned threefry mode, never a golden."""

import contextlib
import random
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.core import CapacityConfig as RefCap
from repro.core import HealthConfig as RefHealth
from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core import escalate_capacity as ref_escalate
from repro.core import run_resilient as ref_run_resilient
from repro.core import simulate as ref_simulate
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.distributed import simulate_distributed as ref_simulate_dist
from repro.core.exchange import ExchangeFault as RefFault
from repro.core.exchange import FaultSpec as RefSpec
from repro.core.exchange import configure_faulty as ref_configure
from repro.core.health import BackoffPolicy as RefBackoff
from repro.core.partition import even_partition as ref_even
from repro.exp import ProbeSpec as RefProbes
from repro_torch import convert, obs
from repro_torch.core import (BackoffPolicy, CapacityConfig, DistConfig,
                              ExchangeFault, FaultSpec, HealthConfig,
                              SimConfig, SimulationHealthError, build_dcsr,
                              configure_faulty, escalate_capacity,
                              even_partition, get_scheme, run_resilient,
                              simulate, simulate_distributed)
from repro_torch.exp import ProbeSpec, StepCurrent, per_neuron

SUGAR = np.arange(80)
PROBES = dict(raster=True, pop_rate=True, drops=True)


@contextlib.contextmanager
def prng_mode(mode: bool):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", mode)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def pin_prng_mode():
    with prng_mode(True):
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread (see tests/test_torch_event.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_faulty():
    """The ``faulty`` schemes are singletons: leave both clean."""
    yield
    ref_configure()
    configure_faulty()


@pytest.fixture(scope="module")
def setup():
    rc = ref_conn.synthetic_flywire(n=400, target_synapses=8_000, seed=0)
    pc = convert.connectome_from_jax(rc)
    return (rc, pc, ref_build_dcsr(rc, ref_even(rc, 4)),
            build_dcsr(pc, even_partition(pc, 4)))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


def _ref_run(rc, cfg, t, **kw):
    return _quiet(ref_simulate, rc, cfg, t, sugar_neurons=SUGAR, seed=3,
                  probes=RefProbes(**PROBES), **kw)


def _port_run(pc, cfg, t, **kw):
    return _quiet(simulate, pc, cfg, t, sugar_neurons=SUGAR, seed=3,
                  probes=ProbeSpec(**PROBES), device="cpu", **kw)


def _ref_dist(rd, cfg, t, **kw):
    return _quiet(ref_simulate_dist, rd, cfg, t, sugar_neurons=SUGAR, seed=3,
                  emulate=True, probes=RefProbes(**PROBES), **kw)


def _port_dist(pd, cfg, t, mode=True, **kw):
    return _quiet(simulate_distributed, pd, cfg, t, sugar_neurons=SUGAR,
                  seed=3, probes=ProbeSpec(**PROBES), device="cpu",
                  partitionable=mode, **kw)


def _host(x) -> np.ndarray:
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _fields(r) -> dict:
    out = {"counts": r.counts, "v": r.state.v, "g": r.state.g,
           "refrac": r.state.refrac, "dropped": np.asarray(r.dropped)}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": v for k, v in r.stats.items()
                if k != "compile_cache"})
    return {k: _host(v) for k, v in out.items()}


def _assert_bitwise(want, got):
    want, got = _fields(want), _fields(got)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k], got[k].astype(want[k].dtype),
                                      err_msg=k)


# --------------------------------------------------------------------------
# BackoffPolicy, escalate_capacity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(base_s=0.05, cap_s=5.0), dict(base_s=0.1, cap_s=0.9,
                                               jitter=0.0),
    dict(base_s=0.2, factor=3.0, cap_s=4.0, jitter=0.5)])
def test_backoff_policy_matches_reference(kw):
    """The same delays for the same seed, attempt by attempt."""
    want, got = RefBackoff(**kw), BackoffPolicy(**kw)
    for seed in (0, 7):
        r1, r2 = random.Random(seed), random.Random(seed)
        assert [got.delay(a, r2) for a in range(0, 9)] == \
            [want.delay(a, r1) for a in range(0, 9)]
    assert got.delay(50, random.Random(1)) <= got.cap_s * (1 + got.jitter)


def test_escalate_capacity_matches_reference():
    for cap in ((512, 65_536, 0), (4, 16, 0), (3, 7, 5), (1, 2, 1)):
        for factor in (1.5, 2.0, 3.0):
            want = ref_escalate(RefCap(*cap), factor)
            got = escalate_capacity(CapacityConfig(*cap), factor)
            assert (got.spike_capacity, got.syn_budget,
                    got.block_capacity) == (want.spike_capacity,
                                            want.syn_budget,
                                            want.block_capacity)
    assert escalate_capacity(None) is None
    for bad in (1.0, 0.5):
        with pytest.raises(ValueError, match="exceed 1"):
            escalate_capacity(CapacityConfig(), bad)
        with pytest.raises(ValueError, match="exceed 1"):
            ref_escalate(RefCap(), bad)


# --------------------------------------------------------------------------
# run_resilient
# --------------------------------------------------------------------------

def _supervise(pkg_run, pkg_obs, attempt_fn, **kw):
    waits, events = [], []
    with pkg_obs.telemetry(events.append, validate=True):
        out = pkg_run(attempt_fn, sleep=waits.append, rng=random.Random(3),
                      **kw)
    return out, waits, [{k: v for k, v in e.items() if k != "t"}
                        for e in events
                        if e["type"] in ("restart", "escalation")]


def test_run_resilient_crash_restarts_match_reference():
    """Three crashes, three jittered waits and three ``restart`` events,
    equal to the reference's; ``backoff=None`` never waits."""
    def flaky(boom):
        def attempt(resume, cap):
            if boom[0]:
                boom[0] -= 1
                raise RuntimeError("transient")
            return "ok"
        return attempt

    backoff = dict(base_s=0.05, factor=2.0, cap_s=0.08, jitter=0.25)
    want = _supervise(ref_run_resilient, ref_obs, flaky([3]), max_restarts=3,
                      backoff=RefBackoff(**backoff))
    got = _supervise(run_resilient, obs, flaky([3]), max_restarts=3,
                     backoff=BackoffPolicy(**backoff))
    assert got == want and got[0] == "ok" and len(got[2]) == 3
    assert [e["attempt"] for e in got[2]] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="transient"):
        run_resilient(flaky([2]), max_restarts=1, sleep=lambda s: None)
    waits = []
    assert run_resilient(flaky([2]), backoff=None,
                         sleep=waits.append) == "ok"
    assert waits == []


def test_run_resilient_escalation_matches_reference(setup, tmp_path):
    """A starved event budget breaches ``max_drop_rate = 0``: each
    escalation doubles the budgets and resumes from the last healthy
    checkpoint; the capacities tried, the events and the converged
    lossless result equal the reference's."""
    rc, pc, _, _ = setup

    def attempts(pkg_sim, pkg_cap, pkg_health, run, directory):
        caps = []
        tiny = pkg_cap(spike_capacity=4, syn_budget=64)

        def attempt(resume, cap):
            cap = cap or tiny
            caps.append((cap.spike_capacity, cap.syn_budget, resume))
            cfg = pkg_sim(engine="event", capacity=cap,
                          health=pkg_health(max_drop_rate=0.0))
            return run(cfg, 80, chunk_steps=20, checkpoint_dir=directory,
                       resume=resume is not None)
        return attempt, caps, tiny

    ra, rcaps, rtiny = attempts(RefSim, RefCap, RefHealth,
                                lambda *a, **k: _ref_run(rc, *a, **k),
                                str(tmp_path / "ref"))
    pa, pcaps, ptiny = attempts(SimConfig, CapacityConfig, HealthConfig,
                                lambda *a, **k: _port_run(pc, *a, **k),
                                str(tmp_path / "port"))
    backoff = dict(base_s=0.01, factor=2.0, cap_s=0.02)
    want = _supervise(ref_run_resilient, ref_obs, ra,
                      checkpoint_dir=str(tmp_path / "ref"), capacity=rtiny,
                      max_escalations=10, backoff=RefBackoff(**backoff))
    got = _supervise(run_resilient, obs, pa,
                     checkpoint_dir=str(tmp_path / "port"), capacity=ptiny,
                     max_escalations=10, backoff=BackoffPolicy(**backoff))
    assert pcaps == rcaps and len(pcaps) > 1
    assert got[1:] == want[1:]
    assert all(e["kind"] == "drop_rate" for e in got[2])
    assert int(got[0].dropped) == 0
    _assert_bitwise(want[0], got[0])


def test_run_resilient_poison_and_declined_escalation(setup):
    """Poison re-raises at once (one call); a drop-rate breach with no
    capacity to escalate surfaces instead of looping."""
    _, pc, _, _ = setup
    poison = StepCurrent(per_neuron([0], np.nan, pc.n), t_on=2, target="v")
    calls = []

    def nan_attempt(resume, cap):
        calls.append(resume)
        return simulate(pc, SimConfig(health=HealthConfig()), 20,
                        stimulus=poison, chunk_steps=10, device="cpu")

    with pytest.raises(SimulationHealthError, match="nonfinite"):
        run_resilient(nan_attempt)
    assert calls == [None]

    def starved(resume, cap):
        cfg = SimConfig(engine="event", capacity=CapacityConfig(4, 64),
                        health=HealthConfig(max_drop_rate=0.0))
        return _port_run(pc, cfg, 80, chunk_steps=20)

    with pytest.raises(SimulationHealthError, match="drop_rate"):
        run_resilient(starved, sleep=lambda s: None)


# --------------------------------------------------------------------------
# the faulty exchange scheme at P = 4
# --------------------------------------------------------------------------

FUSED = {"event": "csr", "blocked": "blocked_fused"}


@pytest.mark.parametrize("inner", ["event", "blocked"])
def test_faulty_partition_failure_recovered(setup, tmp_path, inner):
    """Partition 1 fails at step 20 (inside the second chunk of 16): the
    supervisor restarts from the step-16 checkpoint, and the result is
    bitwise the clean run's and the reference's recovered run's.  With
    inner ``blocked`` the port runs the fused kernel through the wrapper;
    the reference's wrapper has no ``fuses_lif`` and runs the unfused
    one: both give the same bits."""
    _, _, rd, pd = setup
    engine = FUSED[inner]
    clean = _port_dist(pd, DistConfig(sim=SimConfig(engine=engine),
                                      scheme=inner), 50, chunk_steps=16)

    def recover(configure, spec, dist, sim, scheme, run, directory):
        configure(inner=scheme, spec=spec(partition=1, fail_at=(20,)))
        cfg = dist(sim=sim, scheme="faulty")
        attempts = []

        def attempt(resume, cap):
            attempts.append(resume)
            return run(cfg, 50, chunk_steps=16, checkpoint_dir=directory,
                       resume=resume is not None)
        return attempt, attempts

    pa, pattempts = recover(configure_faulty, FaultSpec, DistConfig,
                            SimConfig(engine=engine), inner,
                            lambda *a, **k: _port_dist(pd, *a, **k),
                            str(tmp_path / "port"))
    got = run_resilient(pa, checkpoint_dir=str(tmp_path / "port"),
                        sleep=lambda s: None)
    assert pattempts == [None, 16]           # failed once, resumed once
    _assert_bitwise(clean, got)
    ra, rattempts = recover(ref_configure, RefSpec, RefDist,
                            RefSim(engine=engine), inner,
                            lambda *a, **k: _ref_dist(rd, *a, **k),
                            str(tmp_path / "ref"))
    want = ref_run_resilient(ra, checkpoint_dir=str(tmp_path / "ref"),
                             sleep=lambda s: None)
    assert rattempts == [None, 16]
    _assert_bitwise(want, got)


def test_faulty_failure_exceeds_restarts(setup, tmp_path):
    _, _, _, pd = setup
    configure_faulty(inner="event",
                     spec=FaultSpec(partition=0, fail_at=(4, 20, 36)))
    cfg = DistConfig(sim=SimConfig(engine="event"), scheme="faulty")
    td = str(tmp_path / "ck")
    attempts = []

    def attempt(resume, cap):
        attempts.append(resume)
        return _port_dist(pd, cfg, 50, chunk_steps=16, checkpoint_dir=td,
                          resume=resume is not None)

    with pytest.raises(ExchangeFault, match="partition 0 at step 20"):
        run_resilient(attempt, checkpoint_dir=td, max_restarts=1,
                      sleep=lambda s: None)
    assert attempts == [None, None]          # step 4 fired before a save


@pytest.mark.parametrize("inner,mode", [("event", True), ("event", False),
                                        ("blocked", True)])
def test_faulty_payload_drop_and_corruption(setup, inner, mode):
    """Dropped payloads land in ``dropped`` (more than the clean run's),
    corrupted ones shift the events; the faulty run is bitwise the
    reference's faulty run."""
    _, _, rd, pd = setup
    fx = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
    spec = dict(partition=0, drop_payload_at=tuple(range(20, 50)),
                corrupt_payload_at=(10, 11, 12, 55))
    engine = FUSED[inner]
    clean = _port_dist(pd, DistConfig(sim=SimConfig(engine=engine, **fx),
                                      scheme=inner), 60, mode=mode)
    configure_faulty(inner=inner, spec=FaultSpec(**spec))
    got = _port_dist(pd, DistConfig(sim=SimConfig(engine=engine, **fx),
                                    scheme="faulty"), 60, mode=mode)
    ref_configure(inner=inner, spec=RefSpec(**spec))
    with prng_mode(mode):
        want = _ref_dist(rd, RefDist(sim=RefSim(engine=engine, **fx),
                                     scheme="faulty"), 60)
    _assert_bitwise(want, got)
    assert int(got.dropped) > int(clean.dropped)
    assert not torch.equal(got.records["dropped"], clean.records["dropped"])


def test_faulty_configure_guards():
    for bad in ("faulty", "local"):
        with pytest.raises(ValueError, match="cannot wrap"):
            configure_faulty(inner=bad)
        with pytest.raises(ValueError, match="cannot wrap"):
            ref_configure(inner=bad)
    scheme = configure_faulty(inner="blocked")
    assert scheme is get_scheme("faulty") and scheme.scheme is \
        get_scheme("blocked")
    assert scheme.fuses_lif(SimConfig(engine="blocked_fused"))
    assert not configure_faulty(inner="event").fuses_lif(
        SimConfig(engine="blocked_fused"))
    with pytest.raises(RefFault):
        ref_configure(spec=RefSpec(fail_at=(3,))).host_supervise(0, 5)
    spec = FaultSpec(fail_at=(3,), straggle_at=(1,), straggle_s=0.0)
    faulty = configure_faulty(spec=spec)
    with pytest.raises(ExchangeFault, match="at step 3"):
        faulty.host_supervise(0, 5)
    faulty.host_supervise(0, 5)              # fires once, then proceeds
    assert isinstance(ExchangeFault("x"), RuntimeError)
