"""The port's supervision layer against the JAX package's: the health
sentinels; chunked runs (``chunk_steps``, a ragged last chunk) bitwise
equal to the unchunked run and to the reference's chunked run, for
simulate() on csr, event and blocked_fused, simulate_distributed() on the
bitmap scheme at P = 4 and run_trials() at B = 3; the breaches (NaN
poison, the rate envelope, drop_rate under a starved event budget) with
the reference's kind, step and value; kill and resume, with synchronous
and background checkpoint writes, bitwise equal to the uninterrupted
run; the Q19.12 dtype guard; and the checkpoint format itself."""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CapacityConfig as RefCap
from repro.core import HealthConfig as RefHealth
from repro.core import SimConfig as RefSim
from repro.core import SimulationHealthError as RefHealthError
from repro.core import connectome as ref_conn
from repro.core import simulate as ref_simulate
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.distributed import simulate_distributed as ref_simulate_dist
from repro.core.health import health_step_stats as ref_step_stats
from repro.core.neuron import LIFState as RefLIF
from repro.core.partition import even_partition as ref_even
from repro.exp import ProbeSpec as RefProbes
from repro.exp import StepCurrent as RefStep
from repro.exp import per_neuron as ref_per_neuron
from repro.exp import run_trials as ref_run_trials
from repro_torch import convert
from repro_torch.core import (CapacityConfig, DistConfig, SimConfig,
                              build_dcsr, even_partition, simulate,
                              simulate_distributed)
from repro_torch.core.distributed import run_partitioned
from repro_torch.core.health import (HealthConfig, SimulationHealthError,
                                     health_step_stats, lane_snapshots,
                                     snapshot)
from repro_torch.core.neuron import LIFState
from repro_torch.exp import (ProbeSpec, StepCurrent, per_neuron,
                             run_dist_trials, run_trials)
from repro_torch.train import checkpoint as ckpt

FX = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
SUGAR = np.arange(80)


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
    """Run the port on one intra-op thread (see tests/test_torch_event.py:
    under the parallel test run, threads a worker contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_health.py's network: n = 400, 8k synapses, P = 4."""
    rc = ref_conn.synthetic_flywire(n=400, target_synapses=8_000, seed=0)
    pc = convert.connectome_from_jax(rc)
    return (rc, pc, ref_build_dcsr(rc, ref_even(rc, 4), quantize_bits=9),
            build_dcsr(pc, even_partition(pc, 4), quantize_bits=9))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


def _ref(rc, cfg, t, **kw):
    return _quiet(ref_simulate, rc, cfg, t, sugar_neurons=SUGAR, seed=3,
                  probes=RefProbes(raster=True, pop_rate=True), **kw)


def _port(pc, cfg, t, **kw):
    return _quiet(simulate, pc, cfg, t, sugar_neurons=SUGAR, seed=3,
                  probes=ProbeSpec(raster=True, pop_rate=True), device="cpu",
                  **kw)


def _host(x) -> np.ndarray:
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _fields(r) -> dict:
    out = {"counts": r.counts, "v": r.state.v, "g": r.state.g,
           "refrac": r.state.refrac, "dropped": r.dropped}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": v for k, v in r.stats.items()
                if k != "compile_cache"})
    return {k: _host(v) for k, v in out.items()}


def _assert_bitwise(want: dict, got: dict, exact_dtype: bool = True):
    assert sorted(want) == sorted(got)
    for k in want:
        if exact_dtype:
            assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


# --------------------------------------------------------------------------
# sentinels
# --------------------------------------------------------------------------

def test_sentinels_match_reference():
    """Non-finite v/g on the float path, |x| within the margin of the
    int32 limit on Q19.12 (int32 min counts: no abs), per lane."""
    vf = np.array([[0.0, np.nan, np.inf, 1.0], [2.0, 3.0, -np.inf, 0.5]],
                  np.float32)
    gf = np.array([[0.0, 0.0, 0.0, -np.inf], [np.nan, 0.0, 0.0, 0.0]],
                  np.float32)
    big = 1 << 29
    vx = np.array([[0, big, -big, -(2 ** 31)], [big - 1, 1 - big, 7, 0]],
                  np.int32)
    gx = np.array([[0, 0, 2 ** 31 - 1, 0], [0, 0, 0, big]], np.int32)
    for fx, v, g, key in ((False, vf, gf, "h_nonfinite"),
                          (True, vx, gx, "h_saturated")):
        for margin in (2, 3):
            rcfg = RefSim(fixed_point=fx,
                          health=RefHealth(sat_margin_bits=margin))
            cfg = SimConfig(fixed_point=fx,
                            health=HealthConfig(sat_margin_bits=margin))
            got = health_step_stats(LIFState(
                torch.from_numpy(v), torch.from_numpy(g),
                torch.zeros(v.shape, dtype=torch.int32)), cfg)[key]
            assert got.dtype == torch.int32 and got.shape == (2,)
            for b in range(2):
                want = ref_step_stats(RefLIF(
                    jnp.asarray(v[b]), jnp.asarray(g[b]),
                    jnp.zeros(4, jnp.int32)), rcfg)[key]
                assert int(got[b]) == int(want), (fx, margin, b)
    assert health_step_stats(LIFState(torch.from_numpy(vf),
                                      torch.from_numpy(gf), None),
                             SimConfig()) == {}


# --------------------------------------------------------------------------
# chunked == unchunked == the reference's chunked run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine,fx", [("csr", False), ("event", True),
                                       ("blocked_fused", True)])
def test_chunked_simulate_matches_reference(setup, engine, fx):
    rc, pc, _, _ = setup
    kw = FX if fx else {}
    # the reference's csr stands in for its blocked_fused (bitwise equal
    # engines; the Pallas interpret run is slow)
    want = _fields(_ref(rc, RefSim(engine="csr" if engine == "blocked_fused"
                                   else engine, health=RefHealth(), **kw),
                        50, chunk_steps=16))
    cfg = SimConfig(engine=engine, health=HealthConfig(), **kw)
    got = _fields(_port(pc, cfg, 50, chunk_steps=16))      # 16+16+16+2
    _assert_bitwise(want, _engine_counters(got, pc, cfg))
    plain = _fields(_port(pc, SimConfig(engine=engine, **kw), 50))
    _assert_bitwise({k: v for k, v in want.items()
                     if not k.startswith("stat_")},
                    _engine_counters(plain, pc, cfg))


def _engine_counters(fields: dict, pc, cfg) -> dict:
    """The port's fields without blocked_fused's ``syn_events``, which the
    reference does not count, after holding it against the raster: the
    out-degree summed over the spikes delivered (all but the last D
    steps')."""
    fields = dict(fields)
    syn = fields.pop("stat_syn_events", None)
    assert (syn is not None) == (cfg.engine == "blocked_fused")
    if syn is not None:
        D = cfg.params.delay_steps
        delivered = fields["rec_raster"][:-D].astype(np.int64).sum(axis=0)
        assert int(syn) == int(delivered @ np.diff(pc.out_indptr)) > 0
    return fields


def test_chunked_distributed_matches_reference(setup):
    rc, pc, rd, pd = setup
    probes = dict(raster=True, pop_rate=True, drops=True)
    want = _quiet(ref_simulate_dist, rd, RefDist(
        sim=RefSim(health=RefHealth(), **FX), scheme="bitmap"), 50,
        sugar_neurons=SUGAR, seed=3, emulate=True,
        probes=RefProbes(**probes), chunk_steps=16)
    for kw, health in (({"chunk_steps": 16}, HealthConfig()), ({}, None)):
        got = _quiet(simulate_distributed, pd, DistConfig(
            sim=SimConfig(health=health, **FX), scheme="bitmap"), 50,
            sugar_neurons=SUGAR, seed=3, probes=ProbeSpec(**probes),
            device="cpu", **kw)
        w, g = _fields(want), _fields(got)
        if health is None:
            w.pop("stat_h_saturated")
        _assert_bitwise(w, g, exact_dtype=False)


def test_chunked_run_trials_matches_reference(setup):
    rc, pc, _, _ = setup
    from repro.exp import PoissonDrive as RefPoisson
    from repro_torch.exp import PoissonDrive
    rstim = RefPoisson(idx=jnp.asarray(SUGAR, jnp.int32), rate_hz=200.0)
    stim = PoissonDrive(idx=torch.from_numpy(SUGAR.astype(np.int32)),
                        rate_hz=200.0)
    want = ref_run_trials(rc, RefSim(engine="event", health=RefHealth()), 40,
                          seeds=[1, 5, 9], stimulus=rstim,
                          probes=RefProbes(raster=True), chunk_steps=15)
    for kw in ({"chunk_steps": 15}, {}):
        got = run_trials(pc, SimConfig(engine="event", health=HealthConfig()),
                         40, seeds=[1, 5, 9], stimulus=stim,
                         probes=ProbeSpec(raster=True), device="cpu", **kw)
        for f in ("counts", "dropped"):
            np.testing.assert_array_equal(_host(getattr(want, f)),
                                          _host(getattr(got, f)))
        for f in ("v", "g", "refrac"):
            np.testing.assert_array_equal(_host(getattr(want.state, f)),
                                          _host(getattr(got.state, f)))
        np.testing.assert_array_equal(np.asarray(want.records["raster"]),
                                      got.records["raster"].numpy())
    assert int(np.asarray(want.counts).sum()) > 0


def test_supervision_rejects_the_trial_path(setup):
    _, pc, _, pd = setup
    dcfg = DistConfig(sim=SimConfig(health=HealthConfig()), scheme="event")
    with pytest.raises(ValueError, match="trial-batched"):
        run_dist_trials(pd, dcfg, 10, seeds=2, device="cpu")
    keys = torch.zeros((4, 2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="trial-batched"):
        run_partitioned(pd, DistConfig(sim=SimConfig(), scheme="event"), 10,
                        keys, None, None, None, "cpu", True, trials=True,
                        chunk_steps=5)
    with pytest.raises(ValueError, match="positive"):
        simulate(pc, SimConfig(), 10, device="cpu", chunk_steps=-1)


# --------------------------------------------------------------------------
# breaches: the reference's kind, step and value
# --------------------------------------------------------------------------

def _breach(fn):
    with pytest.raises((SimulationHealthError, RefHealthError)) as ei:
        fn()
    e = ei.value
    return e.kind, e.step, e.value, e.threshold


def test_breaches_match_reference(setup):
    rc, pc, _, _ = setup
    # NaN poison from step 2 (NaN * gate stays NaN before t_on, too)
    rpoison = RefStep(ref_per_neuron([0], np.nan, rc.n), t_on=2, target="v")
    poison = StepCurrent(per_neuron([0], np.nan, pc.n), t_on=2, target="v")
    want = _breach(lambda: ref_simulate(
        rc, RefSim(health=RefHealth()), 40, stimulus=rpoison, chunk_steps=10))
    got = _breach(lambda: simulate(
        pc, SimConfig(health=HealthConfig()), 40, stimulus=poison,
        chunk_steps=10, device="cpu"))
    assert want[0] == "nonfinite" and want[1] == 10 and got == want
    # the rate envelope
    want = _breach(lambda: _ref(rc, RefSim(engine="event", health=RefHealth(
        rate_hi_hz=1e-6)), 60, chunk_steps=20))
    got = _breach(lambda: _port(pc, SimConfig(engine="event", health=(
        HealthConfig(rate_hi_hz=1e-6))), 60, chunk_steps=20))
    assert want[0] == "rate_envelope" and got == want
    # drop_rate under a starved event budget
    want = _breach(lambda: _ref(rc, RefSim(
        engine="event", capacity=RefCap(2, 16),
        health=RefHealth(max_drop_rate=1.0)), 60, chunk_steps=20))
    got = _breach(lambda: _port(pc, SimConfig(
        engine="event", capacity=CapacityConfig(2, 16),
        health=HealthConfig(max_drop_rate=1.0)), 60, chunk_steps=20))
    assert want[0] == "drop_rate" and want[2] > 1.0 and got == want


# --------------------------------------------------------------------------
# kill and resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("async_save", [False, True])
def test_kill_and_resume_bitwise(setup, tmp_path, async_save):
    _, pc, _, _ = setup
    cfg = SimConfig(engine="event", health=HealthConfig(), **FX)
    want = _fields(_port(pc, cfg, 50, chunk_steps=16))
    td = str(tmp_path / "ck")
    # "kill" after 2 chunks: a partial run leaving only its checkpoints
    _port(pc, cfg, 32, chunk_steps=16, checkpoint_dir=td,
          async_checkpoint=async_save)
    assert ckpt.latest_step(td) == 32
    got = _fields(_port(pc, cfg, 50, chunk_steps=16, checkpoint_dir=td,
                        resume=True, async_checkpoint=async_save))
    _assert_bitwise(want, got)
    assert ckpt.latest_step(td) == 50


def test_kill_and_resume_distributed(setup, tmp_path):
    _, _, _, pd = setup
    dcfg = DistConfig(sim=SimConfig(**FX), scheme="event")

    def run(t, **kw):
        return _fields(_quiet(simulate_distributed, pd, dcfg, t,
                              sugar_neurons=SUGAR, seed=3,
                              probes=ProbeSpec(raster=True), device="cpu",
                              chunk_steps=16, **kw))
    want = run(50)
    td = str(tmp_path / "ck")
    run(32, checkpoint_dir=td, async_checkpoint=True)
    _assert_bitwise(want, run(50, checkpoint_dir=td, resume=True))


def test_resume_q19_12_dtype_guard(setup, tmp_path):
    """A Q19.12 checkpoint restored into a float-path template raises,
    never casts."""
    _, pc, _, _ = setup
    td = str(tmp_path / "ck")
    _port(pc, SimConfig(engine="event", fixed_point=True), 32,
          chunk_steps=16, checkpoint_dir=td)
    with pytest.raises(ValueError, match="dtype mismatch"):
        _port(pc, SimConfig(engine="event"), 50, chunk_steps=16,
              checkpoint_dir=td, resume=True)


def test_checkpoint_roundtrip_and_snapshot(tmp_path):
    """The tree format: NamedTuples, dicts, tuples and a Python int round
    trip; a background save holds the values at call time even when the
    caller writes its tensors in place right after; a shape mismatch and a
    writer failure raise; lane snapshots attribute counters per lane."""
    from repro_torch.core.step import SimCarry
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    carry = SimCarry(lif=LIFState(x.float(), x.float(), x.clone()),
                     ring=torch.zeros((3, 2, 3), dtype=torch.bool), ptr=2,
                     key=torch.ones((2, 2), dtype=torch.int64),
                     counts=x.clone(), dropped=torch.tensor([1, 4],
                                                            dtype=torch.int32),
                     stim=((),), stats={"h_nonfinite": torch.tensor(
                         [0, 3], dtype=torch.int32)})
    h = ckpt.save_checkpoint(str(tmp_path), 7, {"carry": carry},
                             metadata={"sim_step": 7}, async_save=True)
    carry.counts.add_(100)                        # written in place at once
    h.join()
    tmpl = carry._replace(ptr=0)
    tree, meta = ckpt.restore_checkpoint(str(tmp_path), 7, {"carry": tmpl})
    got = tree["carry"]
    assert meta == {"sim_step": 7} and got.ptr == 2 and got.stim == ((),)
    np.testing.assert_array_equal(got.counts.numpy(), x.numpy())
    np.testing.assert_array_equal(got.stats["h_nonfinite"].numpy(), [0, 3])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), 7, {"carry": tmpl._replace(
            counts=torch.zeros(3, dtype=torch.int32))})
    (tmp_path / "f").write_text("a file where a directory must go")
    bad = ckpt.save_checkpoint(str(tmp_path / "f" / "x"), 1,
                               {"a": torch.ones(1)}, async_save=True)
    with pytest.raises(OSError):
        bad.join()
    lanes = lane_snapshots(50, carry)
    assert [(s.spikes, s.dropped, s.nonfinite) for s in lanes] == \
        [(303, 1, 0), (312, 4, 3)]
    assert snapshot(50, carry).spikes == 615
