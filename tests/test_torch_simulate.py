"""The port's simulate() on sugar_feeding against the JAX package's,
bitwise: counts, LIF state, dropped, and the raster, voltage, pop-rate and
drop records, for the csr, blocked and blocked_fused engines, in float32
and in the paper's Q19.12 configuration, in both threefry modes; plus a
carry converted from a JAX run and continued in both."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectome as ref_conn
from repro.core import engine as ref_engine
from repro.exp import ProbeSpec as RefProbes
from repro.exp import build_scenario as ref_scenario
from repro_torch import convert
from repro_torch.core import SimConfig, init_carry, run_steps, simulate
from repro_torch.exp import ProbeSpec, build_scenario

T_STEPS, SEED = 400, 7
CONFIGS = {"f32": {},
           "q19_12": dict(fixed_point=True, quantize_bits=9,
                          poisson_to_v=False)}
PROBES = dict(raster=True, voltage=(0, 3, 17, 250, 599), pop_rate=True,
              drops=True)


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


@pytest.fixture(scope="module")
def net():
    """tests/test_engines.py's network: n=1500, 45k synapses, seed 3."""
    rc = ref_conn.synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    return rc, convert.connectome_from_jax(rc)


def _result(r) -> dict:
    out = {"counts": r.counts, "v": r.state.v, "g": r.state.g,
           "refrac": r.state.refrac, "dropped": r.dropped}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _assert_bitwise(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


_REF_CACHE: dict = {}


def _reference(rc, cfg_name, mode, engine="csr", t_steps=T_STEPS):
    key = (id(rc), cfg_name, mode, engine, t_steps)
    if key not in _REF_CACHE:
        cfg = ref_engine.SimConfig(engine=engine, **CONFIGS[cfg_name])
        with prng_mode(mode):
            r = ref_engine.simulate(
                rc, cfg, t_steps, seed=SEED,
                stimulus=ref_scenario("sugar_feeding", rc, cfg),
                probes=RefProbes(**PROBES))
            _REF_CACHE[key] = _result(r)
    return _REF_CACHE[key]


def _port(pc, cfg_name, mode, engine, t_steps=T_STEPS):
    cfg = SimConfig(engine=engine, **CONFIGS[cfg_name])
    r = simulate(pc, cfg, t_steps, seed=SEED,
                 stimulus=build_scenario("sugar_feeding", pc, cfg),
                 probes=ProbeSpec(**PROBES), device="cpu",
                 partitionable=mode)
    return _result(r)


@pytest.mark.parametrize("mode", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("engine", ["csr", "blocked", "blocked_fused"])
def test_simulate_matches_reference_csr(net, engine, cfg, mode):
    rc, pc = net
    want = _reference(rc, cfg, mode)
    assert want["counts"].sum() > 0          # the network is driven
    _assert_bitwise(want, _port(pc, cfg, mode, engine))


def test_modes_differ(net):
    """The two threefry modes give different streams, so the mode
    parametrization above is not vacuous."""
    rc, _ = net
    a, b = _reference(rc, "f32", True), _reference(rc, "f32", False)
    assert not np.array_equal(a["rec_raster"], b["rec_raster"])


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_blocked_fused_matches_reference_blocked_fused(cfg):
    """Engine against engine: the reference's Pallas fused kernel (interpret
    mode) and the port's plain fused version, n=600, 60 steps."""
    rc = ref_conn.synthetic_flywire(n=600, target_synapses=15_000, seed=8)
    pc = convert.connectome_from_jax(rc)
    want = _reference(rc, cfg, True, engine="blocked_fused", t_steps=60)
    assert want["counts"].sum() > 0
    _assert_bitwise(want, _port(pc, cfg, True, "blocked_fused", t_steps=60))


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("engine", ["csr", "blocked_fused"])
def test_carry_continuation(net, engine, cfg):
    """JAX runs k steps; its carry is converted; both run k more from it."""
    rc, pc = net
    k = 120
    rcfg = ref_engine.SimConfig(engine="csr", **CONFIGS[cfg])
    stim = ref_scenario("sugar_feeding", rc, rcfg)
    probes = RefProbes(**PROBES)
    syn = ref_engine.build_synapses(rc, rcfg)
    carry = ref_engine._init_carry(rc.n, rcfg, stim, SEED)
    carry, _ = ref_engine._run_scan(syn, carry, stim, rcfg, probes, k, rc.n)
    ported = convert.carry_from_jax(carry, "cpu")
    ring0 = np.array(carry.ring)     # _run_scan donates (deletes) the carry
    assert ported.ptr == k % rcfg.params.delay_steps
    cont, recs = ref_engine._run_scan(syn, carry, stim, rcfg, probes, k,
                                      rc.n, jnp.int32(k))
    pcfg = SimConfig(engine=engine, **CONFIGS[cfg])
    pstim = build_scenario("sugar_feeding", pc, pcfg)
    from repro_torch.core import build_synapses
    pcont, precs = run_steps(build_synapses(pc, pcfg, "cpu"), ported, pstim,
                             pcfg, ProbeSpec(**PROBES), k, pc.n, t0=k)
    want = {"v": cont.lif.v, "g": cont.lif.g, "refrac": cont.lif.refrac,
            "counts": cont.counts, "dropped": cont.dropped,
            "key": np.asarray(cont.key).astype(np.int64),
            **{f"rec_{n}": v for n, v in recs.items()}}
    got = {"v": pcont.lif.v, "g": pcont.lif.g, "refrac": pcont.lif.refrac,
           "counts": pcont.counts, "dropped": pcont.dropped, "key": pcont.key,
           **{f"rec_{n}": v for n, v in precs.items()}}
    _assert_bitwise({k_: np.asarray(v) for k_, v in want.items()},
                    {k_: np.asarray(v) for k_, v in got.items()})
    np.testing.assert_array_equal(np.asarray(cont.ring), pcont.ring.numpy())
    # the converted carry itself was not modified by the port's run
    np.testing.assert_array_equal(ring0, ported.ring.numpy())


def test_legacy_sugar_neurons_and_background(net):
    """The deprecated sugar_neurons= drive and the legacy background drive
    (reconstructed from SimConfig) follow the reference's key layout."""
    rc, pc = net
    for bg in (0.0, 20.0):
        rcfg = ref_engine.SimConfig(background_rate_hz=bg)
        with pytest.warns(DeprecationWarning):
            r = ref_engine.simulate(rc, rcfg, 150, np.arange(20), seed=5)
        with pytest.warns(DeprecationWarning):
            p = simulate(pc, SimConfig(background_rate_hz=bg), 150,
                         np.arange(20), seed=5, device="cpu")
        np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
        np.testing.assert_array_equal(np.asarray(r.state.v),
                                      p.state.v.numpy())
    r = ref_engine.simulate(rc, ref_engine.SimConfig(background_rate_hz=20.0),
                            150, seed=5)
    p = simulate(pc, SimConfig(background_rate_hz=20.0), 150, seed=5,
                 device="cpu")
    assert r.counts.sum() > 0
    np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())


@pytest.mark.parametrize("scenario,kw", [("activity_sweep", {}),
                                         ("silent_baseline", {}),
                                         ("sugar_feeding",
                                          {"background_hz": 30.0})])
def test_other_scenarios_match(net, scenario, kw):
    rc, pc = net
    rcfg, pcfg = ref_engine.SimConfig(), SimConfig()
    r = ref_engine.simulate(rc, rcfg, 120, seed=2,
                            stimulus=ref_scenario(scenario, rc, rcfg, **kw))
    p = simulate(pc, pcfg, 120, seed=2, device="cpu",
                 stimulus=build_scenario(scenario, pc, pcfg, **kw))
    np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
    np.testing.assert_array_equal(np.asarray(r.state.g), p.state.g.numpy())


def test_unported_features_raise(net):
    _, pc = net
    cfg = SimConfig()
    for kw in ({"chunk_steps": 10}, {"checkpoint_dir": "x"},
               {"resume": True}):
        with pytest.raises(NotImplementedError):
            simulate(pc, cfg, 5, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        simulate(pc, SimConfig(health=object()), 5, device="cpu")
    with pytest.raises(NotImplementedError):
        simulate(pc, SimConfig(engine="event"), 5, device="cpu")
    with pytest.raises(ValueError):
        simulate(pc, SimConfig(engine="nope"), 5, device="cpu")
    from repro_torch.core.exchange import get_scheme
    with pytest.raises(NotImplementedError):
        get_scheme("bitmap")
    with pytest.raises(NotImplementedError):
        build_scenario("step_response", pc, cfg)


def test_flywire_config_mirrors_reference():
    from repro.configs import flywire as ref_fw
    from repro_torch.configs import flywire as fw
    for a, b in ((ref_fw.CONFIG, fw.CONFIG), (ref_fw.SMOKE, fw.SMOKE)):
        assert (a.n_neurons, a.target_synapses, a.n_sugar, a.sugar_rate_hz,
                a.t_steps) == (b.n_neurons, b.target_synapses, b.n_sugar,
                               b.sugar_rate_hz, b.t_steps)
        for f in ("engine", "fixed_point", "quantize_bits", "poisson_to_v",
                  "poisson_rate_hz", "poisson_weight", "params"):
            assert getattr(a.sim, f) == getattr(b.sim, f) or (
                f == "params" and dataclasses.asdict(a.sim.params)
                == dataclasses.asdict(b.sim.params)), f
        np.testing.assert_array_equal(a.sugar_neurons(3), b.sugar_neurons(3))


def test_float32_run_long_enough_to_reach_subnormals():
    """A float32 csr run of 5,000 steps at n = 300 under a 0.2 Hz
    background: neurons kicked early decay for over 4,300 quiet steps, so
    their ``g`` would be subnormal (11 of them on the port before it
    flushed as XLA's CPU code does).  Counts and state stay bitwise equal
    to the JAX package."""
    rc = ref_conn.synthetic_flywire(n=300, target_synapses=3000, seed=11)
    pc = convert.connectome_from_jax(rc)
    rcfg, pcfg = ref_engine.SimConfig(engine="csr"), SimConfig(engine="csr")
    r = ref_engine.simulate(rc, rcfg, 5000, seed=4, stimulus=ref_scenario(
        "activity_sweep", rc, rcfg, background_hz=0.2))
    p = simulate(pc, pcfg, 5000, seed=4, device="cpu",
                 stimulus=build_scenario("activity_sweep", pc, pcfg,
                                         background_hz=0.2))
    want, got = _result(r), _result(p)
    assert want["counts"].sum() > 0
    _assert_bitwise(want, got)
