"""The port's clocked stimuli and its seven scenarios against the JAX
package's, bitwise: each clocked stimulus's drive over every step of a
window around its edges (RampDrive at t_ramp 3, 7 and 200, where XLA's
multiply by the float32 reciprocal of t_ramp differs from a division);
each scenario's stimulus built by both packages; simulate() of the four
scenarios added here on csr against the reference and on the port's
blocked_fused (its plain path) against the same run, in float32 and
Q19.12, counts, state, dropped and raster; one P = 4
simulate_distributed of opto_ramp on the event scheme."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectome as ref_conn
from repro.core import engine as ref_engine
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.distributed import simulate_distributed as ref_simulate_dist
from repro.core.neuron import FLYWIRE_LIF as REF_LIF
from repro.core.partition import even_partition as ref_even
from repro.exp import ProbeSpec as RefProbes
from repro.exp import build_scenario as ref_scenario
from repro.exp import stimulus as ref_stim
from repro_torch import convert
from repro_torch.core import (DistConfig, SimConfig, build_dcsr,
                              even_partition, simulate, simulate_distributed)
from repro_torch.core.neuron import FLYWIRE_LIF
from repro_torch.exp import ProbeSpec, available_scenarios, build_scenario
from repro_torch.exp import stimulus as stim

CONFIGS = {"f32": {},
           "q19_12": dict(fixed_point=True, quantize_bits=9,
                          poisson_to_v=False)}
# the four scenarios added with the clocked stimuli, sized so that every
# window edge falls inside a 150-step run
NEW = {"background_storm": {},
       "step_response": dict(t_on=30, t_off=110),
       "pulse_probe": dict(period_ms=3.7, width_ms=0.6, t_on=7),
       "opto_ramp": dict(n_targets=150, t_on_ms=1.3, ramp_ms=0.7,
                         t_off_ms=12.0)}
T_STEPS = 150


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
def net():
    rc = ref_conn.synthetic_flywire(n=600, target_synapses=18_000, seed=3)
    return rc, convert.connectome_from_jax(rc)


def _bits(x) -> np.ndarray:
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


# --------------------------------------------------------------------------
# the clocked stimuli, step by step
# --------------------------------------------------------------------------

W = np.array([60.0, -37.5, 0.0, 1e-3, 1e6, np.nan], np.float32)

CLOCKED = [
    ("StepCurrent", dict(t_on=5, t_off=17), range(0, 25)),
    ("StepCurrent", dict(t_on=3, t_off=None, target="v"), range(0, 10)),
    ("PulseTrain", dict(period=7, width=3, t_on=4, n_pulses=3), range(0, 40)),
    ("PulseTrain", dict(period=5, width=1, t_on=0), range(0, 30)),
    ("RampDrive", dict(t_on=2, t_ramp=3, t_off=12), range(0, 16)),
    ("RampDrive", dict(t_on=5, t_ramp=7, t_off=None, target="v"),
     range(0, 20)),
    ("RampDrive", dict(t_on=50, t_ramp=200, t_off=240), range(40, 260)),
]


@pytest.mark.parametrize("name,kw,ts", CLOCKED,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(CLOCKED)])
def test_clocked_step_matches_reference(name, kw, ts):
    """The drive of each step equals the reference's jitted ``step``
    bitwise (a NaN weight stays NaN outside the window, a negative one
    gives -0)."""
    ref = getattr(ref_stim, name)(weights=jnp.asarray(W), **kw)
    got = getattr(stim, name)(weights=torch.from_numpy(W), **kw)
    target = kw.get("target", "g")
    field = "v_mv" if target == "v" else "g_units"

    @jax.jit
    def ref_step(t):
        return getattr(ref.step((), None, t, W.size, REF_LIF)[1], field)

    for t in ts:
        want = ref_step(jnp.int32(t))
        state, drive = got.step((), None, t, W.size, FLYWIRE_LIF)
        assert state == ()
        other = "g_units" if field == "v_mv" else "v_mv"
        assert getattr(drive, other) is None and drive.force is None
        np.testing.assert_array_equal(_bits(want),
                                      _bits(getattr(drive, field)),
                                      err_msg=f"{name} t={t}")


def test_ramp_reciprocal_is_not_a_division():
    """At t_ramp = 200 the float32 reciprocal multiply and an IEEE
    division give different gates on some steps: the test above holds the
    port to the former, which is what XLA compiles."""
    r = stim.RampDrive(weights=torch.ones(1), t_on=0, t_ramp=200)
    differ = sum(r.gate(t) != np.float32(np.float32(t) / np.float32(200))
                 for t in range(210))
    assert differ > 0


def test_per_neuron_and_target():
    w = stim.per_neuron([1, 3], 2.5, 5)
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(ref_stim.per_neuron([1, 3], 2.5,
                                                                 5)))
    with pytest.raises(ValueError, match="target"):
        stim.StepCurrent(weights=w, target="x").step((), None, 0, 5,
                                                     FLYWIRE_LIF)


def test_clocked_stimuli_shard_and_move():
    """``shard_stimulus`` turns the [n] weights into [P, U] through the
    renumbering (pads zero), as the reference's does."""
    rc = ref_conn.synthetic_flywire(n=300, target_synapses=3_000, seed=1)
    pc = convert.connectome_from_jax(rc)
    rd = ref_build_dcsr(rc, ref_even(rc, 4))
    pd = build_dcsr(pc, even_partition(pc, 4))
    w = np.arange(300, dtype=np.float32)
    for name, kw in (("StepCurrent", {}), ("PulseTrain", {}),
                     ("RampDrive", {})):
        ref = ref_stim.shard_stimulus(ref_stim.Compose((getattr(
            ref_stim, name)(weights=jnp.asarray(w), **kw),)), rd)
        got = stim.shard_stimulus(stim.Compose((getattr(stim, name)(
            weights=torch.from_numpy(w), **kw),)), pd)
        assert got.parts[0].weights.shape == (4, pd.part_size)
        np.testing.assert_array_equal(np.asarray(ref.parts[0].weights),
                                      got.parts[0].weights.numpy())
        assert got.to("cpu").parts[0].weights.device.type == "cpu"


# --------------------------------------------------------------------------
# the scenario registry
# --------------------------------------------------------------------------

def _leaves(x, path=""):
    """(path, leaf) pairs of a stimulus: tensors / arrays and the static
    fields, in declaration order."""
    if dataclasses.is_dataclass(x):
        yield path, type(x).__name__
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(x, (torch.Tensor, jax.Array)):
        yield path, _bits(x)
    else:
        yield path, x


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_every_scenario_builds_the_reference_stimulus(net, cfg_name):
    rc, pc = net
    from repro.exp import available_scenarios as ref_available
    assert available_scenarios() == ref_available()
    assert len(available_scenarios()) == 7
    for name in available_scenarios():
        want = list(_leaves(ref_scenario(
            name, rc, ref_engine.SimConfig(**CONFIGS[cfg_name]))))
        got = list(_leaves(build_scenario(name, pc,
                                          SimConfig(**CONFIGS[cfg_name]))))
        assert [p for p, _ in want] == [p for p, _ in got], name
        for (p, a), (_, b) in zip(want, got):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (name, p)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}{p}")
            else:
                assert a == b, (name, p)


# --------------------------------------------------------------------------
# simulate() of the new scenarios
# --------------------------------------------------------------------------

def _fields(r) -> dict:
    out = {"counts": r.counts, "v": r.state.v, "g": r.state.g,
           "refrac": r.state.refrac, "dropped": r.dropped,
           "raster": r.raster}
    return {k: _bits(v) for k, v in out.items()}


def _assert_bitwise(want: dict, got: dict):
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


CASES = ([("background_storm", c, m) for c in CONFIGS for m in (True, False)]
         + [(s, c, True) for s in ("step_response", "pulse_probe",
                                   "opto_ramp") for c in CONFIGS])


@pytest.mark.parametrize("scenario,cfg_name,mode", CASES)
def test_simulate_scenario_matches_reference(net, scenario, cfg_name, mode):
    rc, pc = net
    kw = NEW[scenario]
    with prng_mode(mode):
        rcfg = ref_engine.SimConfig(engine="csr", **CONFIGS[cfg_name])
        r = ref_engine.simulate(
            rc, rcfg, T_STEPS, seed=4,
            stimulus=ref_scenario(scenario, rc, rcfg, **kw),
            probes=RefProbes(raster=True))
        want = _fields(r)
    assert want["counts"].sum() > 0
    for engine in ("csr", "blocked_fused"):
        cfg = SimConfig(engine=engine, **CONFIGS[cfg_name])
        got = simulate(pc, cfg, T_STEPS, seed=4, device="cpu",
                       stimulus=build_scenario(scenario, pc, cfg, **kw),
                       probes=ProbeSpec(raster=True), partitionable=mode)
        _assert_bitwise(want, _fields(got))


def test_distributed_opto_ramp_matches_reference(net):
    rc, pc = net
    kw = NEW["opto_ramp"]
    fx = CONFIGS["q19_12"]
    rd = ref_build_dcsr(rc, ref_even(rc, 4), quantize_bits=9)
    pd = build_dcsr(pc, even_partition(pc, 4), quantize_bits=9)
    rcfg = RefDist(sim=ref_engine.SimConfig(**fx), scheme="event")
    r = ref_simulate_dist(rd, rcfg, 130, seed=2, emulate=True,
                          stimulus=ref_scenario("opto_ramp", rc, rcfg.sim,
                                                **kw),
                          probes=RefProbes(raster=True))
    cfg = DistConfig(sim=SimConfig(**fx), scheme="event")
    p = simulate_distributed(pd, cfg, 130, seed=2, device="cpu",
                             stimulus=build_scenario("opto_ramp", pc,
                                                     cfg.sim, **kw),
                             probes=ProbeSpec(raster=True))
    assert int(np.asarray(r.counts).sum()) > 0
    np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
    np.testing.assert_array_equal(np.asarray(r.raster), p.raster.numpy())
    for f in ("v", "g", "refrac"):
        np.testing.assert_array_equal(_bits(getattr(r.state, f)),
                                      _bits(getattr(p.state, f)))
    assert r.dropped == p.dropped
