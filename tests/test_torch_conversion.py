"""float32 -> int32 conversion with XLA's semantics.

XLA's convert saturates and maps NaN to 0; ``.to(torch.int32)`` on the
CPU maps NaN, the infinities and every value out of range to INT_MIN.
The port converts through ``core.neuron.f32_to_i32`` at every such site
of the step: ``mv_to_fx``, ``apply_drive``'s ``g_in`` and ``v_fx``, and
the fused kernel's plain version.  Pinned here against the JAX package:
the helper and ``mv_to_fx`` value for value, and a Q19.12 run whose
drive saturates (a ``step_response`` of amplitude NaN, inf or 1e13 onto
the conductance, and a step of 1e13 onto the voltage), whose final state
must be the reference's: before the repair it differed in the 100
driven neurons."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core import simulate as ref_simulate
from repro.core.neuron import FLYWIRE_LIF as REF_P
from repro.core.neuron import mv_to_fx as ref_mv_to_fx
from repro.exp import StepCurrent as RefStep
from repro.exp import build_scenario as ref_scenario
from repro.exp import per_neuron as ref_per_neuron
from repro_torch import convert
from repro_torch.core import SimConfig, simulate
from repro_torch.core.neuron import FLYWIRE_LIF as P
from repro_torch.core.neuron import INT32_MAX, f32_to_i32, mv_to_fx
from repro_torch.exp import StepCurrent, build_scenario, per_neuron

FX = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)
SIX = [np.nan, np.inf, -np.inf, 1e9, -1e9, 1.5]


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


@pytest.fixture(scope="module")
def nets():
    rc = ref_conn.synthetic_flywire(n=300, target_synapses=6_000, seed=1)
    return rc, convert.connectome_from_jax(rc)


def test_f32_to_i32_matches_xla():
    edge = [2.0**31, -2.0**31, 2147483520.0, -2147483904.0, 0.5, 2.5, -2.5,
            -0.0, 3e38, -3e38, 1e-40]
    x = np.array(SIX + edge, np.float32)
    want = np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int32))
    got = f32_to_i32(torch.round(torch.from_numpy(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        f32_to_i32(torch.from_numpy(np.array(SIX, np.float32))).numpy(),
        [0, INT32_MAX, -2**31, 1_000_000_000, -1_000_000_000, 1])


def test_mv_to_fx_matches_reference():
    x = np.array(SIX, np.float32)
    want = np.asarray(ref_mv_to_fx(jnp.asarray(x), REF_P))
    got = mv_to_fx(torch.from_numpy(x), P).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [0, INT32_MAX, -2**31, INT32_MAX, -2**31, 22342])


def _state(r) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in (("counts", r.counts), ("v", r.state.v),
                         ("g", r.state.g), ("refrac", r.state.refrac))}


@pytest.mark.parametrize("engine", ["csr", "blocked_fused"])
@pytest.mark.parametrize("amp", [np.nan, np.inf, 1e13],
                         ids=["nan", "inf", "1e13"])
def test_saturating_step_response_matches_reference(nets, amp, engine):
    """A conductance step that saturates the Q19.12 input: the final
    counts and state equal the reference's (csr; the port's
    blocked_fused runs the fused kernel's plain version)."""
    rc, pc = nets
    kw = dict(amp=float(amp), t_on=5, t_off=40)
    rcfg, cfg = RefSim(engine="csr", **FX), SimConfig(engine=engine, **FX)
    want = ref_simulate(rc, rcfg, 60, seed=1,
                        stimulus=ref_scenario("step_response", rc, rcfg,
                                              **kw))
    got = simulate(pc, cfg, 60, seed=1, device="cpu",
                   stimulus=build_scenario("step_response", pc, cfg, **kw))
    w, g = _state(want), _state(got)
    for k in w:
        np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    if not np.isnan(amp):
        assert int(np.count_nonzero(g["g"])) > 0   # the step drove them


def test_saturating_voltage_step_matches_reference(nets):
    """The same on the voltage channel (``apply_drive``'s ``v_fx``)."""
    rc, pc = nets
    ids = np.arange(0, 300, 3)
    want = ref_simulate(rc, RefSim(**FX), 30, seed=1,
                        stimulus=RefStep(ref_per_neuron(ids, 1e13, rc.n),
                                         t_on=2, t_off=20, target="v"))
    got = simulate(pc, SimConfig(**FX), 30, seed=1, device="cpu",
                   stimulus=StepCurrent(per_neuron(ids, 1e13, pc.n),
                                        t_on=2, t_off=20, target="v"))
    w, g = _state(want), _state(got)
    for k in w:
        np.testing.assert_array_equal(w[k], g[k], err_msg=k)
