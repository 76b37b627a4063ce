"""The port's monolithic ``event`` engine against the JAX package's
simulate(..., engine="event"), bitwise: counts, LIF state, dropped and the
raster, voltage, pop-rate and drop records on tests/test_engines.py's
network (n = 1,500, 400 steps, seed 7), in float32 and Q19.12, in both
threefry modes; a starved budget whose drops match to the synapse
(mirroring test_event_overflow_drops_exact_and_prefix_delivered); and
auto_capacity for every fanout option."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectome as ref_conn
from repro.core.capacity import CapacityConfig as RefCap
from repro.core import engine as ref_engine
from repro.core.engines import auto_capacity as ref_auto_capacity
from repro.core.engines import get_engine as ref_get_engine
from repro.exp import ProbeSpec as RefProbes
from repro.exp import build_scenario as ref_scenario
from repro_torch import convert
from repro_torch.core import CapacityConfig, SimConfig, build_synapses, simulate
from repro_torch.core.engines import auto_capacity, get_engine
from repro_torch.exp import ProbeSpec, build_scenario

T_STEPS, SEED = 400, 7
CONFIGS = {"f32": {},
           "q19_12": dict(fixed_point=True, quantize_bits=9,
                          poisson_to_v=False)}
PROBES = dict(raster=True, voltage=(0, 3, 17, 250, 1499), pop_rate=True,
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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread.  Its CPU runs are many small
    ops; under the parallel test run every worker's threads contend for
    the cores, and a 100-step event run took 82 s with 8 threads a worker
    and six workers, 0.55 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
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


def _configs(kw, cap=None):
    """The same event config in both packages; ``cap`` = (spike_capacity,
    syn_budget, block_capacity)."""
    rcfg = ref_engine.SimConfig(engine="event", **kw,
                                capacity=cap and RefCap(*cap))
    return rcfg, SimConfig(engine="event", **kw,
                           capacity=cap and CapacityConfig(*cap))


def _run_both(rc, pc, kw, mode, stim_kw=None, t_steps=T_STEPS, cap=None):
    stim_kw = stim_kw or {}
    rcfg, pcfg = _configs(kw, cap)
    with prng_mode(mode):
        want = _result(ref_engine.simulate(
            rc, rcfg, t_steps, seed=SEED,
            stimulus=ref_scenario("sugar_feeding", rc, rcfg, **stim_kw),
            probes=RefProbes(**PROBES)))
    got = _result(simulate(
        pc, pcfg, t_steps, seed=SEED,
        stimulus=build_scenario("sugar_feeding", pc, pcfg, **stim_kw),
        probes=ProbeSpec(**PROBES), device="cpu", partitionable=mode))
    return want, got


@pytest.mark.parametrize("mode", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_event_engine_matches_reference(net, cfg, mode):
    rc, pc = net
    want, got = _run_both(rc, pc, CONFIGS[cfg], mode)
    assert want["counts"].sum() > 0 and want["dropped"] == 0
    _assert_bitwise(want, got)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_starved_event_run_drops_exactly_as_reference(net, cfg):
    """Budgets far below a 100 Hz background's need: both runs drop the
    same synapse events at the same steps, and stay bitwise equal."""
    rc, pc = net
    want, got = _run_both(rc, pc, CONFIGS[cfg], True,
                          dict(background_hz=100.0), 150, cap=(8, 300, 2))
    assert want["dropped"] > 1000
    _assert_bitwise(want, got)


@pytest.mark.parametrize("cap,bcap,budget",
                         [(8, 2, 64), (16, 4, 128), (64, 64, 10**6)])
def test_event_deliver_overflow_matches_reference(net, cap, bcap, budget):
    """One delivery under starved and ample budgets, 40 neurons spiking:
    the same drive, bitwise, and the same exact drop count."""
    rc, pc = net
    rng = np.random.default_rng(0)
    spikes = np.zeros(rc.n, bool)
    spikes[rng.choice(rc.n, 40, replace=False)] = True
    rcfg, pcfg = _configs({}, (cap, budget, bcap))
    g_r, d_r = ref_get_engine("event").deliver(
        ref_engine.build_synapses(rc, rcfg), jnp.asarray(spikes), rcfg)
    g_p, d_p = get_engine("event").deliver(
        build_synapses(pc, pcfg, "cpu"), torch.from_numpy(spikes), pcfg)
    np.testing.assert_array_equal(np.asarray(g_r).view(np.int32),
                                  g_p.numpy().view(np.int32))
    assert int(d_r) == int(d_p)
    assert d_p.dtype == torch.int32
    requested = int(np.diff(rc.out_indptr)[spikes].sum())
    assert (int(d_p) == 0) == (budget >= requested and cap >= 40)


@pytest.mark.parametrize("fanout", ["mean", "max", "p99", "p99.9", "p50"])
@pytest.mark.parametrize("rate_hz", [0.5, 20.0, 400.0])
def test_auto_capacity_matches_reference(net, fanout, rate_hz):
    rc, pc = net
    a = ref_auto_capacity(rc, rate_hz, fanout=fanout)
    b = auto_capacity(pc, rate_hz, fanout=fanout)
    assert (a.spike_capacity, a.syn_budget, a.block_capacity) == (
        b.spike_capacity, b.syn_budget, b.block_capacity)


def test_auto_capacity_rejects_unknown_statistic(net):
    _, pc = net
    with pytest.raises(ValueError):
        auto_capacity(pc, 5.0, fanout="median")
