"""The port's trial batches (repro_torch.exp.trials) against the JAX
package's, bitwise: ``run_trials`` for the csr, event, blocked and
blocked_fused engines in float32 and Q19.12 and both threefry modes, with
every probe record ``[B, T, ...]``; ``run_dist_trials`` for the bitmap,
event and blocked schemes (the last unfused and fused) at P = 4 and the
uneven P = 3 with pad neurons, the tile counters per lane included, and
on the JAX CLI's partition path (greedy SAR, then ``pad_to_uniform``).
Each lane is also held against the port's own single run of its seed.
Networks: tests/test_fused.py's (n = 1,000) and an n = 600 one for the
CLI path.  The reference's blocked runs go through Pallas interpret
mode."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core.capacity import CapacityConfig as RefCap
from repro.core.compress import CoreBudget as RefBudget
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.partition import caps_from_budget as ref_caps
from repro.core.partition import even_partition as ref_even
from repro.core.partition import greedy_partition as ref_greedy
from repro.core.partition import pad_to_uniform as ref_pad
from repro.exp import ProbeSpec as RefProbes
from repro.exp import build_scenario as ref_scenario
from repro.exp import run_dist_trials as ref_run_dist_trials
from repro.exp import run_trials as ref_run_trials
from repro.exp import trial_carry as ref_trial_carry
from repro_torch import convert
from repro_torch.core import (CapacityConfig, DistConfig, SimConfig,
                              build_dcsr, even_partition, greedy_partition,
                              pad_to_uniform, simulate, simulate_distributed)
from repro_torch.core.compress import CoreBudget
from repro_torch.core.partition import caps_from_budget
from repro_torch.exp import (ProbeSpec, build_scenario, run_dist_trials,
                             run_trials, trial_carry)

SEEDS = (3, 11, 42)
T_MONO, T_DIST = 80, 60
PROBES = dict(raster=True, voltage=(0, 5, 401, 999), pop_rate=True,
              drops=True)
CONFIGS = {"f32": {},
           "q19_12": dict(fixed_point=True, quantize_bits=9,
                          poisson_to_v=False)}
SCHEMES = {"bitmap": ("bitmap", "csr"), "event": ("event", "csr"),
           "blocked": ("blocked", "csr"),
           "blocked_fused": ("blocked", "blocked_fused")}


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
    """Run the port on one intra-op thread (see test_torch_distributed.py:
    under the parallel test run, many threads a worker contend for the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    """tests/test_fused.py's network: n = 1,000, 25k synapses, seed 5."""
    rc = ref_conn.synthetic_flywire(n=1000, target_synapses=25_000, seed=5)
    return rc, convert.connectome_from_jax(rc)


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _result(r) -> dict:
    out = {"counts": r.counts, "dropped": r.dropped, "v": r.state.v,
           "g": r.state.g, "refrac": r.state.refrac}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": v for k, v in getattr(r, "stats", {}).items()})
    return {k: _np(v) for k, v in out.items()}


def _assert_bitwise(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype, a.shape,
                                                           b.shape)
        if a.dtype.kind == "f":
            a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=k)


def _mono_both(net, engine, cfg_name, *, mode=True, cap=None,
               background_hz=20.0, t_steps=T_MONO):
    rc, pc = net
    kw = dict(engine=engine, **CONFIGS[cfg_name])
    rcfg = RefSim(**kw, capacity=cap and RefCap(*cap))
    pcfg = SimConfig(**kw, capacity=cap and CapacityConfig(*cap))
    with prng_mode(mode):
        want = ref_run_trials(
            rc, rcfg, t_steps, seeds=list(SEEDS),
            stimulus=ref_scenario("sugar_feeding", rc, rcfg,
                                  background_hz=background_hz),
            probes=RefProbes(**PROBES))
    got = run_trials(pc, pcfg, t_steps, seeds=list(SEEDS),
                     stimulus=build_scenario("sugar_feeding", pc, pcfg,
                                             background_hz=background_hz),
                     probes=ProbeSpec(**PROBES), device="cpu",
                     partitionable=mode)
    return want, got


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("engine", ["csr", "event", "blocked",
                                    "blocked_fused"])
def test_run_trials_matches_reference(net, engine, cfg):
    want, got = _mono_both(net, engine, cfg)
    assert got.seeds == want.seeds == SEEDS
    w, g = _result(want), _result(got)
    assert w["counts"].shape == (3, 1000) and w["rec_raster"].shape == (
        3, T_MONO, 1000) and w["rec_v"].shape == (3, T_MONO, 4)
    assert w["rec_pop_rate_hz"].shape == w["rec_dropped"].shape == (3,
                                                                   T_MONO)
    # the lanes are different trials
    assert all(w["counts"][b].sum() > 0 for b in range(3))
    assert not np.array_equal(w["counts"][0], w["counts"][1])
    _assert_bitwise(w, g)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("engine", ["csr", "blocked_fused"])
def test_run_trials_original_threefry_mode(net, engine, cfg):
    want, got = _mono_both(net, engine, cfg, mode=False)
    _assert_bitwise(_result(want), _result(got))


def test_run_trials_starved_event_capacity(net):
    """Budgets far below a 200 Hz background's need: each lane drops on
    its own budget, as under the reference's vmap."""
    want, got = _mono_both(net, "event", "q19_12", cap=(8, 256, 2),
                           background_hz=200.0, t_steps=40)
    w = _result(want)
    assert (w["dropped"] > 0).all() and len(set(w["dropped"].tolist())) > 1
    _assert_bitwise(w, _result(got))


@pytest.mark.parametrize("engine", ["event", "blocked_fused"])
def test_run_trials_equals_simulate_per_seed(net, engine):
    """Lane b of the port's batch is the port's own simulate(seed=s_b) (a
    trial batch returns no stats: the lane's fields without them)."""
    _, pc = net
    cfg = SimConfig(engine=engine, **CONFIGS["q19_12"])
    stim = build_scenario("sugar_feeding", pc, cfg, background_hz=20.0)
    probes = ProbeSpec(**PROBES)
    res = run_trials(pc, cfg, T_MONO, seeds=list(SEEDS), stimulus=stim,
                     probes=probes, device="cpu")
    for b, s in enumerate(SEEDS):
        one = simulate(pc, cfg, T_MONO, seed=s, stimulus=stim, probes=probes,
                       device="cpu")
        lane = {"counts": res.counts[b], "dropped": res.dropped[b],
                "v": res.state.v[b], "g": res.state.g[b],
                "refrac": res.state.refrac[b],
                **{f"rec_{k}": v[b] for k, v in res.records.items()}}
        want = {k: v for k, v in _result(one).items()
                if not k.startswith("stat_")}
        _assert_bitwise(want, {k: _np(v) for k, v in lane.items()})


def test_trial_carry_matches_reference(net):
    rc, pc = net
    rcfg, pcfg = RefSim(**CONFIGS["q19_12"]), SimConfig(**CONFIGS["q19_12"])
    want, ws = ref_trial_carry(rc.n, rcfg, ref_scenario("sugar_feeding", rc,
                                                        rcfg), 4)
    got, gs = trial_carry(pc.n, pcfg, build_scenario("sugar_feeding", pc,
                                                     pcfg), 4, "cpu")
    assert ws == gs == (0, 1, 2, 3)
    np.testing.assert_array_equal(np.asarray(want.key).astype(np.int64),
                                  got.key.numpy())
    for a, b in zip(want.lif, got.lif):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the port's ring is [D, B, n], the reference's [B, D, n]
    assert tuple(got.ring.shape) == (rcfg.params.delay_steps, 4, rc.n)
    np.testing.assert_array_equal(np.asarray(want.ring).transpose(1, 0, 2),
                                  got.ring.numpy())
    assert got.counts.shape == (4, rc.n) and got.dropped.shape == (4,)


def test_rates_and_seed_forms(net):
    rc, pc = net
    rcfg, pcfg = RefSim(), SimConfig()
    want = ref_run_trials(rc, rcfg, 40, np.arange(20), seeds=2)
    with pytest.warns(DeprecationWarning):
        got = run_trials(pc, pcfg, 40, np.arange(20), seeds=2, device="cpu")
    assert got.seeds == want.seeds == (0, 1)
    for fn in ("rates_hz", "mean_rates_hz"):
        a = getattr(want, fn)(40, 0.1)
        b = getattr(got, fn)(40, 0.1)
        assert b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got.mean_rates_hz(40, 0.1).max() > 0


def test_unported_and_bad_arguments(net):
    _, pc = net
    with pytest.raises(ValueError, match="seed"):
        run_trials(pc, SimConfig(), 3, seeds=[], device="cpu")
    # chunk_steps is ported (tests/test_torch_health.py); a chunk size
    # below 1 is refused as the reference refuses it
    with pytest.raises(ValueError, match="positive"):
        run_trials(pc, SimConfig(), 3, seeds=2, chunk_steps=-1, device="cpu")
    d = build_dcsr(pc, even_partition(pc, 2))
    dcfg = DistConfig(sim=SimConfig(), scheme="event")
    # the multi-process path is ported (tests/test_torch_multiprocess.py):
    # it needs a process group, and a mesh is a CoreMesh
    with pytest.raises(RuntimeError, match="no process group"):
        run_dist_trials(d, dcfg, 3, seeds=2, emulate=False, device="cpu")
    with pytest.raises(TypeError, match="CoreMesh"):
        run_dist_trials(d, dcfg, 3, seeds=2, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_trials(pc, SimConfig(), 3, seeds=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_dist_trials(d, dcfg, 3, seeds=2)


# --------------------------------------------------------------------------
# run_dist_trials
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dcsrs(net):
    rc, pc = net
    return {P_: (ref_build_dcsr(rc, ref_even(rc, P_), quantize_bits=9),
                 build_dcsr(pc, even_partition(pc, P_), quantize_bits=9))
            for P_ in (4, 3)}


def _sim_kw(engine, fx, background_hz=20.0):
    return dict(engine=engine, quantize_bits=9, fixed_point=fx,
                poisson_to_v=not fx, background_rate_hz=background_hz)


def _dist_both(dd, scheme, fx, t_steps=T_DIST, probes=PROBES, sugar=None,
               stimulus=None, seeds=SEEDS):
    rd, pd = dd
    name, engine = SCHEMES[scheme]
    kw = _sim_kw(engine, fx)
    rstim, pstim = stimulus if stimulus is not None else (None, None)
    want = ref_run_dist_trials(
        rd, RefDist(sim=RefSim(**kw), scheme=name), t_steps, sugar,
        seeds=list(seeds), stimulus=rstim, probes=RefProbes(**probes),
        emulate=True)
    got = run_dist_trials(
        pd, DistConfig(sim=SimConfig(**kw), scheme=name), t_steps, sugar,
        seeds=list(seeds), stimulus=pstim, probes=ProbeSpec(**probes),
        device="cpu")
    return want, got


@pytest.mark.parametrize("P_", [4, 3])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_run_dist_trials_matches_reference(dcsrs, scheme, P_):
    """Bitwise in counts, state, dropped, every record and the tile
    counters, lane by lane; P = 3 has 8 pad neurons."""
    fx = scheme in ("bitmap", "blocked_fused")
    want, got = _dist_both(dcsrs[P_], scheme, fx, sugar=np.arange(20))
    w = _result(want)
    assert w["counts"].shape == (3, 1000) and w["rec_raster"].shape == (
        3, T_DIST, 1000)
    assert all(w["counts"][b].sum() > 0 for b in range(3))
    if scheme.startswith("blocked"):
        assert w["stat_tiles_live"].shape == (3,)
        assert len(set(w["stat_tiles_live"].tolist())) > 1
    assert got.seeds == SEEDS
    _assert_bitwise(w, _result(got))


def test_run_dist_trials_equals_simulate_distributed(dcsrs):
    """Lane b is the port's own simulate_distributed(seed=s_b)."""
    _, pd = dcsrs[3]
    cfg = DistConfig(sim=SimConfig(**_sim_kw("blocked_fused", True)),
                     scheme="blocked")
    res = run_dist_trials(pd, cfg, T_DIST, np.arange(20), seeds=SEEDS[:2],
                          probes=ProbeSpec(**PROBES), device="cpu")
    for b, s in enumerate(SEEDS[:2]):
        one = simulate_distributed(pd, cfg, T_DIST, np.arange(20), seed=s,
                                   probes=ProbeSpec(**PROBES), device="cpu")
        assert int(res.dropped[b]) == one.dropped
        assert torch.equal(res.counts[b], one.counts)
        assert all(torch.equal(x[b], y) for x, y in zip(res.state,
                                                         one.state))
        assert all(torch.equal(res.records[k][b], one.records[k])
                   for k in one.records)
        assert all(int(res.stats[k][b]) == int(one.stats[k])
                   for k in one.stats)


@pytest.fixture(scope="module")
def cli_net():
    """n = 600, partitioned as the JAX CLI does it (src/repro/launch/
    simulate.py): greedy SAR under CoreBudget.tpu_vmem(), then
    pad_to_uniform onto 7 partitions (U = 86, 2 pad neurons)."""
    rc = ref_conn.synthetic_flywire(n=600, target_synapses=15_000, seed=8)
    pc = convert.connectome_from_jax(rc)
    rp = ref_pad(ref_greedy(rc, ref_caps(RefBudget.tpu_vmem(), "sar"),
                            scheme="sar"), 7, rc.n)
    pp = pad_to_uniform(greedy_partition(
        pc, caps_from_budget(CoreBudget.tpu_vmem(), "sar"), scheme="sar"),
        7, pc.n)
    rd = ref_build_dcsr(rc, rp, quantize_bits=9)
    pd = build_dcsr(pc, pp, quantize_bits=9)
    np.testing.assert_array_equal(rd.perm, pd.perm)
    assert pd.n_parts == 7 and 7 * pd.part_size > 600
    return (rc, pc), (rd, pd)


@pytest.mark.parametrize("scheme", ["event", "blocked_fused"])
def test_run_dist_trials_on_the_cli_partition_path(cli_net, scheme):
    (rc, pc), dd = cli_net
    kw = _sim_kw(SCHEMES[scheme][1], True)
    stim = (ref_scenario("sugar_feeding", rc, RefSim(**kw), rate_hz=200.0,
                         background_hz=20.0),
            build_scenario("sugar_feeding", pc, SimConfig(**kw),
                           rate_hz=200.0, background_hz=20.0))
    want, got = _dist_both(dd, scheme, True, t_steps=50, stimulus=stim,
                           probes=dict(PROBES, voltage=(7, 599)),
                           seeds=SEEDS[:2])
    w = _result(want)
    assert all(w["counts"][b].sum() > 0 for b in range(2))
    _assert_bitwise(w, _result(got))
