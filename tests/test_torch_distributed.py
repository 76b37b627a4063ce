"""The port's simulate_distributed(emulate=True) against the JAX package's,
bitwise: counts, LIF state, dropped, the raster / voltage / pop-rate /
drop records and the blocked scheme's tile counters, for the ``bitmap``,
``event`` and ``blocked`` schemes, the last both unfused (sim engine
``csr``) and fused (``blocked_fused``).  Networks: tests/test_fused.py's
(n = 1,000, P = 4, 120 steps) and tests/test_distributed.py's (n = 1,600,
P = 4), in float32 and Q19.12; both threefry modes; an uneven P = 3 with
pad neurons; starved event capacities.  The reference's ``blocked`` runs
go through Pallas interpret mode."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core.capacity import CapacityConfig as RefCap
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.distributed import simulate_distributed as ref_simulate
from repro.core.partition import even_partition as ref_even
from repro.exp import ProbeSpec as RefProbes
from repro_torch import convert
from repro_torch.core import (CapacityConfig, DistConfig, SimConfig,
                              build_dcsr, even_partition,
                              simulate_distributed)
from repro_torch.core import distributed
from repro_torch.exp import ProbeSpec

SCHEMES = {"bitmap": ("bitmap", "csr"), "event": ("event", "csr"),
           "blocked": ("blocked", "csr"),
           "blocked_fused": ("blocked", "blocked_fused")}
PROBES = dict(raster=True, voltage=(0, 5, 401, 999), pop_rate=True,
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


def _nets(n, syn, seed, parts):
    rc = ref_conn.synthetic_flywire(n=n, target_synapses=syn, seed=seed)
    pc = convert.connectome_from_jax(rc)
    return {P_: (ref_build_dcsr(rc, ref_even(rc, P_), quantize_bits=9),
                 build_dcsr(pc, even_partition(pc, P_), quantize_bits=9))
            for P_ in parts}


@pytest.fixture(scope="module")
def fused_net():
    """tests/test_fused.py's network, P = 4 and the uneven P = 3."""
    return _nets(1000, 25_000, 5, (4, 3))


@pytest.fixture(scope="module")
def dist_net():
    """tests/test_distributed.py's network."""
    return _nets(1600, 48_000, 8, (4,))


def _sim_kw(engine, fx, background_hz):
    # as tests/test_fused.py: Poisson drive to v in float32, to g (with
    # the forced background spikes) in Q19.12
    return dict(engine=engine, quantize_bits=9, fixed_point=fx,
                poisson_to_v=not fx, background_rate_hz=background_hz)


def _result(r) -> dict:
    out = {"counts": r.counts, "dropped": np.int64(r.dropped),
           "v": r.state[0], "g": r.state[1], "refrac": r.state[2]}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": v for k, v in r.stats.items()})
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _assert_bitwise(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = want[k], got[k]
        if k.startswith("stat_"):
            assert int(a) == int(b), k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=k)


def _run_both(dd, scheme, fx, t_steps, *, mode=True, background_hz=2.0,
              cap=None, seed=11, probes=PROBES):
    rd, pd = dd
    name, engine = SCHEMES[scheme]
    kw = _sim_kw(engine, fx, background_hz)
    sugar = np.arange(20)
    with prng_mode(mode):
        want = _result(ref_simulate(
            rd, RefDist(sim=RefSim(**kw), scheme=name,
                        capacity=cap and RefCap(*cap)),
            t_steps, sugar, seed=seed, emulate=True,
            probes=RefProbes(**probes)))
    got = _result(simulate_distributed(
        pd, DistConfig(sim=SimConfig(**kw), scheme=name,
                       capacity=cap and CapacityConfig(*cap)),
        t_steps, sugar, seed=seed, probes=ProbeSpec(**probes),
        device="cpu", partitionable=mode))
    return want, got


@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_matches_reference_p4(fused_net, scheme, fx):
    want, got = _run_both(fused_net[4], scheme, fx, 120)
    assert want["counts"].sum() > 0
    if scheme.startswith("blocked"):
        assert want["stat_tiles_live"] > 0
    _assert_bitwise(want, got)


@pytest.mark.parametrize("scheme,fx", [("bitmap", True), ("event", False),
                                       ("blocked", False),
                                       ("blocked_fused", True)])
def test_matches_reference_second_network(dist_net, scheme, fx):
    want, got = _run_both(dist_net[4], scheme, fx, 60, background_hz=20.0,
                          seed=3, probes=dict(PROBES, voltage=(7, 1599)))
    assert want["counts"].sum() > 0
    _assert_bitwise(want, got)


@pytest.mark.parametrize("scheme", ["event", "blocked_fused"])
def test_original_threefry_mode(fused_net, scheme):
    want, got = _run_both(fused_net[4], scheme, False, 120, mode=False)
    _assert_bitwise(want, got)
    # the mode reaches every partition's key: the other mode's run differs
    name, engine = SCHEMES[scheme]
    other = simulate_distributed(
        fused_net[4][1], DistConfig(sim=SimConfig(**_sim_kw(engine, False,
                                                            2.0)),
                                    scheme=name),
        120, np.arange(20), seed=11, probes=ProbeSpec(raster=True),
        device="cpu", partitionable=True)
    assert not np.array_equal(want["rec_raster"], other.raster.numpy())


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_uneven_partitions_with_pad_neurons(fused_net, scheme, monkeypatch):
    """P = 3 over 1,000 neurons: U = 336, 8 pad slots.  Bitwise equal to
    the reference; and inside the port's run, before the mapping back to
    original ids, the pad slots never spiked in any count or raster."""
    rd, pd = fused_net[3]
    pad = pd.inv_perm.reshape(3, pd.part_size) < 0
    assert pad.sum() == 3 * pd.part_size - 1000
    seen = []
    to_orig = distributed._to_orig

    def spy(d, arr, dtype=None):
        seen.append(arr)
        return to_orig(d, arr, dtype)
    monkeypatch.setattr(distributed, "_to_orig", spy)
    want, got = _run_both(fused_net[3], scheme, True, 60, background_hz=200.0)
    _assert_bitwise(want, got)
    counts, raster = seen[0], next(a for a in seen if a.dtype == torch.bool)
    assert counts.shape == (3, pd.part_size) and counts.sum() > 0
    assert int(counts.numpy()[pad].sum()) == 0
    assert not raster.numpy().transpose(0, 2, 1)[pad].any()
    assert int(counts.sum()) == got["counts"].sum() == got["rec_raster"].sum()


@pytest.mark.parametrize("scheme", ["event", "blocked", "blocked_fused"])
def test_starved_capacity_drops_match(fused_net, scheme):
    """Capacities far below a 200 Hz background's need: the reference and
    the port drop the same synapse events (event: budget overruns and
    spikes beyond the event capacity; blocked: the latter only)."""
    cap = (4, 256, 1) if scheme == "event" else (2, 32_768, 1)
    want, got = _run_both(fused_net[4], scheme, False, 60, cap=cap,
                          background_hz=200.0)
    assert want["dropped"] > 0
    _assert_bitwise(want, got)


def test_unported_paths_raise(fused_net):
    _, pd = fused_net[4]
    cfg = DistConfig(sim=SimConfig(), scheme="event")
    # the multi-process path is ported (tests/test_torch_multiprocess.py);
    # without a process group (no torchrun, no init_method) it refuses
    with pytest.raises(RuntimeError, match="no process group"):
        simulate_distributed(pd, cfg, 3, device="cpu", emulate=False)
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.make_core_mesh(4)
    # supervision is ported (tests/test_torch_health.py); a chunk size
    # below 1 is refused as the reference refuses it
    with pytest.raises(ValueError, match="positive"):
        simulate_distributed(pd, cfg, 3, device="cpu", chunk_steps=-1)
    # the faulty wrapper is ported (tests/test_torch_resilience.py): with
    # a clean plan it is its inner scheme
    from repro_torch.core.exchange import configure_faulty
    configure_faulty(inner="event")
    faulty = simulate_distributed(
        pd, DistConfig(sim=SimConfig(), scheme="faulty"), 3, device="cpu")
    clean = simulate_distributed(pd, cfg, 3, device="cpu")
    assert torch.equal(faulty.counts, clean.counts)
    assert faulty.dropped == clean.dropped
    assert all(torch.equal(a, b) for a, b in zip(faulty.state, clean.state))
    with pytest.raises(ValueError):
        simulate_distributed(pd, DistConfig(sim=SimConfig(), scheme="local"),
                             3, device="cpu")
    with pytest.raises(ValueError):
        simulate_distributed(pd, DistConfig(sim=SimConfig(), scheme="nope"),
                             3, device="cpu")
    with pytest.raises(ValueError):
        simulate_distributed(pd, cfg, 3, device="cpu",
                             probes=ProbeSpec(voltage=(1000,)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate_distributed(pd, cfg, 3)


def test_dist_config_capacity_matches_reference():
    assert DistConfig(sim=SimConfig()).capacity == CapacityConfig(256, 32_768)
    ref = RefDist(sim=RefSim()).capacity
    port = DistConfig(sim=SimConfig()).capacity
    assert (ref.spike_capacity, ref.syn_budget, ref.block_capacity) == (
        port.spike_capacity, port.syn_budget, port.block_capacity)
    with pytest.warns(DeprecationWarning):
        dc = DistConfig(sim=SimConfig(), spike_capacity=4)
    assert dc.capacity.spike_capacity == 4 and dc.spike_capacity is None
