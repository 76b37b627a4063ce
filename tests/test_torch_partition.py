"""The port's partitioning host code against the JAX package's, array-equal
(tests/test_distributed.py's network: n = 1,600, seed 8): greedy, even
and uniform partitions, the core-budget presets and fan statistics,
build_dcsr and edge_cut, partition_report, the exchange schemes' stores
(build_dist_arrays, build_blocked_sharded) built by the port and carried
over from the reference by repro_torch.convert, and shard_stimulus."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import compress as ref_compress
from repro.core import connectome as ref_conn
from repro.core import dcsr as ref_dcsr
from repro.core import partition as ref_part
from repro.core.exchange import blocked as ref_blocked
from repro.core.exchange.arrays import build_dist_arrays as ref_dist_arrays
from repro.exp import stimulus as ref_stim
from repro.exp import build_scenario as ref_scenario
from repro.core import SimConfig as RefSimConfig
from repro_torch import convert
from repro_torch.core import DistConfig, SimConfig, compress, dcsr, partition
from repro_torch.core.exchange import Topology, get_scheme
from repro_torch.core.exchange.arrays import build_dist_arrays
from repro_torch.exp import build_scenario, stimulus
from repro_torch.kernels.spike_prop.ops import (build_blocked_sharded,
                                                check_row_order)
from repro_torch.tree import map_tensors


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


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
    rc = ref_conn.synthetic_flywire(n=1600, target_synapses=48_000, seed=8)
    return rc, convert.connectome_from_jax(rc)


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_core_budgets_and_fan_statistics(net):
    rc, pc = net
    for name in ("loihi2", "tpu_vmem"):
        a = getattr(ref_compress.CoreBudget, name)()
        b = getattr(compress.CoreBudget, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (ref_compress.W_CAP_LO, ref_compress.W_CAP_HI,
            ref_compress.WEIGHT_BITS) == (compress.W_CAP_LO, compress.W_CAP_HI,
                                          compress.WEIGHT_BITS)
    for bits in (9, 6):
        np.testing.assert_array_equal(
            ref_compress.effective_fan_in_sar(rc, bits),
            compress.effective_fan_in_sar(pc, bits))
    parts = np.repeat(np.arange(4, dtype=np.int32), 400)
    np.testing.assert_array_equal(
        ref_compress.effective_fan_out_ssd(rc, parts),
        compress.effective_fan_out_ssd(pc, parts))
    budget = compress.CoreBudget.loihi2()
    eff, fo = np.arange(5), np.arange(5, 10)
    assert (ref_compress.core_memory_sar(eff, fo, budget)
            == compress.core_memory_sar(eff, fo, budget))
    assert (ref_compress.core_memory_ssd(eff, fo, budget)
            == compress.core_memory_ssd(eff, fo, budget))


def _partitions(mod, c):
    """Every partitioning the tests compare, made by ``mod`` (the
    reference's partition module or the port's)."""
    budgets = (ref_compress if mod is ref_part else compress).CoreBudget
    out = {}
    for scheme in ("sar", "ssd"):
        for name in ("loihi2", "tpu_vmem"):
            budget = getattr(budgets, name)()
            caps = mod.caps_from_budget(budget, scheme)
            out[(scheme, name)] = mod.greedy_partition(c, caps, scheme)
    out["even4"] = mod.even_partition(c, 4)
    out["even3"] = mod.even_partition(c, 3)
    for P_ in (3, 4, 12):
        out[f"uniform{P_}"] = mod.pad_to_uniform(out[("sar", "loihi2")], P_,
                                                 c.n)
    return out


def test_partitions_and_reports_match(net):
    rc, pc = net
    want, got = _partitions(ref_part, rc), _partitions(partition, pc)
    assert want.keys() == got.keys()
    for k in want:
        _fields_equal(want[k], got[k])
        assert want[k].n_parts == got[k].n_parts
        for name in ("loihi2", "tpu_vmem"):
            a = ref_part.partition_report(
                rc, want[k], getattr(ref_compress.CoreBudget, name)())
            b = partition.partition_report(
                pc, got[k], getattr(compress.CoreBudget, name)())
            assert a.keys() == b.keys()
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("quantize_bits", [None, 9])
@pytest.mark.parametrize("parts", ["even4", "even3", "uniform12"])
def test_build_dcsr_and_edge_cut_match(net, parts, quantize_bits):
    rc, pc = net
    rp, pp = _partitions(ref_part, rc)[parts], _partitions(partition, pc)[parts]
    a = ref_dcsr.build_dcsr(rc, rp, quantize_bits=quantize_bits)
    b = dcsr.build_dcsr(pc, pp, quantize_bits=quantize_bits)
    _fields_equal(a, b)
    assert ref_dcsr.edge_cut(a) == dcsr.edge_cut(b)


@pytest.fixture(scope="module")
def dcsrs(net):
    rc, pc = net
    out = {}
    for P_ in (4, 3):
        out[P_] = (ref_dcsr.build_dcsr(rc, ref_part.even_partition(rc, P_),
                                       quantize_bits=9),
                   dcsr.build_dcsr(pc, partition.even_partition(pc, P_),
                                   quantize_bits=9))
    return out


def _tensors_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("P_", [4, 3])
def test_build_dist_arrays_matches_reference(dcsrs, P_):
    rd, pd = dcsrs[P_]
    want = ref_dist_arrays(rd)
    got = build_dist_arrays(pd, "cpu")
    for k in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, k)),
                                      getattr(got, k).numpy(), err_msg=k)
    # the reference's own stores carried over equal the port's build
    _tensors_equal(convert.dist_arrays_from_jax(want, "cpu")._asdict(),
                   got._asdict())
    assert build_dist_arrays(pd, "cpu") is got          # memoized


def _sharded_states(rd, pd):
    ref_state = ref_blocked.BlockedExchange().build(rd, None, None)
    carried = convert.sharded_blocked_from_jax(ref_state, "cpu")
    own = get_scheme("blocked").build(pd, None, None, "cpu")
    return ref_state, carried, own


@pytest.mark.parametrize("P_", [4, 3])
def test_build_blocked_sharded_matches_reference(dcsrs, P_):
    rd, pd = dcsrs[P_]
    ref_state, carried, own = _sharded_states(rd, pd)
    for f in ("blk_id", "weights", "src_gfo"):
        a, b = getattr(carried, f), getattr(own, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    for f in ("n_sb", "tiles_stored", "occupancy"):
        assert getattr(ref_state, f) == getattr(own, f), f
    bs = build_blocked_sharded(pd, "cpu")
    assert bs.weights.dtype == torch.int16 and bs.weights.dim() == 5
    for p in range(P_):
        check_row_order(bs.blk_id[p].numpy(), bs.n_sb)
        # each partition's slab starts 16-byte aligned, as the kernels need
        assert bs.weights[p].data_ptr() % 16 == 0
        assert bs.weights[p].is_contiguous()


@pytest.mark.parametrize("P_", [4, 3])
def test_carried_states_deliver_as_the_ports_own(dcsrs, P_):
    """One step's delivery on every partition, from the port's own stores
    and from the reference's carried over: the same drive and drops."""
    rd, pd = dcsrs[P_]
    _, carried, own = _sharded_states(rd, pd)
    arrs_own = build_dist_arrays(pd, "cpu")
    arrs_carried = convert.dist_arrays_from_jax(ref_dist_arrays(rd), "cpu")
    U = pd.part_size
    rng = np.random.default_rng(P_)
    delayed = [torch.from_numpy(rng.random(U) < 0.05) & arrs_own.pad_mask[p]
               for p in range(P_)]
    sim = SimConfig(engine="csr", quantize_bits=9)
    cap = DistConfig(sim=sim).capacity
    for name, a, b in (("blocked", own, carried),
                       ("event", arrs_own, arrs_carried),
                       ("bitmap", arrs_own, arrs_carried)):
        scheme = get_scheme(name)
        topos = [Topology(P_, U, "cores", p) for p in range(P_)]
        part = lambda s, p: map_tensors(lambda x: x[p], s)  # noqa: E731
        ex = [scheme.exchange(part(a, p), delayed[p], cap, topos[p])
              for p in range(P_)]
        gathered = torch.cat([e[0] for e in ex])
        for p in range(P_):
            outs = [scheme.deliver(part(s, p), (gathered, ex[p][1]),
                                   delayed[p], sim, cap, topos[p])
                    for s in (a, b)]
            assert torch.equal(outs[0][0], outs[1][0]), name
            assert int(outs[0][1]) == int(outs[1][1]), name
            assert outs[0][0].abs().sum() > 0, name


def _leaves(x):
    out = []
    if isinstance(x, (tuple, list)):
        for v in x:
            out += _leaves(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            out += _leaves(getattr(x, f.name))
    elif x is not None and hasattr(x, "shape"):
        out.append(np.asarray(x))
    return out


@pytest.mark.parametrize("P_", [4, 3])
@pytest.mark.parametrize("which", ["legacy", "sugar_feeding"])
def test_shard_stimulus_matches_reference(net, dcsrs, P_, which):
    rc, pc = net
    rd, pd = dcsrs[P_]
    kw = dict(background_rate_hz=5.0, poisson_to_v=False)
    if which == "legacy":
        sugar = np.arange(0, 1600, 77)
        a = ref_stim.legacy_stimulus(RefSimConfig(**kw), rc.n, sugar,
                                     masked=True)
        b = stimulus.legacy_stimulus(SimConfig(**kw), pc.n, sugar,
                                     masked=True)
    else:
        a = ref_scenario("sugar_feeding", rc, RefSimConfig(**kw),
                         background_hz=5.0)
        b = build_scenario("sugar_feeding", pc, SimConfig(**kw),
                           background_hz=5.0)
    want = ref_stim.shard_stimulus(a, rd)
    got = stimulus.shard_stimulus(b, pd)
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl) > 0
    for x, y in zip(wl, gl):
        assert x.dtype == y.dtype and x.shape == y.shape == (P_, pd.part_size)
        np.testing.assert_array_equal(x, y)
