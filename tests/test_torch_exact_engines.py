"""The port's exact engines (``dense``, ``ell``, ``binned``) and their
builders against the JAX package's, bitwise (tolerance 0 throughout):
``build_ell`` capped and uncapped, ``build_binned`` at 9 and 16 bits and
``compression_report`` array- and dict-equal; each engine's ``deliver``
on random spikes; ``simulate()`` in float32 and Q19.12 and both threefry
modes; ``run_trials`` with B = 3; and the reference's own oracle test
(every engine equal to ``dense``) on the port.  The capped ``ell`` rows
carry rescaled, non-integer weights: their float32 sums match because
the port sums every row in XLA's CPU order
(``engines.ell.xla_row_sum``), held here at widths above and below its
32-wide window.  Networks: tests/test_fused.py's (n = 1,000) and
tests/test_engines.py's (n = 1,500)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimConfig as RefSim
from repro.core import compress as ref_compress
from repro.core import connectome as ref_conn
from repro.core import simulate as ref_simulate
from repro.core.engines import available_engines as ref_available
from repro.core.engines import get_engine as ref_engine
from repro.exp import ProbeSpec as RefProbes
from repro.exp import build_scenario as ref_scenario
from repro.exp import run_trials as ref_run_trials
from repro_torch import convert
from repro_torch.core import SimConfig, compress, simulate
from repro_torch.core.engines import (available_engines, get_engine,
                                      xla_row_sum)
from repro_torch.exp import ProbeSpec, build_scenario, run_trials

EXACT = ("dense", "ell", "binned")
CONFIGS = {"f32": dict(background_rate_hz=20.0),
           "q19_12": dict(fixed_point=True, quantize_bits=9,
                          poisson_to_v=False, background_rate_hz=20.0)}
PROBES = dict(raster=True, voltage=(0, 5, 401, 999), pop_rate=True,
              drops=True)
# ell widths: uncapped (max fan-in 339 -> 344), capped above the 32-wide
# window (40: 153 rows sampled) and within it (20 -> 24)
ELL_CAPS = {"uncapped": 4096, "cap40": 40, "cap20": 20}


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


@pytest.fixture(scope="module")
def oracle_net():
    """tests/test_engines.py's network: n = 1,500, 45k synapses, seed 3."""
    rc = ref_conn.synthetic_flywire(n=1500, target_synapses=45_000, seed=3)
    return rc, convert.connectome_from_jax(rc)


def _bits(x) -> np.ndarray:
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(f"i{x.itemsize}") if x.dtype.kind == "f" else x


def _assert_bitwise(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def _result(r) -> dict:
    out = {"counts": r.counts, "dropped": r.dropped, "v": r.state.v,
           "g": r.state.g, "refrac": r.state.refrac}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qbits", [None, 9])
@pytest.mark.parametrize("cap", list(ELL_CAPS))
def test_build_ell_matches_reference(net, cap, qbits):
    rc, pc = net
    want = ref_compress.build_ell(rc, ELL_CAPS[cap], quantize_bits=qbits)
    got = compress.build_ell(pc, ELL_CAPS[cap], quantize_bits=qbits)
    assert (got.width, got.n_capped) == (want.width, want.n_capped)
    assert (want.n_capped > 0) == (cap != "uncapped")
    assert got.idx.dtype == np.int32 and got.weight.dtype == np.float32
    np.testing.assert_array_equal(want.idx, got.idx)
    np.testing.assert_array_equal(_bits(want.weight), _bits(got.weight))


def test_build_ell_other_seed_and_lane_multiple(net):
    rc, pc = net
    want = ref_compress.build_ell(rc, 50, lane_multiple=16, seed=7)
    got = compress.build_ell(pc, 50, lane_multiple=16, seed=7)
    assert got.width == want.width == 64
    np.testing.assert_array_equal(want.idx, got.idx)
    np.testing.assert_array_equal(_bits(want.weight), _bits(got.weight))


@pytest.mark.parametrize("bits", [9, 16])
def test_build_binned_matches_reference(oracle_net, bits):
    rc, pc = oracle_net
    want, got = ref_compress.build_binned(rc, bits), compress.build_binned(
        pc, bits)
    assert got.n_bins == want.n_bins and got.nnz == want.nnz == pc.nnz
    for k in ("src", "bin_id", "bin_weight"):
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("parts", [None, 4])
def test_compression_report_matches_reference(oracle_net, parts):
    rc, pc = oracle_net
    part = None if parts is None else np.arange(pc.n) % parts
    want = ref_compress.compression_report(rc, part)
    got = compress.compression_report(pc, part)
    assert got == want and ("ssd_message_ratio" in got) == (parts is not None)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

def test_registry_equals_reference():
    # every engine of the reference, and the port's own delay_event (per-
    # synapse delays into a pending ring), which the reference has no
    # counterpart of
    assert available_engines() == sorted(ref_available() + ["delay_event"])
    for name in EXACT:
        assert get_engine(name).name == name


def _engine_cases():
    yield "dense", {}
    for cap in ELL_CAPS.values():
        yield "ell", dict(ell_width_cap=cap)
    yield "binned", {}
    yield "binned", dict(quantize_bits=9)


@pytest.mark.parametrize("engine,kw", list(_engine_cases()),
                         ids=lambda x: str(x))
def test_deliver_matches_reference(net, engine, kw):
    """One deliver on random spikes at 0%, 1%, 10%, 50% and 100%; the
    port's lane axis ([B, n]) gives each lane's single-lane result."""
    rc, pc = net
    rcfg, pcfg = RefSim(engine=engine, **kw), SimConfig(engine=engine, **kw)
    rs = ref_engine(engine).build(rc, rcfg)
    ps = get_engine(engine).build(pc, pcfg, "cpu")
    deliver = jax.jit(lambda st, s: ref_engine(engine).deliver(st, s,
                                                               rcfg)[0])
    rng = np.random.default_rng(1)
    spk = np.stack([rng.random(pc.n) < p for p in (0, .01, .1, .5, 1)])
    got = get_engine(engine).deliver(ps, torch.from_numpy(spk), pcfg)
    assert got[0].shape == (5, pc.n) and got[0].dtype == torch.float32
    assert got[1].shape == (5,) and not got[1].any()
    for b in range(5):
        want = np.asarray(deliver(rs, jnp.asarray(spk[b])))
        np.testing.assert_array_equal(_bits(want), _bits(got[0][b]))
        one = get_engine(engine).deliver(ps, torch.from_numpy(spk[b]), pcfg)
        np.testing.assert_array_equal(_bits(one[0]), _bits(got[0][b]))
    assert got[0].abs().sum() > 0


@pytest.mark.parametrize("width", [1, 7, 32, 33, 40, 100, 1000, 1100])
def test_xla_row_sum_is_xla_cpu_order(width):
    """Float sums whose value depends on the order (random magnitudes,
    half zeroed) against ``x.sum(axis=-1)`` under ``jax.jit``."""
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((64, width)) * rng.integers(
        1, 2000, (64, width)) * (rng.random((64, width)) < .5)
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=-1))(jnp.asarray(x)))
    got = xla_row_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(want), _bits(got))
    if width > 32:       # the order matters here: a plain sum differs
        assert not np.array_equal(want, x.sum(axis=-1, dtype=np.float32))


def _sim_cases():
    for engine in EXACT:
        for cfg in CONFIGS:
            yield engine, cfg, {}
    yield "ell", "f32", dict(ell_width_cap=40)
    yield "ell", "q19_12", dict(ell_width_cap=40)


@pytest.mark.parametrize("engine,cfg,kw", list(_sim_cases()),
                         ids=lambda x: str(x))
def test_simulate_matches_reference(net, engine, cfg, kw):
    rc, pc = net
    skw = dict(engine=engine, **CONFIGS[cfg], **kw)
    rcfg, pcfg = RefSim(**skw), SimConfig(**skw)
    want = ref_simulate(rc, rcfg, 150, seed=3,
                        stimulus=ref_scenario("sugar_feeding", rc, rcfg),
                        probes=RefProbes(**PROBES))
    got = simulate(pc, pcfg, 150, seed=3,
                   stimulus=build_scenario("sugar_feeding", pc, pcfg),
                   probes=ProbeSpec(**PROBES), device="cpu")
    w = _result(want)
    assert w["counts"].sum() > 0
    _assert_bitwise(w, _result(got))


@pytest.mark.parametrize("engine", EXACT)
def test_original_threefry_mode(net, engine):
    rc, pc = net
    skw = dict(engine=engine, **CONFIGS["q19_12"])
    rcfg, pcfg = RefSim(**skw), SimConfig(**skw)
    with prng_mode(False):
        want = ref_simulate(rc, rcfg, 100, seed=5,
                            stimulus=ref_scenario("sugar_feeding", rc, rcfg),
                            probes=RefProbes(raster=True))
    got = simulate(pc, pcfg, 100, seed=5,
                   stimulus=build_scenario("sugar_feeding", pc, pcfg),
                   probes=ProbeSpec(raster=True), device="cpu",
                   partitionable=False)
    _assert_bitwise(_result(want), _result(got))


@pytest.mark.parametrize("engine,kw", [("dense", {}), ("ell", {}),
                                       ("ell", dict(ell_width_cap=40)),
                                       ("binned", {})],
                         ids=lambda x: str(x))
def test_run_trials_matches_reference(net, engine, kw):
    rc, pc = net
    skw = dict(engine=engine, **CONFIGS["q19_12"], **kw)
    rcfg, pcfg = RefSim(**skw), SimConfig(**skw)
    seeds = [3, 11, 42]
    want = ref_run_trials(rc, rcfg, 80, seeds=seeds,
                          stimulus=ref_scenario("sugar_feeding", rc, rcfg),
                          probes=RefProbes(**PROBES))
    got = run_trials(pc, pcfg, 80, seeds=seeds,
                     stimulus=build_scenario("sugar_feeding", pc, pcfg),
                     probes=ProbeSpec(**PROBES), device="cpu")
    w = _result(want)
    assert w["counts"].shape == (3, pc.n)
    assert not np.array_equal(w["counts"][0], w["counts"][1])
    _assert_bitwise(w, _result(got))


def _oracle_run(pc, engine):
    with pytest.warns(DeprecationWarning):
        return simulate(pc, SimConfig(engine=engine), 400, np.arange(20),
                        seed=7, device="cpu")


@pytest.fixture(scope="module")
def dense_oracle(oracle_net):
    torch.set_num_threads(1)
    return _oracle_run(oracle_net[1], "dense")


@pytest.mark.parametrize("engine", ["csr", "ell", "event", "binned",
                                    "blocked", "blocked_fused"])
def test_engines_agree_with_dense(oracle_net, dense_oracle, engine):
    """tests/test_engines.py::test_engines_agree_exactly on the port (its
    legacy ``sugar_neurons`` drive): the same seed gives every engine the
    counts of ``dense``, nothing dropped."""
    out = _oracle_run(oracle_net[1], engine)
    np.testing.assert_array_equal(dense_oracle.counts.numpy(),
                                  out.counts.numpy())
    assert int(out.dropped) == 0 and int(dense_oracle.counts.sum()) > 0


def test_dense_refuses_repeated_pairs(net):
    from repro_torch.core.engines.dense import dense_index
    _, pc = net
    assert dense_index(pc).size == pc.nnz
    dup = pc.__class__(**{**pc.__dict__,
                          "in_indices": pc.in_indices.copy()})
    row = int(np.argmax(pc.fan_in >= 2))
    s = int(pc.in_indptr[row])
    dup.in_indices[s + 1] = dup.in_indices[s]
    with pytest.raises(ValueError, match="repeats"):
        dense_index(dup)
