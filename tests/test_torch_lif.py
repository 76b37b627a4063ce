"""repro_torch.kernels.lif against the JAX package's LIF kernels (Pallas,
interpret mode) and their oracles, bitwise, over the sweeps of
tests/test_kernels.py: the float32 and Q19.12 entry points, the
multi-step trajectory, and inputs that decay into float32 subnormals.
On the CPU the wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neuron import LIFParams as RefParams
from repro.core.neuron import LIFState as RefState
from repro.kernels import lif as ref_lif
from repro_torch.core.neuron import LIFParams, LIFState
from repro_torch.kernels import lif as port_lif
from repro_torch.kernels.lif import kernel as K


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _same_result(ref, port):
    (rs, rspk), (ps, pspk) = ref, port
    for a, b in zip(rs, ps):
        _same(a, b.numpy())
    _same(rspk, pspk.numpy())


def _port_state(st):
    return LIFState(*(_t(x) for x in st))


@pytest.mark.parametrize("n", [64, 128, 300, 1000])
@pytest.mark.parametrize("dt", [0.1, 1.0])
@pytest.mark.parametrize("channels", ["all", "none"])
def test_lif_update_float_bitwise(n, dt, channels):
    """test_lif_kernel_float_sweep's inputs; tolerance 0 against the
    reference kernel, where the reference's own test allows 1e-6."""
    rp, pp = RefParams(dt=dt), LIFParams(dt=dt)
    rng = np.random.default_rng(n)
    st = RefState(v=rng.normal(0, 3, n).astype(np.float32),
                  g=abs(rng.normal(0, 1, n)).astype(np.float32),
                  refrac=rng.integers(0, 3, n).astype(np.int32))
    g_in = rng.normal(0, 2, n).astype(np.float32)
    v_in = rng.normal(0, 5, n).astype(np.float32)
    force = rng.random(n) < 0.05
    if channels == "none":
        v_in = force = None
    want = ref_lif.lif_update(st, jnp.asarray(g_in), rp,
                              None if v_in is None else jnp.asarray(v_in),
                              None if force is None else jnp.asarray(force))
    got = port_lif.lif_update(_port_state(st), _t(g_in), pp,
                              None if v_in is None else _t(v_in),
                              None if force is None else _t(force))
    _same_result(want, got)


@pytest.mark.parametrize("n", [128, 500])
@pytest.mark.parametrize("channels", ["all", "none"])
def test_lif_update_fx_bitwise(n, channels):
    """test_lif_kernel_fixed_point_exact's inputs, plus wide values whose
    int32 products wrap."""
    rp, pp = RefParams(), LIFParams()
    rng = np.random.default_rng(n)
    st = RefState(v=rng.integers(-10000, 10000, n).astype(np.int32),
                  g=rng.integers(0, 5000, n).astype(np.int32),
                  refrac=rng.integers(0, 3, n).astype(np.int32))
    st = st._replace(g=np.concatenate([st.g[:-20], rng.integers(
        -(1 << 30), 1 << 30, 20).astype(np.int32)]))
    g_in = rng.integers(-50, 50, n).astype(np.int32)
    v_in = rng.integers(0, 100, n).astype(np.int32)
    force = rng.random(n) < 0.05
    if channels == "none":
        v_in = force = None
    want = ref_lif.lif_update_fx(
        st, jnp.asarray(g_in), rp,
        None if v_in is None else jnp.asarray(v_in),
        None if force is None else jnp.asarray(force))
    got = port_lif.lif_update_fx(_port_state(st), _t(g_in), pp,
                                 None if v_in is None else _t(v_in),
                                 None if force is None else _t(force))
    _same_result(want, got)


def test_lif_update_multistep_trajectory():
    """test_lif_kernel_multistep_trajectory: 30 steps of integer drive,
    bitwise at every step (the reference's test allows 1e-4)."""
    rp, pp = RefParams(), LIFParams()
    n = 256
    rs = RefState(v=jnp.zeros(n), g=jnp.zeros(n),
                  refrac=jnp.zeros(n, jnp.int32))
    ps = _port_state(rs)
    rng = np.random.default_rng(0)
    for _ in range(30):
        g_in = (rng.integers(0, 30, n).astype(np.float32)
                * np.float32(0.275))
        rs, rspk = ref_lif.lif_update(rs, jnp.asarray(g_in), rp)
        ps, pspk = port_lif.lif_update(ps, _t(g_in), pp)
        _same_result((rs, rspk), (ps, pspk))


def test_lif_update_flushes_subnormals():
    """Inputs that are, or decay into, float32 subnormals: the reference
    kernel flushes them (XLA's CPU code), and so does the port's entry
    point, bitwise, over 40 steps."""
    rp, pp = RefParams(), LIFParams()
    rng = np.random.default_rng(5)
    n = 512
    tiny = np.float32(1.1754944e-38)
    v = (rng.uniform(-4, 4, n) * tiny).astype(np.float32)
    g = (rng.uniform(-60, 60, n) * tiny).astype(np.float32)
    st = RefState(v=v, g=g, refrac=rng.integers(0, 2, n).astype(np.int32))
    sub = (np.abs(v) < tiny) & (v != 0)
    assert sub.sum() > 100
    ps = _port_state(st)
    rs = RefState(*(jnp.asarray(x) for x in st))
    for i in range(40):
        g_in = (rng.uniform(-2, 2, n) * tiny * (i % 3 == 0)
                ).astype(np.float32)
        rs, rspk = ref_lif.lif_update(rs, jnp.asarray(g_in), rp)
        ps, pspk = port_lif.lif_update(ps, _t(g_in), pp)
        _same_result((rs, rspk), (ps, pspk))


@pytest.mark.parametrize("fx", [False, True], ids=["f32", "q19_12"])
def test_ref_matches_reference_ref(fx):
    """The tile-shaped oracles against the reference's, on [rows, 128]."""
    rp, pp = RefParams(), LIFParams()
    rng = np.random.default_rng(9)
    shape = (4, 128)
    if fx:
        v = rng.integers(-40000, 40000, shape).astype(np.int32)
        g = rng.integers(-(1 << 20), 1 << 20, shape).astype(np.int32)
        g_in = rng.integers(-50, 50, shape).astype(np.int32)
        v_in = rng.integers(-9, 9, shape).astype(np.int32)
    else:
        v = rng.normal(3, 4, shape).astype(np.float32)
        g = rng.normal(0, 2, shape).astype(np.float32)
        g_in = rng.normal(0, 2, shape).astype(np.float32)
        v_in = rng.normal(0, 5, shape).astype(np.float32)
    refrac = rng.integers(-1, 3, shape).astype(np.int32)
    force = (rng.random(shape) < 0.05).astype(np.int32)
    args = (v, g, refrac, g_in, v_in, force)
    rfn = ref_lif.lif_update_fx_ref if fx else ref_lif.lif_update_ref
    pfn = port_lif.lif_update_fx_ref if fx else port_lif.lif_update_ref
    want = jax.jit(lambda *a: rfn(*a, params=rp))(*args)
    got = pfn(*(_t(a) for a in args), params=pp)
    for a, b in zip(want, got):
        _same(a, b.numpy())


def test_wrappers_check_inputs_and_count_only_launches():
    pp = LIFParams()
    z = torch.zeros(8)
    zi = torch.zeros(8, dtype=torch.int32)
    K.reset_launches()
    K.lif_update_f32(z, z, zi, z, z, zi, params=pp)
    assert K.LAUNCHES == {"lif_update_f32": 0, "lif_update_fx32": 0}
    with pytest.raises(ValueError):
        K.lif_update_f32(z, z, zi, z, z[:4], zi, params=pp)
    with pytest.raises(ValueError):
        K.lif_update_fx32(z, z, zi, z, z, zi, params=pp)
