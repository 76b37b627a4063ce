"""repro_torch.core.neuron and exp.stimulus.apply_drive against the JAX
reference, bitwise: the LIF steps in float32 and Q19.12, the fused
multiply-add sites, the IEEE division of the Q19.12 drive conversion and
the int32 wraparound."""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as ref
from repro.exp import stimulus as ref_stim
from repro_torch.core import neuron as port
from repro_torch.exp import stimulus as port_stim

P = port.FLYWIRE_LIF
RP = ref.FLYWIRE_LIF


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


def _f32_state(rng, n):
    return ref.LIFState(
        v=rng.normal(3.0, 4.0, n).astype(np.float32),
        g=rng.normal(0.0, 2.0, n).astype(np.float32),
        refrac=rng.integers(-1, RP.ref_steps + 1, n).astype(np.int32))


def _fx_state(rng, n):
    return ref.LIFState(
        v=rng.integers(-3 * RP.fx_v_th, 3 * RP.fx_v_th, n).astype(np.int32),
        g=rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
        refrac=rng.integers(-1, RP.ref_steps + 1, n).astype(np.int32))


def _port_state(st):
    return port.LIFState(*(_t(x) for x in st))


def test_params_match_reference():
    for name in ("ref_steps", "delay_steps", "alpha_m", "decay_g", "fx_one",
                 "fx_alpha_m16", "fx_gdecay16", "fx_v_th", "fx_v_r",
                 "fx_v0"):
        for p, rp in ((P, RP), (port.FLYWIRE_LIF_1MS, ref.FLYWIRE_LIF_1MS)):
            assert getattr(p, name) == getattr(rp, name), name


@pytest.mark.parametrize("vin", [False, True])
@pytest.mark.parametrize("force", [False, True])
def test_lif_step_bitwise(vin, force):
    rng = np.random.default_rng(1)
    n = 100_000
    st = _f32_state(rng, n)
    gu = (rng.integers(-400, 400, n)).astype(np.float32)
    v_in = rng.normal(0.0, 5.0, n).astype(np.float32) if vin else None
    f = (rng.random(n) < 0.1) if force else None

    @jax.jit
    def jref(st, gu, v_in, f):
        return ref.lif_step(st, gu * RP.w_scale, RP, v_in, f)
    (rs, rspk) = jref(st, gu, v_in, f)
    ps, pspk = port.lif_step(_port_state(st), _t(gu), P,
                             None if v_in is None else _t(v_in),
                             None if f is None else _t(f))
    for a, b in zip(rs, ps):
        _same(a, b.numpy())
    _same(rspk, pspk.numpy())


@pytest.mark.parametrize("vin", [False, True])
@pytest.mark.parametrize("force", [False, True])
def test_lif_step_fx_bitwise(vin, force):
    """Wide g and v values make the int32 products wrap, as jnp's do."""
    rng = np.random.default_rng(2)
    n = 100_000
    st = _fx_state(rng, n)
    gu = rng.integers(-(1 << 19), 1 << 19, n).astype(np.int32)
    v_in = rng.integers(-(1 << 19), 1 << 19, n).astype(np.int32) \
        if vin else None
    f = (rng.random(n) < 0.1) if force else None
    rs, rspk = jax.jit(lambda *a: ref.lif_step_fx(a[0], a[1], RP, a[2],
                                                  a[3]))(st, gu, v_in, f)
    ps, pspk = port.lif_step_fx(_port_state(st), _t(gu), P,
                                None if v_in is None else _t(v_in),
                                None if f is None else _t(f))
    for a, b in zip(rs, ps):
        _same(a, b.numpy())
    _same(rspk, pspk.numpy())


@pytest.mark.parametrize("fixed_point", [False, True])
@pytest.mark.parametrize("channels", ["none", "v", "g", "force", "all"])
def test_apply_drive_bitwise_1m(fixed_point, channels):
    """One million neurons through jax.jit(apply_drive): pins both FMA
    sites of the float path and the IEEE division of v_mv / w_scale."""
    rng = np.random.default_rng(3)
    n = 1_000_000
    st = _fx_state(rng, n) if fixed_point else _f32_state(rng, n)
    gu = (rng.integers(-300, 300, n) + rng.random(n).round(1)
          ).astype(np.float32)
    v_mv = g_units = force = None
    if channels in ("v", "all"):
        v_mv = (rng.normal(0.0, 6.0, n)).astype(np.float32)
    if channels in ("g", "all"):
        g_units = (rng.integers(0, 2, n) * 180.0).astype(np.float32)
    if channels in ("force", "all"):
        force = rng.random(n) < 0.05
    drive = ref_stim.StimDrive(v_mv=v_mv, g_units=g_units, force=force)
    rs, rspk = jax.jit(lambda s, g, d: ref_stim.apply_drive(
        s, g, d, RP, fixed_point))(st, gu, drive)
    pdrive = port_stim.StimDrive(*(None if x is None else _t(x)
                                   for x in drive))
    ps, pspk = port_stim.apply_drive(
        _port_state(st), _t(gu), pdrive, P, fixed_point)
    for a, b in zip(rs, ps):
        _same(a, b.numpy())
    _same(rspk, pspk.numpy())


def _exact_fma_f32(a, b, c):
    x = (fractions.Fraction(float(a)) * fractions.Fraction(float(b))
         + fractions.Fraction(float(c)))
    lo = np.float32(float(x))           # within one float32 step of x
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    best = min(cands, key=lambda y: (abs(fractions.Fraction(float(y)) - x),
                                     int(np.asarray(y).view(np.int32)) & 1))
    return best


def test_fma_f32_correctly_rounded():
    """fma_f32 against exact rational arithmetic, including products that
    land on float32 halfway points where float64 rounding alone errs."""
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, 3000).astype(np.float32)
    b = rng.normal(0, 1, 3000).astype(np.float32)
    c = rng.normal(0, 1, 3000).astype(np.float32)
    # a*b exactly halfway between two float32 values, with a c that float64
    # rounding swallows: only the sign of c decides the correctly rounded
    # result, which rounding the float64 sum alone gets wrong half the time
    k = 2 * rng.integers(0, 1000, 1000) + 1
    sign = np.where(rng.random(1000) < 0.5, -1.0, 1.0)
    a[:1000] = (sign * (1.0 + k * 2.0 ** -12)).astype(np.float32)
    b[:1000] = np.float32(1.0 + 2.0 ** -12)
    c[:1000] = (rng.choice([-1.0, 1.0], 1000)
                * 2.0 ** rng.integers(-90, -60, 1000)).astype(np.float32)
    c[:100] = 0.0
    out = port.fma_f32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_exact_fma_f32(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    # and XLA's own fused result on the reference's site
    got = jax.jit(lambda a, b, c: c + a * b)(a, b, c)
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  out.view(np.int32))


def test_division_is_ieee_at_1m():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 20, 1_000_000).astype(np.float32)
    x[:1000] = (np.arange(1000) * np.float32(0.1375)).astype(np.float32)
    got = (_t(x) / port.f32(P.w_scale, _t(x))).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  (x / np.float32(P.w_scale)).view(np.int32))


def test_init_state_and_conversions():
    for fx in (False, True):
        a, b = ref.init_state(17, RP, fx), port.init_state(17, P, fx)
        for x, y in zip(a, b):
            _same(x, y.numpy())
    rng = np.random.default_rng(6)
    fxv = rng.integers(-(1 << 20), 1 << 20, 5000).astype(np.int32)
    _same(jax.jit(lambda x: ref.fx_to_mv(x, RP))(fxv),
          port.fx_to_mv(_t(fxv), P).numpy())
    mv = rng.normal(0, 10, 5000).astype(np.float32)
    _same(jax.jit(lambda x: ref.mv_to_fx(x, RP))(mv),
          port.mv_to_fx(_t(mv), P).numpy())


@pytest.mark.parametrize("mode", [True, False])
def test_poisson_drive(mode):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", mode)
    try:
        mask = np.random.default_rng(7).random(3000) < 0.5
        for seed in (0, 3, 99):
            r = ref.poisson_drive(jax.random.PRNGKey(seed), 3000, 150.0, 0.1,
                                  jnp.asarray(mask))
            from repro_torch import random as prng
            p = port.poisson_drive(prng.PRNGKey(seed), 3000, 150.0, 0.1,
                                   _t(mask), partitionable=mode)
            _same(r, p.numpy())
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_lif_step_flushes_subnormals_like_xla_5000_steps():
    """XLA's CPU code flushes float32 subnormals to zero (inputs and
    results); so does the port.  2,000 neurons with no input decay for
    5,000 steps, far enough for most ``g`` (and some ``v``) to fall
    below 1.18e-38: ``v``, ``g`` and ``refrac`` stay bitwise equal to
    ``jax.jit(lif_step)`` at every step."""
    rng = np.random.default_rng(0)
    n, steps = 2000, 5000
    st = ref.LIFState(v=rng.normal(0.0, 5.0, n).astype(np.float32),
                      g=rng.exponential(3.0, n).astype(np.float32),
                      refrac=np.zeros(n, np.int32))
    zero = np.zeros(n, np.float32)

    @jax.jit
    def jref(st):
        def body(_, s):
            return ref.lif_step(s, jnp.asarray(zero) * RP.w_scale, RP)[0]
        return jax.lax.fori_loop(0, steps, body, st)
    want = jref(st)
    ps, pz = _port_state(st), _t(zero)
    for _ in range(steps):
        ps, _ = port.lif_step(ps, pz, P)
    for a, b in zip(want, ps):
        _same(a, b.numpy())
    # the case is not vacuous: without the flush these would be subnormal
    assert (np.asarray(want.g) == 0).sum() > 1000


def test_ftz_keeps_sign_and_normals():
    x = np.array([1e-39, -1e-39, 1.1754944e-38, -1.1754944e-38, 0.0, -0.0,
                  1.0, -np.inf, np.nan, 1e-45], np.float32)
    got = port.ftz(_t(x)).numpy()
    want = np.array([0.0, -0.0, 1.1754944e-38, -1.1754944e-38, 0.0, -0.0,
                     1.0, -np.inf, np.nan, 0.0], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # XLA on the CPU: a subnormal product is a zero of the product's sign
    assert np.asarray(jax.jit(lambda a: a * np.float32(0.5))(x[:2])).view(
        np.int32).tolist() == want[:2].view(np.int32).tolist()
