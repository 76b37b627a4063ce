"""Two-state current-based LIF neuron dynamics (paper Eq. 1), in PyTorch.

Counterpart of ``repro/core/neuron.py``: the float path and the int32
Q19.12 fixed-point path (the Loihi 2 microcode analogue), vectorized over
neurons.  The CUDA kernel in :mod:`repro_torch.kernels.spike_prop` applies
the same math per thread (``csrc/lif.cuh``) and is held against these
functions.

Bit-exactness with the JAX reference rests on four details:

* XLA fuses ``g + g_in`` (where ``g_in = g_units * w_scale``) and
  ``v + alpha_m * ((v0 - v) + g)`` into fused multiply-adds.  PyTorch has
  no fused multiply-add operator (``torch.addcmul`` rounds twice unless the
  compiler happens to contract it), so :func:`fma_f32` computes the
  correctly rounded result exactly, and :func:`lif_step` takes the
  unscaled ``g_units`` so that the multiply can be fused.
* Q19.12 arithmetic wraps on int32 overflow as jnp does; it is done in
  int64 and wrapped back explicitly (:func:`wrap_i32`), so no step relies
  on C++ signed overflow.
* Right shifts are arithmetic, as in jnp.
* XLA's CPU code runs with flush-to-zero and denormals-are-zero: a float32
  operation reads a subnormal input as zero and returns zero (of the
  result's sign) for a subnormal result, while a select passes a
  subnormal through.  The float path does the same explicitly with
  :func:`ftz` after and before each operation; without it a quiet
  neuron's ``g`` differs once it decays below 1.18e-38 (about 4,300
  steps at dt = 0.1 ms).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as prng

FX_FRAC_BITS = 12  # Q19.12 fixed point, state in units of w_scale
FLT_MIN = float(np.finfo(np.float32).tiny)   # smallest normal float32


@dataclasses.dataclass(frozen=True)
class LIFParams:
    tau_m: float = 20.0      # ms
    tau_g: float = 5.0       # ms
    tau_ref: float = 2.2     # ms
    v0: float = 0.0          # mV (resting)
    v_r: float = 0.0         # mV (reset)
    v_th: float = 7.0        # mV (threshold)
    w_scale: float = 0.275   # mV per weight quantum
    dt: float = 0.1          # ms
    delay: float = 1.8       # ms (uniform synaptic delay)

    @property
    def ref_steps(self) -> int:
        return max(1, round(self.tau_ref / self.dt))

    @property
    def delay_steps(self) -> int:
        return max(1, round(self.delay / self.dt))

    # ---- float euler coefficients ----
    @property
    def alpha_m(self) -> float:
        return self.dt / self.tau_m

    @property
    def decay_g(self) -> float:
        return 1.0 - self.dt / self.tau_g

    # ---- fixed point coefficients (state unit = w_scale, frac = 2**12) ----
    # Coefficients are stored at 16 fractional bits and applied as
    # ((x >> 2) * c16) >> 14, the reference's narrow-multiplier form.
    @property
    def fx_one(self) -> int:
        return 1 << FX_FRAC_BITS

    @property
    def fx_alpha_m16(self) -> int:
        return round(self.alpha_m * (1 << 16))

    @property
    def fx_gdecay16(self) -> int:
        """(1 - decay_g) at 16 bits: decay applied as g -= g*(dt/tau_g)."""
        return round((self.dt / self.tau_g) * (1 << 16))

    @property
    def fx_v_th(self) -> int:
        return round(self.v_th / self.w_scale * self.fx_one)

    @property
    def fx_v_r(self) -> int:
        return round(self.v_r / self.w_scale * self.fx_one)

    @property
    def fx_v0(self) -> int:
        return round(self.v0 / self.w_scale * self.fx_one)


FLYWIRE_LIF = LIFParams()
FLYWIRE_LIF_1MS = LIFParams(dt=1.0, tau_ref=2.0, delay=2.0)


class LIFState(NamedTuple):
    v: torch.Tensor       # [n] float32 mV (or int32 fx)
    g: torch.Tensor       # [n] float32 mV (or int32 fx)
    refrac: torch.Tensor  # [n] int32 steps remaining


def init_state(n: int, params: LIFParams, fixed_point: bool = False,
               device=None) -> LIFState:
    if fixed_point:
        return LIFState(
            v=torch.full((n,), params.fx_v0, dtype=torch.int32, device=device),
            g=torch.zeros(n, dtype=torch.int32, device=device),
            refrac=torch.zeros(n, dtype=torch.int32, device=device))
    return LIFState(
        v=torch.full((n,), params.v0, dtype=torch.float32, device=device),
        g=torch.zeros(n, dtype=torch.float32, device=device),
        refrac=torch.zeros(n, dtype=torch.int32, device=device))


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar tensor on ``like``'s device, made
    by a fill on the device (no host copy, no synchronisation).  Used as a
    divisor: CUDA turns division by a Python scalar into multiplication by
    its reciprocal, division by a tensor is IEEE division."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def f32s(x: float) -> float:
    """``x`` rounded to float32, as a Python float: arithmetic between a
    float32 tensor and it is float32 arithmetic with ``float32(x)``, as in
    jnp's weak-typed scalars."""
    return float(np.float32(x))


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with float32 subnormals replaced by zero of the same sign (what
    XLA's CPU code makes of a subnormal result, and reads a subnormal input
    as); normals, infinities and NaN pass unchanged."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def fma_f32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor
            ) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, as a hardware
    FMA) under flush-to-zero: subnormal ``a``, ``b`` or ``c`` are read as
    zero and a subnormal result is flushed (:func:`ftz`); ``b`` may be a
    float32-exact Python float.

    ``a * b`` is exact in float64.  The float64 sum ``s`` and its exact
    error ``e`` (TwoSum) bracket the true value; rounding ``s`` to float32
    is correct unless ``s`` is exactly halfway between two float32 values
    while ``e`` is not zero, and then ``s`` is moved one float64 step
    towards the true value first.
    """
    p = ftz(a).double() * (ftz(b).double() if isinstance(b, torch.Tensor)
                           else b)
    cd = ftz(c).double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low == (1 << 28)) & (e != 0)
    away = torch.full_like(s, float("inf")).copysign(e)
    s = torch.where(tie, torch.nextafter(s, away), s)
    return ftz(s.float())


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to int32 two's complement (jnp's overflow)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def lif_step(state: LIFState, g_units: torch.Tensor, params: LIFParams,
             v_in: torch.Tensor | None = None,
             force_spike: torch.Tensor | None = None
             ) -> tuple[LIFState, torch.Tensor]:
    """One forward-Euler step, float path.

    Unlike the reference, which takes ``g_in = g_units * w_scale`` in mV,
    this takes ``g_units`` in weight units and applies ``w_scale`` inside
    the fused multiply-add ``g + g_units * w_scale`` that XLA forms.

    Every float32 operation flushes its inputs and its result (:func:`ftz`),
    as XLA's CPU code does; a refractory neuron's ``v`` and ``g`` pass
    through unchanged, subnormal or not, as through the reference's
    selects.

    Returns ``(new_state, spikes [n] bool)``.
    """
    p = params
    active = state.refrac <= 0
    g = fma_f32(g_units, f32s(p.w_scale), state.g)
    v = ftz(state.v)
    if v_in is not None:
        v = ftz(v + ftz(v_in))
    v = fma_f32(ftz(ftz(f32s(p.v0) - v) + g), f32s(p.alpha_m), v)
    g = ftz(g * f32s(p.decay_g))
    v = torch.where(active, v, state.v)
    g = torch.where(active, g, state.g)
    spikes = active & (v > f32s(p.v_th))
    if force_spike is not None:
        spikes = spikes | (active & force_spike)
    v = torch.where(spikes, f32s(p.v_r), v)
    g = torch.where(spikes, 0.0, g)
    refrac = torch.where(spikes, p.ref_steps,
                         torch.clamp(state.refrac - 1, min=0)).to(torch.int32)
    return LIFState(v=v, g=g, refrac=refrac), spikes


def lif_step_fx(state: LIFState, g_in_units: torch.Tensor, params: LIFParams,
                v_in_units: torch.Tensor | None = None,
                force_spike: torch.Tensor | None = None
                ) -> tuple[LIFState, torch.Tensor]:
    """One step, int32 fixed-point path (Loihi 2 microcode analogue).

    ``g_in_units`` are raw integer weight sums (not scaled by w_scale);
    state is Q19.12 in units of w_scale.
    """
    p = params
    active = state.refrac <= 0
    v, g = state.v.long(), state.g.long()
    g = torch.where(active, wrap_i32(g + (g_in_units.long() << FX_FRAC_BITS)),
                    state.g).long()
    if v_in_units is not None:
        v = torch.where(active,
                        wrap_i32(v + (v_in_units.long() << FX_FRAC_BITS)),
                        state.v).long()
    x = wrap_i32(p.fx_v0 - v + g).long()
    dv = wrap_i32((x >> 2) * p.fx_alpha_m16).long() >> 14
    v = torch.where(active, wrap_i32(v + dv), v.int())
    dg = wrap_i32((g >> 2) * p.fx_gdecay16).long() >> 14
    g = torch.where(active, wrap_i32(g - dg), g.int())
    spikes = active & (v > p.fx_v_th)
    if force_spike is not None:
        spikes = spikes | (active & force_spike)
    v = torch.where(spikes, p.fx_v_r, v).to(torch.int32)
    g = torch.where(spikes, 0, g).to(torch.int32)
    refrac = torch.where(spikes, p.ref_steps,
                         torch.clamp(state.refrac - 1, min=0)).to(torch.int32)
    return LIFState(v=v, g=g, refrac=refrac), spikes


def poisson_drive(key: torch.Tensor, n: int, rate_hz: float, dt_ms: float,
                  mask: torch.Tensor | None = None, *,
                  partitionable: bool = True) -> torch.Tensor:
    """Bernoulli(rate*dt) spike draw for Poisson inputs / background."""
    p = rate_hz * dt_ms * 1e-3
    draws = prng.bernoulli(key, p, (n,), partitionable=partitionable)
    if mask is not None:
        draws = draws & mask
    return draws


def fx_to_mv(x: torch.Tensor, params: LIFParams) -> torch.Tensor:
    return (x.to(torch.float32) / f32(params.fx_one, x)) * f32s(params.w_scale)


def mv_to_fx(x: torch.Tensor, params: LIFParams) -> torch.Tensor:
    # XLA folds the reference's x / w_scale * fx_one into one multiply by
    # float32(fx_one) / float32(w_scale), rounded to float32; so does this
    scale = np.float32(params.fx_one) / np.float32(params.w_scale)
    return torch.round(x * float(scale)).to(torch.int32)


__all__ = ["FLT_MIN", "FLYWIRE_LIF", "FLYWIRE_LIF_1MS", "FX_FRAC_BITS",
           "LIFParams", "LIFState", "f32", "f32s", "fma_f32", "ftz", "fx_to_mv",
           "init_state", "lif_step", "lif_step_fx", "mv_to_fx",
           "poisson_drive", "wrap_i32"]
