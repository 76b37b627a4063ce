// One LIF step for one neuron, in float32 or in int32 Q19.12.
//
// Device-side counterpart of repro_torch/core/neuron.py::lif_step and
// ::lif_step_fx (and of the reference's repro/core/neuron.py), applied by
// one thread to its own neuron.  It is written to be bit-exact with the
// reference:
//   * float32: every operation is an explicit round-to-nearest intrinsic.
//     The two sites that XLA contracts into fused multiply-adds,
//     g + g_units * w_scale and v + alpha_m * ((v0 - v) + g), are
//     __fmaf_rn; nothing else is fused (the sources are also built with
//     -fmad=false).  XLA's CPU code flushes float32 subnormals, in and
//     out of every operation; ftz() does the same explicitly around each
//     operation (the build keeps -ftz=false, so nothing else is flushed),
//     and a refractory neuron's v and g pass through untouched.
//   * Q19.12: jnp wraps on int32 overflow and shifts right arithmetically.
//     Adds, subtracts, multiplies and the << 12 go through uint32 so that
//     nothing relies on signed overflow; >> stays on int32 (arithmetic).
//
// The fused delivery->LIF kernel (kernels/spike_prop) and the standalone
// LIF kernels (kernels/lif) include it from this shared directory, whose
// files kernels/build.py hashes into every library's name.
#pragma once

#include <cfloat>
#include <cstdint>

namespace lif {

// Zero of x's sign for a subnormal x (flush-to-zero / denormals-are-zero).
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

struct F32Params {
  float w_scale, alpha_m, v0, decay_g, v_th, v_r;
  int ref_steps;
};

struct FxParams {
  int32_t v0, alpha_m16, gdecay16, v_th, v_r, ref_steps;
};

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t shl12(int32_t a) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << 12);
}

// g_units: delivered plus stimulus drive in weight units.  Returns spiked.
__device__ __forceinline__ bool step_f32(float& v, float& g, int32_t& refrac,
                                         float g_units, bool has_vin,
                                         float v_in, bool force,
                                         const F32Params& p) {
  const bool active = refrac <= 0;
  if (active) {
    g = ftz(__fmaf_rn(ftz(g_units), p.w_scale, ftz(g)));
    v = ftz(v);
    if (has_vin) v = ftz(__fadd_rn(v, ftz(v_in)));
    v = ftz(__fmaf_rn(p.alpha_m, ftz(__fadd_rn(ftz(__fsub_rn(p.v0, v)), g)),
                      v));
    g = ftz(__fmul_rn(g, p.decay_g));
  }
  const bool spike = active && (v > p.v_th || force);
  if (spike) {
    v = p.v_r;
    g = 0.0f;
    refrac = p.ref_steps;
  } else {
    refrac = refrac > 1 ? refrac - 1 : 0;
  }
  return spike;
}

// x * m >> 14 with the product in 32 bits (wrapping, as the reference's
// jnp int32 does) or, kWide, in 64 bits.
template <bool kWide>
__device__ __forceinline__ int32_t scale14(int32_t x, int32_t m) {
  if (kWide)
    return static_cast<int32_t>((static_cast<int64_t>(x) * m) >> 14);
  return mul32(x, m) >> 14;
}

// g_in_units: delivered plus stimulus drive, rounded half to even.  kWide
// takes the two decay products in 64 bits: the delay_event engine's
// networks (the cortical microcircuit: one inhibitory event is -160 weight
// units) drive |g| past 160 units, where the 32-bit g >> 2 times
// gdecay16 = 13107 (tau_g 0.5 ms) wraps.  Below that both agree bit for bit.
template <bool kWide = false>
__device__ __forceinline__ bool step_fx(int32_t& v, int32_t& g,
                                        int32_t& refrac, int32_t g_in_units,
                                        bool has_vin, int32_t v_in_units,
                                        bool force, const FxParams& p) {
  const bool active = refrac <= 0;
  if (active) {
    g = add32(g, shl12(g_in_units));
    if (has_vin) v = add32(v, shl12(v_in_units));
    const int32_t x = add32(sub32(p.v0, v), g);
    v = add32(v, scale14<kWide>(x >> 2, p.alpha_m16));
    g = sub32(g, scale14<kWide>(g >> 2, p.gdecay16));
  }
  const bool spike = active && (v > p.v_th || force);
  if (spike) {
    v = p.v_r;
    g = 0;
    refrac = p.ref_steps;
  } else {
    refrac = refrac > 1 ? refrac - 1 : 0;
  }
  return spike;
}

}  // namespace lif
