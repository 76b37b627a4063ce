// Fused delivery -> LIF: one whole timestep of a 128-neuron target block.
//
// Replaces: repro/kernels/spike_prop/kernel.py::fused_deliver_lif_pallas
// (bodies _accumulate_tile and _fused_body), the `blocked_fused` engine.
//
// The delivered current is spike_deliver.cu's gated tile sum, computed by
// the same function, deliver.cuh's block_sum, which says how it meets its
// bound.  What is this kernel's own: one LIF step (lif.cuh) per neuron on
// that sum, in float32 (FX = false, drive acc * w_scale) or in Q19.12
// (FX = true, drive rint(acc)), writing v, g, refrac and the spike.  The
// sum never leaves registers.  The stimulus channels gstim (float32 weight
// units), vin (float32 mV, or int32 weight units when FX) and force (int32
// 0/1) are null when absent.
//
// Bound on an H100 (3.35 TB/s): bytes, counted for the step's spikes:
// spike_deliver.cu's, with the LIF state read and written once in place of
// out (v, g, refrac in; v, g, refrac, spikes out; 4 B each per neuron) and
// the stimulus channels present.  At the main path's activity that is
// ~4.5 MB, ~0.0013 ms, almost all of it the state and the spiking rows; with
// every source spiking it is the whole 38.8 GB store, ~11.6 ms.
//
// The LIF inputs are loaded before delivery starts, so their latency hides
// behind it; the epilogue is lif.cuh's step, unchanged.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "deliver.cuh"
#include "lif.cuh"

namespace {

template <bool FX>
__global__ void __launch_bounds__(deliver::BLK, deliver::MIN_BLOCKS)
    fused_deliver_lif_kernel(const int32_t* __restrict__ blk_id,
                             const int16_t* __restrict__ weights,
                             const float* __restrict__ spk,
                             const int32_t* __restrict__ nspk,
                             const void* __restrict__ v_in,
                             const void* __restrict__ g_in,
                             const int32_t* __restrict__ refrac_in,
                             const float* __restrict__ gstim,
                             const void* __restrict__ vin,
                             const int32_t* __restrict__ force,
                             void* __restrict__ v_out, void* __restrict__ g_out,
                             int32_t* __restrict__ refrac_out,
                             int32_t* __restrict__ spk_out, int E, int n_sb,
                             lif::F32Params pf, lif::FxParams px) {
  using S = std::conditional_t<FX, int32_t, float>;
  __shared__ __align__(16) deliver::Scratch sh;
  const size_t r =
      static_cast<size_t>(blockIdx.x) * deliver::BLK + threadIdx.x;

  // the LIF inputs, in flight while the block delivers
  S v = static_cast<const S*>(v_in)[r];
  S g = static_cast<const S*>(g_in)[r];
  int32_t refrac = refrac_in[r];
  const float gs = gstim ? gstim[r] : 0.0f;
  const S vi = vin ? static_cast<const S*>(vin)[r] : S(0);
  const bool f = force ? force[r] != 0 : false;

  const float acc =
      deliver::block_sum(blk_id, weights, spk, nspk, E, n_sb, sh);

  const float g_units = gstim ? lif::ftz(__fadd_rn(acc, lif::ftz(gs))) : acc;
  bool spike;
  if constexpr (FX) {
    spike = lif::step_fx(v, g, refrac, __float2int_rn(g_units), vin != nullptr,
                         vi, f, px);
  } else {
    spike = lif::step_f32(v, g, refrac, g_units, vin != nullptr, vi, f, pf);
  }
  static_cast<S*>(v_out)[r] = v;
  static_cast<S*>(g_out)[r] = g;
  refrac_out[r] = refrac;
  spk_out[r] = spike ? 1 : 0;
}

}  // namespace

extern "C" int fused_deliver_lif_launch(
    const void* blk_id, const void* weights, const void* spk, const void* nspk,
    const void* v, const void* g, const void* refrac, const void* gstim,
    const void* vin, const void* force, void* v_out, void* g_out,
    void* refrac_out, void* spk_out, int n_tb, int E, int n_sb,
    int fixed_point, float w_scale, float alpha_m, float v0, float decay_g,
    float v_th, float v_r, int fx_v0, int fx_alpha_m16, int fx_gdecay16,
    int fx_v_th, int fx_v_r, int ref_steps, void* stream) {
  const lif::F32Params pf{w_scale, alpha_m, v0, decay_g, v_th, v_r, ref_steps};
  const lif::FxParams px{fx_v0, fx_alpha_m16, fx_gdecay16,
                         fx_v_th, fx_v_r, ref_steps};
  auto kernel = fixed_point ? fused_deliver_lif_kernel<true>
                            : fused_deliver_lif_kernel<false>;
  if (n_tb > 0) {
    kernel<<<n_tb, deliver::BLK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk_id),
        static_cast<const int16_t*>(weights), static_cast<const float*>(spk),
        static_cast<const int32_t*>(nspk), v, g,
        static_cast<const int32_t*>(refrac), static_cast<const float*>(gstim),
        vin, static_cast<const int32_t*>(force), v_out, g_out,
        static_cast<int32_t*>(refrac_out), static_cast<int32_t*>(spk_out), E,
        n_sb, pf, px);
  }
  return static_cast<int>(cudaGetLastError());
}
