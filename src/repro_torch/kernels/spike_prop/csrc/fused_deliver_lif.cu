// Fused delivery -> LIF: one whole timestep of a 128-neuron target block.
//
// Replaces: repro/kernels/spike_prop/kernel.py::fused_deliver_lif_pallas
// (bodies _accumulate_tile and _fused_body), the `blocked_fused` engine.
//
// The gated tile accumulation of spike_deliver.cu, with the gate derived in
// the kernel from the staged spike block (any(s != 0), __syncthreads_or)
// instead of a count array; then each thread applies one LIF step
// (lif.cuh) to its own neuron, in float32 (FX = false, drive acc * w_scale)
// or in Q19.12 (FX = true, drive rint(acc)), and writes v, g, refrac and
// its spike.  The delivered current never leaves registers.  The stimulus
// channels gstim (float32 weight units), vin (float32 mV, or int32 weight
// units when FX) and force (int32 0/1) are null when absent.
//
// Bound on an H100 (3.35 TB/s): bytes, as for spike_deliver, plus the LIF
// state read and written once (v, g, refrac in; v, g, refrac, spikes out,
// 4 B each per neuron) and the stimulus channels that are present.
//
// Design against that bound: as spike_deliver.cu, except that the gate of a
// slot needs its spike block, so each thread loads its entry of the next
// slot's block before the current slot's barrier; the load's latency hides
// behind the barrier and the accumulation instead of being paid per slot.
// The LIF epilogue adds the state traffic only, once per neuron.
#include <cuda_runtime.h>

#include <cstdint>

#include "lif.cuh"
#include "tiles.cuh"

namespace {

template <bool FX>
__global__ void __launch_bounds__(tiles::BLK)
    fused_deliver_lif_kernel(const int32_t* __restrict__ blk_id,
                             const int16_t* __restrict__ weights,
                             const float* __restrict__ spk,
                             const void* __restrict__ v_in,
                             const void* __restrict__ g_in,
                             const int32_t* __restrict__ refrac_in,
                             const float* __restrict__ gstim,
                             const void* __restrict__ vin,
                             const int32_t* __restrict__ force,
                             void* __restrict__ v_out, void* __restrict__ g_out,
                             int32_t* __restrict__ refrac_out,
                             int32_t* __restrict__ spk_out, int E,
                             lif::F32Params pf, lif::FxParams px) {
  using tiles::BLK;
  using tiles::CHUNK;
  __shared__ tiles::SlotScratch sh;
  __shared__ int sbs[CHUNK];
  const int tb = blockIdx.x, t = threadIdx.x;
  float acc = 0.0f;
  for (int e0 = 0; e0 < E; e0 += CHUNK) {
    const int n = min(CHUNK, E - e0);
    __syncthreads();  // everyone is done reading the previous chunk
    for (int i = t; i < n; i += BLK)
      sbs[i] = blk_id[static_cast<size_t>(tb) * E + e0 + i];
    __syncthreads();
    float s = spk[static_cast<size_t>(sbs[0]) * BLK + t];
    for (int i = 0; i < n; ++i) {
      const float s_next =
          i + 1 < n ? spk[static_cast<size_t>(sbs[i + 1]) * BLK + t] : 0.0f;
      if (__syncthreads_or(s != 0.0f))  // uniform: the block is live
        acc = tiles::accumulate_live_tile(
            tiles::tile_ptr(weights, tb, E, e0 + i), s, acc, sh);
      s = s_next;
    }
  }

  const size_t r = static_cast<size_t>(tb) * BLK + t;
  const float g_units =
      gstim ? lif::ftz(__fadd_rn(acc, lif::ftz(gstim[r]))) : acc;
  const bool f = force ? force[r] != 0 : false;
  int32_t refrac = refrac_in[r];
  bool spike;
  if constexpr (FX) {
    int32_t v = static_cast<const int32_t*>(v_in)[r];
    int32_t g = static_cast<const int32_t*>(g_in)[r];
    const int32_t vi = vin ? static_cast<const int32_t*>(vin)[r] : 0;
    spike = lif::step_fx(v, g, refrac, __float2int_rn(g_units), vin != nullptr,
                         vi, f, px);
    static_cast<int32_t*>(v_out)[r] = v;
    static_cast<int32_t*>(g_out)[r] = g;
  } else {
    float v = static_cast<const float*>(v_in)[r];
    float g = static_cast<const float*>(g_in)[r];
    const float vi = vin ? static_cast<const float*>(vin)[r] : 0.0f;
    spike = lif::step_f32(v, g, refrac, g_units, vin != nullptr, vi, f, pf);
    static_cast<float*>(v_out)[r] = v;
    static_cast<float*>(g_out)[r] = g;
  }
  refrac_out[r] = refrac;
  spk_out[r] = spike ? 1 : 0;
}

}  // namespace

extern "C" int fused_deliver_lif_launch(
    const void* blk_id, const void* weights, const void* spk, const void* v,
    const void* g, const void* refrac, const void* gstim, const void* vin,
    const void* force, void* v_out, void* g_out, void* refrac_out,
    void* spk_out, int n_tb, int E, int fixed_point, float w_scale,
    float alpha_m, float v0, float decay_g, float v_th, float v_r,
    int fx_v0, int fx_alpha_m16, int fx_gdecay16, int fx_v_th, int fx_v_r,
    int ref_steps, void* stream) {
  const lif::F32Params pf{w_scale, alpha_m, v0, decay_g, v_th, v_r, ref_steps};
  const lif::FxParams px{fx_v0, fx_alpha_m16, fx_gdecay16,
                         fx_v_th, fx_v_r, ref_steps};
  auto kernel = fixed_point ? fused_deliver_lif_kernel<true>
                            : fused_deliver_lif_kernel<false>;
  if (n_tb > 0) {
    kernel<<<n_tb, tiles::BLK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk_id),
        static_cast<const int16_t*>(weights), static_cast<const float*>(spk),
        v, g, static_cast<const int32_t*>(refrac),
        static_cast<const float*>(gstim), vin,
        static_cast<const int32_t*>(force), v_out, g_out,
        static_cast<int32_t*>(refrac_out), static_cast<int32_t*>(spk_out), E,
        pf, px);
  }
  return static_cast<int>(cudaGetLastError());
}
