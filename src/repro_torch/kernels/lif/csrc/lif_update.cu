// The LIF step as its own kernel: one thread per neuron, float32 or Q19.12.
//
// Replaces: repro/kernels/lif/kernel.py::lif_update_f32 and
// ::lif_update_fx32 (bodies _lif_body_f32 and _lif_body_fx, both through
// _pallas_lif).  The TPU kernel walks [rows, 128] tiles of VMEM; here each
// thread reads its neuron's six inputs, applies lif.cuh's step (the same
// body the fused delivery->LIF kernel runs), and writes four outputs.
//
// As in the reference kernel, v_in and force are always read (the wrapper
// passes zeros when they are absent) and v_in is always added: in float32
// adding a zero still flushes a subnormal v.  The float kernel's g_in is in
// mV, so g + g_in is step_f32's fma(g_in, w_scale = 1, g), which rounds
// exactly as the add does.
//
// Bound on an H100 (3.35 TB/s): bytes.  40 B per neuron (six 4-byte inputs,
// four 4-byte outputs) against ~20 operations per neuron.  Design against
// that bound: consecutive threads own consecutive neurons, so every load
// and store of a warp is one coalesced 128-byte line; nothing else is read.
#include <cuda_runtime.h>

#include <cstdint>

#include "lif.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lif_f32_kernel(const float* __restrict__ v_in_state,
                   const float* __restrict__ g_in_state,
                   const int32_t* __restrict__ refrac_in,
                   const float* __restrict__ g_in,
                   const float* __restrict__ v_in,
                   const int32_t* __restrict__ force,
                   float* __restrict__ v_out, float* __restrict__ g_out,
                   int32_t* __restrict__ refrac_out,
                   int32_t* __restrict__ spk_out, int n, lif::F32Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = v_in_state[i], g = g_in_state[i];
  int32_t refrac = refrac_in[i];
  const bool spike =
      lif::step_f32(v, g, refrac, g_in[i], true, v_in[i], force[i] != 0, p);
  v_out[i] = v;
  g_out[i] = g;
  refrac_out[i] = refrac;
  spk_out[i] = spike ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    lif_fx_kernel(const int32_t* __restrict__ v_in_state,
                  const int32_t* __restrict__ g_in_state,
                  const int32_t* __restrict__ refrac_in,
                  const int32_t* __restrict__ g_in,
                  const int32_t* __restrict__ v_in,
                  const int32_t* __restrict__ force,
                  int32_t* __restrict__ v_out, int32_t* __restrict__ g_out,
                  int32_t* __restrict__ refrac_out,
                  int32_t* __restrict__ spk_out, int n, lif::FxParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int32_t v = v_in_state[i], g = g_in_state[i], refrac = refrac_in[i];
  const bool spike =
      lif::step_fx(v, g, refrac, g_in[i], true, v_in[i], force[i] != 0, p);
  v_out[i] = v;
  g_out[i] = g;
  refrac_out[i] = refrac;
  spk_out[i] = spike ? 1 : 0;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int lif_update_f32_launch(
    const void* v, const void* g, const void* refrac, const void* g_in,
    const void* v_in, const void* force, void* v_out, void* g_out,
    void* refrac_out, void* spk_out, int n, float alpha_m, float v0,
    float decay_g, float v_th, float v_r, int ref_steps, void* stream) {
  const lif::F32Params p{1.0f, alpha_m, v0, decay_g, v_th, v_r, ref_steps};
  if (n > 0) {
    lif_f32_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<const int32_t*>(refrac), static_cast<const float*>(g_in),
        static_cast<const float*>(v_in), static_cast<const int32_t*>(force),
        static_cast<float*>(v_out), static_cast<float*>(g_out),
        static_cast<int32_t*>(refrac_out), static_cast<int32_t*>(spk_out), n,
        p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lif_update_fx32_launch(
    const void* v, const void* g, const void* refrac, const void* g_in,
    const void* v_in, const void* force, void* v_out, void* g_out,
    void* refrac_out, void* spk_out, int n, int fx_v0, int fx_alpha_m16,
    int fx_gdecay16, int fx_v_th, int fx_v_r, int ref_steps, void* stream) {
  const lif::FxParams p{fx_v0, fx_alpha_m16, fx_gdecay16,
                        fx_v_th, fx_v_r, ref_steps};
  if (n > 0) {
    lif_fx_kernel<<<blocks(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(v), static_cast<const int32_t*>(g),
        static_cast<const int32_t*>(refrac),
        static_cast<const int32_t*>(g_in), static_cast<const int32_t*>(v_in),
        static_cast<const int32_t*>(force), static_cast<int32_t*>(v_out),
        static_cast<int32_t*>(g_out), static_cast<int32_t*>(refrac_out),
        static_cast<int32_t*>(spk_out), n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
