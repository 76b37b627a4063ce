// Block-gated synaptic delivery over the blocked-ELL tile store.
//
// Replaces: repro/kernels/spike_prop/kernel.py::spike_deliver_pallas
// (body _deliver_body), the `blocked` engine's per-step delivery.
//
// out[tb, t] = sum over slots e of tb, over source columns c, of
//              weights[tb, e, c, t] * spk[blk_id[tb, e], c],
// where a slot whose source block has nspk == 0 is skipped.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 without tensor cores):
// bytes, counted for the step's spikes.  The data this call needs is nspk,
// the live source blocks' spike entries, the slot of every (live source
// block, target block) pair (4 B, what a slot index would hold), out, and
// one 256-byte int16 tile row for every (target block, spiking source
// neuron) pair; it does two operations per weight read, far below the
// float32 rate.  At the main path's activity that is ~1 MB, ~0.0003 ms;
// with every source spiking it is the whole 38.8 GB store, ~11.6 ms.
//
// Design against that bound: deliver.cuh's block_sum, which this kernel
// shares with fused_deliver_lif.cu.  One block of 128 threads per target
// block; it never walks the E slots of its row: it lists the live source
// blocks from nspk, finds their slots in the ascending blk_id row, and
// streams only their spiking tile rows through cp.async double buffers, in
// full units of 32 rows at any activity.  The sum goes straight to out.
#include <cuda_runtime.h>

#include <cstdint>

#include "deliver.cuh"

namespace {

__global__ void __launch_bounds__(deliver::BLK, deliver::MIN_BLOCKS)
    spike_deliver_kernel(const int32_t* __restrict__ blk_id,
                         const int16_t* __restrict__ weights,
                         const float* __restrict__ spk,
                         const int32_t* __restrict__ nspk,
                         float* __restrict__ out, int E, int n_sb) {
  __shared__ __align__(16) deliver::Scratch sh;
  const float acc = deliver::block_sum(blk_id, weights, spk, nspk, E, n_sb, sh);
  out[static_cast<size_t>(blockIdx.x) * deliver::BLK + threadIdx.x] = acc;
}

}  // namespace

extern "C" int spike_deliver_launch(const void* blk_id, const void* weights,
                                    const void* spk, const void* nspk,
                                    void* out, int n_tb, int E, int n_sb,
                                    void* stream) {
  if (n_tb > 0) {
    spike_deliver_kernel<<<n_tb, deliver::BLK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk_id),
        static_cast<const int16_t*>(weights), static_cast<const float*>(spk),
        static_cast<const int32_t*>(nspk), static_cast<float*>(out), E, n_sb);
  }
  return static_cast<int>(cudaGetLastError());
}
