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
// float32 rate.  This kernel reads all of blk_id (4 B per slot) besides,
// which at a few spikes a step is most of what it moves.
//
// Design against that bound: one CUDA block of 128 threads per target block
// (thread = target row), walking its E slots in a loop that takes the place
// of the TPU's sequential grid axis.  The slot ids and their gates
// (nspk[sb] > 0) are staged in shared memory CHUNK at a time with
// independent loads, so the walk over silent slots costs a shared-memory
// read each, uniform over the block.  In a live slot only the spiking
// columns are read, each a coalesced 256-byte row of the source-major tile,
// and the int16 store halves the bytes of the reference's float32 tiles.
// Sums are float32 on CUDA cores: no tensor cores and no TF32, because the
// sums must be exact.  Later work: TMA rings for dense activity, a
// persistent grid, a live-slot list built once per step.
#include <cuda_runtime.h>

#include <cstdint>

#include "tiles.cuh"

namespace {

__global__ void __launch_bounds__(tiles::BLK)
    spike_deliver_kernel(const int32_t* __restrict__ blk_id,
                         const int16_t* __restrict__ weights,
                         const float* __restrict__ spk,
                         const int32_t* __restrict__ nspk,
                         float* __restrict__ out, int E) {
  using tiles::BLK;
  using tiles::CHUNK;
  __shared__ tiles::SlotScratch sh;
  __shared__ int live_sb[CHUNK];  // source block of a staged slot, -1 if gated
  const int tb = blockIdx.x, t = threadIdx.x;
  float acc = 0.0f;
  for (int e0 = 0; e0 < E; e0 += CHUNK) {
    const int n = min(CHUNK, E - e0);
    __syncthreads();  // everyone is done reading the previous chunk
    for (int i = t; i < n; i += BLK) {
      const int sb = blk_id[static_cast<size_t>(tb) * E + e0 + i];
      live_sb[i] = nspk[sb] > 0 ? sb : -1;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int sb = live_sb[i];
      if (sb < 0) continue;  // uniform over the block
      const float s = spk[static_cast<size_t>(sb) * BLK + t];
      acc = tiles::accumulate_live_tile(tiles::tile_ptr(weights, tb, E, e0 + i),
                                        s, acc, sh);
    }
  }
  out[static_cast<size_t>(tb) * BLK + t] = acc;
}

}  // namespace

extern "C" int spike_deliver_launch(const void* blk_id, const void* weights,
                                    const void* spk, const void* nspk,
                                    void* out, int n_tb, int E,
                                    void* stream) {
  if (n_tb > 0) {
    spike_deliver_kernel<<<n_tb, tiles::BLK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk_id),
        static_cast<const int16_t*>(weights), static_cast<const float*>(spk),
        static_cast<const int32_t*>(nspk), static_cast<float*>(out), E);
  }
  return static_cast<int>(cudaGetLastError());
}
