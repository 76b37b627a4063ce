// Blocked-ELL tile layout and the block-wide helpers of the two spike_prop
// kernels.
//
// Layout (built by repro_torch/kernels/spike_prop/ops.py):
//   blk_id  [n_tb, E]                 int32  source block of each tile slot;
//                                            pad slots name the zero block n_sb
//   weights [n_tb, E, SRC_BLK, TGT_BLK] int16 source-major tiles: row c of a
//                                            tile is source neuron c's weights
//                                            onto the block's 128 targets
//   spk     [n_sb + 1, SRC_BLK]       float32 spikes by source block; block
//                                            n_sb is all zero
// One CUDA block of 128 threads owns one target block; thread t owns target
// row t and keeps its sum in a register.
#pragma once

#include <cstdint>

namespace tiles {

constexpr int BLK = 128;    // TGT_BLK == SRC_BLK
constexpr int CHUNK = 512;  // tile slots whose block ids are staged at once

struct SlotScratch {
  float spk[BLK];     // the live source block's spikes
  int cols[BLK];      // its spiking columns, in column order
  int warp_n[BLK / 32];
};

// Block-wide stream compaction; every thread of the block calls it.
// Returns the position of this thread among those with `flag`, in thread
// order, and sets `total` to their number.  Its first barrier also tells
// the caller that every thread is done with what it read before the call.
__device__ __forceinline__ int compact(bool flag, int& total, int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  __syncthreads();  // warp_n's previous readers are done
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int off = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < BLK / 32; ++w) {
    const int c = warp_n[w];
    off += w < warp ? c : 0;
    total += c;
  }
  return off + __popc(m & ((1u << lane) - 1u));
}

// All 128 threads call this, each with its own entry s of a source block:
// lists the block's spiking columns (in column order) in sh.cols and its
// spikes in sh.spk, and returns the number of spiking columns.
__device__ __forceinline__ int list_columns(float s, SlotScratch& sh) {
  int total;
  const int pos = compact(s != 0.0f, total, sh.warp_n);
  sh.spk[threadIdx.x] = s;  // the previous readers of sh are done
  if (s != 0.0f) sh.cols[pos] = threadIdx.x;
  __syncthreads();
  return total;
}

// All 128 threads call this for one live slot, each with its own entry s
// of the source block: each thread adds tile[c][t] * spk[c] over the
// spiking columns only, a spiking column being one coalesced 256-byte row
// of the source-major tile, a silent one never read.  The weights are
// integers held exactly in int16, so every product and sum below is exact
// in float32 (partial sums stay below 2^24), whatever the order.
__device__ __forceinline__ float accumulate_live_tile(
    const int16_t* __restrict__ tile, float s, float acc, SlotScratch& sh) {
  const int t = threadIdx.x;
  const int total = list_columns(s, sh);
  int k = 0;
  for (; k + 4 <= total; k += 4) {  // four independent loads in flight
    const int c0 = sh.cols[k], c1 = sh.cols[k + 1], c2 = sh.cols[k + 2],
              c3 = sh.cols[k + 3];
    const float w0 = static_cast<float>(tile[c0 * BLK + t]);
    const float w1 = static_cast<float>(tile[c1 * BLK + t]);
    const float w2 = static_cast<float>(tile[c2 * BLK + t]);
    const float w3 = static_cast<float>(tile[c3 * BLK + t]);
    acc = __fadd_rn(acc, __fmul_rn(w0, sh.spk[c0]));
    acc = __fadd_rn(acc, __fmul_rn(w1, sh.spk[c1]));
    acc = __fadd_rn(acc, __fmul_rn(w2, sh.spk[c2]));
    acc = __fadd_rn(acc, __fmul_rn(w3, sh.spk[c3]));
  }
  for (; k < total; ++k) {
    const int c = sh.cols[k];
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(tile[c * BLK + t]),
                                   sh.spk[c]));
  }
  return acc;
}

__device__ __forceinline__ const int16_t* tile_ptr(const int16_t* weights,
                                                   int tb, int E, int e) {
  return weights + (static_cast<size_t>(tb) * E + e) * (BLK * BLK);
}

}  // namespace tiles
