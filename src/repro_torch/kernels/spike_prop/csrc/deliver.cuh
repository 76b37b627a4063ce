// The blocked-ELL tile store, and the delivery both spike_prop kernels
// share (spike_deliver.cu, fused_deliver_lif.cu).
//
// Layout (built by repro_torch/kernels/spike_prop/ops.py):
//   blk_id  [n_tb, E]                   int32   source block of each tile
//                                               slot; every row strictly
//                                               ascending, its pad slots
//                                               (the zero block n_sb) last
//                                               (ops.check_row_order)
//   weights [n_tb, E, SRC_BLK, TGT_BLK] int16   source-major tiles: row c of
//                                               a tile is source neuron c's
//                                               weights onto the 128 targets
//   spk     [n_sb + 1, SRC_BLK]         float32 spikes by source block
//   nspk    [n_sb + 1]                  int32   spikes per source block, the
//                                               gate: a block is live iff > 0
//
// block_sum() gives thread t of the CUDA block that owns target block tb
//   sum over the slots e of tb whose source block sb = blk_id[tb, e] is
//   live, over the spiking columns c of sb, of weights[tb, e, c, t] *
//   spk[sb, c],
// in float32 on the CUDA cores.  The weights are integers held exactly in
// int16 and the spikes 0/1, so every product and partial sum (below 2^24)
// is exact and any order of the terms gives the same sum: no tensor cores,
// no TF32.
//
// The bound is bytes: nspk, the live source blocks' spike entries, a slot
// lookup per (live source block, target block) pair, and one 256-byte
// tile row per (target block, spiking source neuron) pair with a stored
// tile.  The design reads only those, and keeps every step's work per
// live tile and per row small, from a few spikes a step to all of them:
//   1. Live list, 128 source blocks (a window) at a time.  Each thread
//      reads one nspk (the next window's load already in flight); a
//      thread whose block is live finds its slot in this row (find_slot:
//      one probe where the row holds every source block, as nearly all
//      FlyWire rows do, else a binary search), and the found (slot,
//      block) pairs are compacted with a ballot and a prefix sum.  A
//      silent block costs one nspk read; no slot is walked.
//   2. Column lists, BATCH found tiles at a time: each warp lists its
//      tiles' spiking columns with four ballots a tile over one coalesced
//      read of the 512-byte spike block, between two block barriers for
//      the whole batch.
//   3. Units of 32 staged rows, taken in order through the batch's lists
//      and on into the next batch and window, so a unit is full whatever
//      the spiking columns per tile: each staged row carries its own slot
//      and column, and its spike value arrives with it by a 4-byte
//      cp.async.  The rows (coalesced 256-byte reads) are copied into
//      shared memory by cp.async, double-buffered: the next unit is in
//      flight while the current one is summed, so with every source
//      spiking each block streams its row of the store at the memory's
//      pace.
//   4. 18.3 KB of shared memory and the register budget of
//      __launch_bounds__(128, MIN_BLOCKS) let 9 blocks share an SM, so all
//      1,088 target blocks of FlyWire are resident at once (132 x 9 =
//      1,188): no second wave at any activity.
#pragma once

#include <cstdint>

#include "async_copy.cuh"

namespace deliver {

constexpr int BLK = 128;       // TGT_BLK == SRC_BLK: one thread a target row
constexpr int WARPS = BLK / 32;
constexpr int UNIT = 32;       // tile rows staged per unit (8 KB)
constexpr int TILES_PER_WARP = 2;
constexpr int BATCH = WARPS * TILES_PER_WARP;  // tiles listed at once
constexpr int MIN_BLOCKS = 9;  // resident blocks an SM must hold

struct Scratch {
  int16_t rows[2][UNIT][BLK];  // staged tile rows, double-buffered
  float sval[2][UNIT];         // the spike value of each staged row
  int slot[BLK];               // the window's live blocks with a tile in
  int src[BLK];                // this row: slot and source block
  uint8_t cols[BATCH][BLK];    // the batch's tiles: spiking columns
  int n_cols[BATCH];           // and their number
  int warp_n[WARPS];
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
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_n[w];
    off += w < warp ? c : 0;
    total += c;
  }
  return off + __popc(m & ((1u << lane) - 1u));
}

// The slot of source block sb in an ascending blk_id row of E slots, or -1.
// The ids of a row are distinct and >= 0, so the slot is at most sb, and
// it is sb where the row holds every block below sb: that is tried first.
__device__ __forceinline__ int find_slot(const int32_t* __restrict__ row,
                                         int E, int sb) {
  if (sb < E && __ldg(row + sb) == sb) return sb;
  const int end = min(sb, E);
  int lo = 0, n = end;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(row + lo + half) < sb) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo < end && __ldg(row + lo) == sb ? lo : -1;
}

// Thread t's delivered sum for target block blockIdx.x; every thread of
// the block calls it (it holds block-wide barriers).
__device__ __forceinline__ float block_sum(const int32_t* __restrict__ blk_id,
                                           const int16_t* __restrict__ weights,
                                           const float* __restrict__ spk,
                                           const int32_t* __restrict__ nspk,
                                           int E, int n_sb, Scratch& sh) {
  const int tb = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int32_t* row = blk_id + static_cast<size_t>(tb) * E;
  const int16_t* tiles = weights + static_cast<size_t>(tb) * E * (BLK * BLK);

  // Producer state, the same in every thread: the next window to scan,
  // the window's found tiles and the next of them to list, the current
  // batch's first tile, its rows and how many of them are staged.
  int w0 = 0, n_found = 0, next = 0, b0 = 0, n_rows = 0, taken = 0;
  int nspk_next = t < n_sb ? nspk[t] : 0;

  // Issue the cp.async copies of the next unit of rows into buffer `buf`;
  // returns its row count, 0 when every live tile has been staged.
  auto next_unit = [&](int buf) -> int {
    int filled = 0;
    for (;;) {
      if (taken < n_rows) {  // the batch's next rows, up to a full unit
        const int n = min(UNIT - filled, n_rows - taken);
        const int rr = t >> 2, part = t & 3;  // 4 threads a 256-byte row
        if (rr >= filled && rr < filled + n) {
          int r = taken + rr - filled, i = 0;
          while (r >= sh.n_cols[i]) r -= sh.n_cols[i++];
          const int c = sh.cols[i][r], sb = sh.src[b0 + i];
          const int16_t* from =
              tiles + static_cast<size_t>(sh.slot[b0 + i] * BLK + c) * BLK +
              part * 32;
          int16_t* to = &sh.rows[buf][rr][part * 32];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            async_copy::copy16(to + q * 8, from + q * 8);
          if (part == 0)
            async_copy::copy4(&sh.sval[buf][rr],
                              spk + static_cast<size_t>(sb) * BLK + c);
        }
        filled += n;
        taken += n;
        if (filled == UNIT) return filled;
      }
      if (next < n_found) {  // list the next batch of found tiles
        b0 = next;
        next += BATCH;
        __syncthreads();  // the previous batch's lists have been read
        float s[TILES_PER_WARP][4];
#pragma unroll
        for (int j = 0; j < TILES_PER_WARP; ++j) {
          const int i = b0 + warp * TILES_PER_WARP + j;
          const float* blk =
              spk + static_cast<size_t>(i < n_found ? sh.src[i] : n_sb) * BLK;
#pragma unroll
          for (int q = 0; q < 4; ++q) s[j][q] = __ldg(blk + q * 32 + lane);
        }
#pragma unroll
        for (int j = 0; j < TILES_PER_WARP; ++j) {
          const int li = warp * TILES_PER_WARP + j;
          int total = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool on = s[j][q] != 0.0f;
            const unsigned m = __ballot_sync(0xffffffffu, on);
            if (on)
              sh.cols[li][total + __popc(m & ((1u << lane) - 1u))] =
                  static_cast<uint8_t>(q * 32 + lane);
            total += __popc(m);
          }
          if (lane == 0) sh.n_cols[li] = total;
        }
        __syncthreads();
        n_rows = 0;
#pragma unroll
        for (int i = 0; i < BATCH; ++i) n_rows += sh.n_cols[i];
        taken = 0;
        continue;
      }
      if (w0 >= n_sb) return filled;
      // the next window: its live blocks that have a tile in this row
      const int sb = w0 + t;
      const bool live = sb < n_sb && nspk_next > 0;
      const int ahead = w0 + BLK + t;
      nspk_next = ahead < n_sb ? nspk[ahead] : 0;
      const int e = live ? find_slot(row, E, sb) : -1;
      const int pos = compact(e >= 0, n_found, sh.warp_n);
      if (e >= 0) {  // (the first listing's barrier publishes these)
        sh.slot[pos] = e;
        sh.src[pos] = sb;
      }
      w0 += BLK;
      next = 0;
    }
  };

  float acc = 0.0f;
  int n_cur = next_unit(0);
  async_copy::commit();
  for (int k = 0; n_cur > 0; ++k) {
    const int b = k & 1;
    const int n_next = next_unit(b ^ 1);  // buffer b ^ 1 was freed below
    async_copy::commit();
    async_copy::wait<1>();  // this thread's copies of unit k have landed
    __syncthreads();        // and everyone's
    const int16_t* w = &sh.rows[b][0][t];
    const float* sv = sh.sval[b];
    int q = 0;
    for (; q + 4 <= n_cur; q += 4) {
      const float w0f = static_cast<float>(w[(q + 0) * BLK]);
      const float w1f = static_cast<float>(w[(q + 1) * BLK]);
      const float w2f = static_cast<float>(w[(q + 2) * BLK]);
      const float w3f = static_cast<float>(w[(q + 3) * BLK]);
      acc = __fadd_rn(acc, __fmul_rn(w0f, sv[q + 0]));
      acc = __fadd_rn(acc, __fmul_rn(w1f, sv[q + 1]));
      acc = __fadd_rn(acc, __fmul_rn(w2f, sv[q + 2]));
      acc = __fadd_rn(acc, __fmul_rn(w3f, sv[q + 3]));
    }
    for (; q < n_cur; ++q)
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(w[q * BLK]), sv[q]));
    __syncthreads();  // buffer b is free for unit k + 2
    n_cur = n_next;
  }
  async_copy::wait<0>();
  return acc;
}

}  // namespace deliver
