// Fused delivery -> LIF: one whole timestep of a 128-neuron target block.
//
// Replaces: repro/kernels/spike_prop/kernel.py::fused_deliver_lif_pallas
// (bodies _accumulate_tile and _fused_body), the `blocked_fused` engine.
//
// out = the gated tile sums of spike_deliver.cu (a slot is live iff its
// source block has nspk > 0), then one LIF step (lif.cuh) per neuron, in
// float32 (FX = false, drive acc * w_scale) or in Q19.12 (FX = true, drive
// rint(acc)), writing v, g, refrac and the spike.  The delivered current
// never leaves registers.  The stimulus channels gstim (float32 weight
// units), vin (float32 mV, or int32 weight units when FX) and force (int32
// 0/1) are null when absent.
//
// Bound on an H100 (3.35 TB/s): bytes, counted for the step's spikes.  The
// call must read nspk (4 B a source block), the spike entries of the live
// source blocks (512 B each), the slot of every (live source block, target
// block) pair (4 B, what a slot index would hold; the search below reads
// one 32-byte sector a probe, ~11 a pair, mostly from L2), one 256-byte
// int16 tile row for every (target block, spiking source neuron) pair with
// a stored tile, and the LIF state read and written once (v, g, refrac in;
// v, g, refrac, spikes out; 4 B each per neuron) with the stimulus
// channels present.  At the main path's activity (0-3 live source blocks,
// a few spikes a step) that is ~5 MB, ~0.0015 ms, almost all of it the
// state and the spiking rows; with every source spiking it is the whole
// 38.8 GB store, ~11.6 ms.
//
// Design against that bound.  One block of 128 threads per target block;
// thread t owns target row t and keeps its sum in a register.
//   1. Live list.  The block reads nspk 128 source blocks at a time (one
//      coalesced load a thread, the next window's already in flight) and
//      compacts the live ids with a ballot and a prefix sum.  A silent
//      source block costs one read of nspk and nothing else: the block
//      never walks its E slots.
//   2. Slot search.  tile_coo (ops.py) leaves every blk_id row ascending,
//      pad slots (n_sb) last, so the slot of a live source block in this
//      row is a lower_bound: at most ~11 probes, one thread per live block,
//      all in parallel.  A search was chosen over an [n_sb, n_tb] slot
//      index (4.7 MB at FlyWire size, built with the store) because it
//      needs no second structure to keep in step with blk_id, and its
//      probes hit L2 (a row is 4.4 KB).  A live block with no tile in this
//      row drops out here.
//   3. Staged rows.  For each live tile, only its spiking columns are read:
//      each a coalesced 256-byte row of the source-major tile.  The rows
//      are copied into shared memory with cp.async in units of 32 (8 KB),
//      double-buffered: the next unit is in flight while the current one
//      is summed, so with every source spiking each block streams its row
//      of the store at the memory's pace.  The 18.9 KB of shared memory
//      and <= 56 registers a thread let 9 blocks share an SM, so all 1,088
//      target blocks of FlyWire are resident at once (132 x 9 = 1,188):
//      no second wave at either activity.
//   4. The LIF state is loaded before delivery starts, so its latency
//      hides behind it; the epilogue is lif.cuh's step, unchanged.
// Exactness: the weights are integers held exactly in int16 and the
// spikes 0/1, so every product and partial sum (below 2^24) is exact in
// float32 and the live-list order gives the same sum as any other.  No
// tensor cores and no TF32.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "lif.cuh"
#include "tiles.cuh"

namespace {

using tiles::BLK;
constexpr int UNIT = 32;       // tile rows staged per unit (8 KB)
constexpr int MIN_BLOCKS = 9;  // resident blocks an SM must hold

struct Scratch {
  int16_t rows[2][UNIT][BLK];  // staged tile rows, double-buffered
  float sval[2][UNIT];         // the spike value of each staged row
  int sb[BLK];                 // the window's live source blocks
  int slot[BLK];               // of those with a tile in this row: slot
  int src[BLK];                //                                   block
  tiles::SlotScratch tile;     // the producer's tile: its spiking columns
};

// The slot of source block sb in an ascending blk_id row, or -1.
__device__ __forceinline__ int find_slot(const int32_t* __restrict__ row,
                                         int E, int sb) {
  int lo = 0, n = E;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(row + lo + half) < sb) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo < E && __ldg(row + lo) == sb ? lo : -1;
}

template <bool FX>
__global__ void __launch_bounds__(BLK, MIN_BLOCKS)
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
  __shared__ __align__(16) Scratch sh;
  const int tb = blockIdx.x, t = threadIdx.x;
  const size_t r = static_cast<size_t>(tb) * BLK + t;

  // the LIF inputs, in flight while the block delivers
  S v = static_cast<const S*>(v_in)[r];
  S g = static_cast<const S*>(g_in)[r];
  int32_t refrac = refrac_in[r];
  const float gs = gstim ? gstim[r] : 0.0f;
  const S vi = vin ? static_cast<const S*>(vin)[r] : S(0);
  const bool f = force ? force[r] != 0 : false;

  // Producer state, the same in every thread: the next window of source
  // blocks to scan, the found list's length and cursor, and the current
  // tile's slot, spiking-column count and next unit.
  const int32_t* row = blk_id + static_cast<size_t>(tb) * E;
  int w0 = 0, n_found = 0, li = 0, e_cur = 0, n_cols = 0, j = 0;
  int nspk_next = t < n_sb ? nspk[t] : 0;

  // Issue the cp.async copies of the next unit of rows into buffer `buf`;
  // returns its row count, 0 when every live tile has been staged.  Every
  // thread calls it (it holds block-wide barriers).
  auto next_unit = [&](int buf) -> int {
    for (;;) {
      if (j * UNIT < n_cols) {  // the current tile's next unit
        const int k0 = j * UNIT, n = min(UNIT, n_cols - k0);
        ++j;
        const int rr = t >> 2, part = t & 3;  // 4 threads a 256-byte row
        if (rr < n) {
          const int c = sh.tile.cols[k0 + rr];
          const int16_t* src =
              tiles::tile_ptr(weights, tb, E, e_cur) + c * BLK + part * 32;
          int16_t* dst = &sh.rows[buf][rr][part * 32];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            async_copy::copy16(dst + q * 8, src + q * 8);
          if (part == 0) sh.sval[buf][rr] = sh.tile.spk[c];
        }
        return n;
      }
      if (li < n_found) {  // the window's next live tile: its columns
        e_cur = sh.slot[li];
        const int sb = sh.src[li];
        ++li;
        n_cols = tiles::list_columns(spk[static_cast<size_t>(sb) * BLK + t],
                                     sh.tile);
        j = 0;
        continue;
      }
      if (w0 >= n_sb) return 0;
      // the next window: live source blocks, then their slots in this row
      const bool live = w0 + t < n_sb && nspk_next > 0;
      const int ahead = w0 + BLK + t;
      nspk_next = ahead < n_sb ? nspk[ahead] : 0;
      int n_live;
      const int pos = tiles::compact(live, n_live, sh.tile.warp_n);
      if (live) sh.sb[pos] = w0 + t;
      w0 += BLK;
      __syncthreads();
      n_found = 0;
      li = 0;
      if (n_live == 0) continue;
      int e = -1, sb = 0;
      if (t < n_live) {
        sb = sh.sb[t];
        e = find_slot(row, E, sb);
      }
      const int fpos = tiles::compact(e >= 0, n_found, sh.tile.warp_n);
      if (e >= 0) {
        sh.slot[fpos] = e;
        sh.src[fpos] = sb;
      }
      __syncthreads();
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
    __syncthreads();     // and everyone's
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
    kernel<<<n_tb, BLK, 0, static_cast<cudaStream_t>(stream)>>>(
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
