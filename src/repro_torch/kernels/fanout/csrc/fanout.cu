// Delivery per synapse for the blocked_fused engine's local (P = 1) step, as
// two kernels.
//
// Replaces: repro/kernels/spike_prop/kernel.py::fused_deliver_lif_pallas on
// that path.  The TPU kernel (and fused_deliver_lif.cu, which the
// partitioned path keeps) streams a 128 x 128 int16 tile row of every live
// (target block, source block) pair: ~278 KB a spike at FlyWire's size
// against ~650 B of real synapses.  Here a spike reads its own fan-out and
// nothing else.
//
//  * fanout_scatter: reads the delayed slot of the spike ring, [B, n] bool,
//    16 lane-neurons a thread in one 16-byte load; each block lists its
//    spiking lane-neurons in shared memory; then, for every listed
//    (lane, source), adds each fan-out weight (source-major list: indptr,
//    int32 target, int16 weight) into acc[lane, target], an int32 [B, n]
//    sum, with fire-and-forget atomics (RED).  Integer adds are exact in any
//    order.  The block spreads its summed fan-out evenly over its threads
//    (an exclusive scan of the listed spikes' degrees; thread t takes every
//    kThreads-th synapse of their concatenation), so FlyWire's heavy-tailed
//    fan-out (1 to ~9.8k) keeps every thread busy.  The synapse events of
//    each lane are counted on the device: a thread's spikes of one lane,
//    summed over the warp's threads of that lane, one atomic a lane a warp.
//  * fanout_lif, one thread for kLifPer lane-neurons of one lane: reads acc
//    and writes 0 back where it read a nonzero sum, then applies exactly
//    fused_deliver_lif.cu's epilogue (the int32 sum as float32, the gstim
//    add flushed to zero, for Q19.12 the half-to-even rounding into
//    lif.cuh's narrow step_fx, else step_f32) on the contiguous [B, n]
//    state, and writes v, g, refrac and the spikes as [B, n] bool.  The
//    membrane drive v_mv is converted to Q19.12 weight units as apply_drive
//    converts it (an IEEE division, then round half to even, saturating).
//
// acc is the caller's and stays all zero between steps: the scatter adds into
// it, the LIF kernel reads and clears it.
//
// Exactness: the spikes are 0 or 1 and the weights integers, so the int32
// sum equals the tile kernels' float32 sum wherever every partial sum is
// below 2**24 (deliver.cuh's precondition), and its float conversion is the
// same value.
//
// Bound on an H100 (3.35 TB/s, 50 MB L2): the scatter reads the slot (1 B a
// lane-neuron) and 6 B a synapse event, and adds 4 B into acc, which stays
// in L2 at 32 lanes (17.8 MB); the LIF pass reads and writes each state field
// once (4 B a field; acc 4 B read; 1 B a spike), plus the channels present.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lif.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                 // lane-neurons a scatter thread reads
constexpr int kSpan = kThreads * kPer;   // lane-neurons a scatter block lists
constexpr int kWarps = kThreads / 32;
constexpr int kLifPer = 4;               // lane-neurons a LIF thread takes
constexpr int kLifSpan = kThreads * kLifPer;
constexpr unsigned kAll = 0xffffffffu;

// The warp's sum of v over the threads whose `key` equals the caller's,
// added by the lowest such thread into counter[key]; key < 0 adds nothing.
// Every thread of the warp calls it.
__device__ __forceinline__ void warp_count(int key, unsigned long long v,
                                           unsigned long long* counter) {
  const unsigned peers = __match_any_sync(kAll, key);
  unsigned long long sum = 0;
  for (unsigned m = peers; m != 0u; m &= m - 1u)
    sum += __shfl_sync(peers, v, __ffs(m) - 1);
  if (key >= 0 && sum != 0ull &&
      (threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
    atomicAdd(counter + key, sum);
}

__global__ void __launch_bounds__(kThreads)
    fanout_scatter_kernel(const uint8_t* __restrict__ slot, int head,
                          int64_t total, int n,
                          const int64_t* __restrict__ indptr,
                          const int32_t* __restrict__ tgt,
                          const int16_t* __restrict__ w,
                          int32_t* __restrict__ acc,
                          unsigned long long* __restrict__ syn_events) {
  __shared__ int list[kSpan];        // the block's spiking lane-neurons
  __shared__ int off[kSpan + 1];     // their first synapses, scanned
  __shared__ int warp_sum[kWarps];
  __shared__ int listed;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();

  // slot is 16-byte aligned; byte p holds lane-neuron p - head
  const int64_t end = head + total;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kSpan + threadIdx.x * kPer;
  if (p0 < end) {
    uint32_t q[4] = {0u, 0u, 0u, 0u};
    if (p0 + kPer <= end) {
      const uint4 x = *reinterpret_cast<const uint4*>(slot + p0);
      q[0] = x.x, q[1] = x.y, q[2] = x.z, q[3] = x.w;
    } else {
      for (int j = 0; p0 + j < end; ++j)
        q[j >> 2] |= static_cast<uint32_t>(slot[p0 + j] != 0) << (8 * (j & 3));
    }
    if (q[0] | q[1] | q[2] | q[3]) {
      for (int j = 0; j < kPer; ++j) {
        const int64_t e = p0 + j - head;
        if (((q[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0u && e >= 0)
          list[atomicAdd(&listed, 1)] = static_cast<int>(e);
      }
    }
  }
  __syncthreads();
  const int nspk = listed;
  if (nspk == 0) return;             // uniform over the block
  const int me = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the degrees of the listed spikes, thread t holding spikes
  // [t * per, (t + 1) * per); an exclusive scan over the block gives each
  // spike's first synapse in the concatenation (< 2**31: the wrapper checks
  // kSpan times the widest fan-out)
  const int per = (nspk + kThreads - 1) / kThreads;
  const int s0 = min(nspk, static_cast<int>(threadIdx.x) * per);
  const int s1 = min(nspk, s0 + per);
  int mine = 0;
  for (int s = s0; s < s1; ++s) {
    const int e = list[s];
    const int src = e % n;
    const int d = static_cast<int>(indptr[src + 1] - indptr[src]);
    off[s] = d;
    mine += d;
  }
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, o);
    if (me >= o) incl += y;
  }
  if (me == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int i = 0; i < warp; ++i) run += warp_sum[i];
  for (int s = s0; s < s1; ++s) {
    const int d = off[s];
    off[s] = run;
    run += d;
  }
  if (threadIdx.x == kThreads - 1) off[nspk] = run;
  __syncthreads();
  const int events = off[nspk];

  // each lane's events: this thread's spikes, warp-aggregated
  for (int s = s0; s < s0 + per; ++s) {
    const int key = s < s1 ? list[s] / n : -1;
    const unsigned long long d =
        s < s1 ? static_cast<unsigned long long>(off[s + 1] - off[s]) : 0ull;
    warp_count(key, d, syn_events);
  }

  // synapse j of the concatenation: spike s with off[s] <= j < off[s + 1]
  int s = 0;
  int64_t first = 0;
  int32_t* a = acc;
  bool fresh = true;
  for (int j = threadIdx.x; j < events; j += kThreads) {
    int s2 = s;
    while (off[s2 + 1] <= j) ++s2;
    if (s2 != s || fresh) {
      s = s2;
      fresh = false;
      const int e = list[s];
      const int lane = e / n;
      first = indptr[e - lane * n] - off[s];
      a = acc + static_cast<int64_t>(lane) * n;
    }
    const int64_t k = first + j;
    atomicAdd(a + tgt[k], static_cast<int32_t>(w[k]));
  }
}

// A drive channel: `stride` apart between lanes (0: one row shared by the
// lanes); null when absent.
template <typename T>
struct Chan {
  const T* p;
  int64_t stride;
  __device__ __forceinline__ T at(int lane, int col) const {
    return p[lane * stride + col];
  }
};

// grid (ceil(n / kLifSpan), B): block x of lane y takes the kLifSpan
// lane-neurons from column x * kLifSpan on, thread t every kThreads-th.
template <bool FX>
__global__ void __launch_bounds__(kThreads)
    fanout_lif_kernel(int32_t* __restrict__ acc, const void* __restrict__ v_in,
                      const void* __restrict__ g_in,
                      const int32_t* __restrict__ refrac_in,
                      Chan<float> gstim, Chan<float> v_mv, Chan<bool> force,
                      void* __restrict__ v_out, void* __restrict__ g_out,
                      int32_t* __restrict__ refrac_out,
                      bool* __restrict__ spk_out, int n, lif::F32Params pf,
                      lif::FxParams px) {
  using S = std::conditional_t<FX, int32_t, float>;
  const int lane = blockIdx.y;
  const int col0 = blockIdx.x * kLifSpan + threadIdx.x;
  const int64_t row = static_cast<int64_t>(lane) * n;
  // every load of the thread's lane-neurons first, then the stores
  int32_t a[kLifPer], refrac[kLifPer];
  S v[kLifPer], g[kLifPer];
  float gs[kLifPer], vm[kLifPer];
  bool f[kLifPer];
#pragma unroll
  for (int u = 0; u < kLifPer; ++u) {
    const int col = col0 + u * kThreads;
    if (col < n) {
      const int64_t i = row + col;
      a[u] = acc[i];
      v[u] = static_cast<const S*>(v_in)[i];
      g[u] = static_cast<const S*>(g_in)[i];
      refrac[u] = refrac_in[i];
      gs[u] = gstim.p ? gstim.at(lane, col) : 0.0f;
      vm[u] = v_mv.p ? v_mv.at(lane, col) : 0.0f;
      f[u] = force.p ? force.at(lane, col) : false;
    }
  }
#pragma unroll
  for (int u = 0; u < kLifPer; ++u) {
    const int col = col0 + u * kThreads;
    if (col < n) {
      const int64_t i = row + col;
      if (a[u] != 0) acc[i] = 0;
      const float sum = __int2float_rn(a[u]);
      const float g_units =
          gstim.p ? lif::ftz(__fadd_rn(sum, lif::ftz(gs[u]))) : sum;
      bool spike;
      if constexpr (FX) {
        const int32_t vin =
            v_mv.p ? __float2int_rn(__fdiv_rn(vm[u], pf.w_scale)) : 0;
        spike = lif::step_fx(v[u], g[u], refrac[u], __float2int_rn(g_units),
                             v_mv.p != nullptr, vin, f[u], px);
      } else {
        spike = lif::step_f32(v[u], g[u], refrac[u], g_units,
                              v_mv.p != nullptr, vm[u], f[u], pf);
      }
      static_cast<S*>(v_out)[i] = v[u];
      static_cast<S*>(g_out)[i] = g[u];
      refrac_out[i] = refrac[u];
      spk_out[i] = spike;
    }
  }
}

}  // namespace

extern "C" int fanout_scatter_launch(const void* slot, int head,
                                     long long total, int n,
                                     const void* indptr, const void* tgt,
                                     const void* w, void* acc,
                                     void* syn_events, void* stream) {
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((head + total + kSpan - 1) / kSpan);
    fanout_scatter_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(slot), head, total, n,
        static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(tgt),
        static_cast<const int16_t*>(w), static_cast<int32_t*>(acc),
        static_cast<unsigned long long*>(syn_events));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fanout_lif_launch(
    int fixed_point, void* acc, const void* v, const void* g,
    const void* refrac, const void* gstim, long long gstim_stride,
    const void* v_mv, long long v_mv_stride, const void* force,
    long long force_stride, void* v_out, void* g_out, void* refrac_out,
    void* spk_out, int lanes, int n, float w_scale, float alpha_m, float v0,
    float decay_g, float v_th, float v_r, int fx_v0, int fx_alpha_m16,
    int fx_gdecay16, int fx_v_th, int fx_v_r, int ref_steps, void* stream) {
  const lif::F32Params pf{w_scale, alpha_m, v0, decay_g, v_th, v_r, ref_steps};
  const lif::FxParams px{fx_v0,   fx_alpha_m16, fx_gdecay16,
                         fx_v_th, fx_v_r,       ref_steps};
  const Chan<float> gs{static_cast<const float*>(gstim), gstim_stride};
  const Chan<float> vm{static_cast<const float*>(v_mv), v_mv_stride};
  const Chan<bool> fo{static_cast<const bool*>(force), force_stride};
  if (lanes > 0 && n > 0) {
    const dim3 grid((n + kLifSpan - 1) / kLifSpan, lanes);
    auto kernel = fixed_point ? fanout_lif_kernel<true>
                              : fanout_lif_kernel<false>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(acc), v, g, static_cast<const int32_t*>(refrac),
        gs, vm, fo, v_out, g_out, static_cast<int32_t*>(refrac_out),
        static_cast<bool*>(spk_out), n, pf, px);
  }
  return static_cast<int>(cudaGetLastError());
}
