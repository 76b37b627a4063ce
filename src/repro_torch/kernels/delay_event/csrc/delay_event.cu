// Per-synapse delays on the card: the two kernels of the delay_event engine.
//
// Replaces no TPU kernel: the JAX package has one uniform delay (a ring of
// spike vectors) and no engine that delivers each synapse at a delay of its
// own.  Added for networks with a delay a synapse (the Potjans & Diesmann
// cortical microcircuit): a synapse event from a spike of step t with delay d
// is added into the pending input of step t + d, a ring of D slots of
// [B, n] int32 sums in device memory ([D, B, n]; slot (t + d) % D).
//
//  * pending_lif, one thread a lane-neuron: reads this step's slot of the
//    ring and zeroes it, turns the stimulus's threefry word into a Poisson
//    count against its population's CDF thresholds, adds the drive as
//    repro_torch/exp/stimulus.py::apply_drive adds it, applies lif.cuh's step
//    (Q19.12 with its products in 64 bits, or float32), writes the state
//    and the spike, and appends each spiking lane-neuron to the step's
//    spike list (one atomic a warp).
//  * delay_deliver: a fixed grid of blocks (two an SM) walks the spike list
//    in order, a block a spike; its 1,024 threads walk the source's fan-out,
//    each synapse a packed 32-bit word (target | signed weight | delay,
//    widths from the wrapper), and add the weight into slot
//    (ptr + delay) % D of the spike's lane with an int32 atomic.  Integer
//    adds are exact in any order, so the sums are the plain version's bit
//    for bit; nothing is dropped.
//
// Bound on an H100: device memory.  A synapse event reads its 4-byte word
// and adds 4 bytes at a random place of a ring far larger than L2 (a 32-byte
// sector read and written); a lane-neuron reads and writes its state and its
// slot.  Design against that bound: a block reads its source's words once,
// in order, as whole lines; the adds are fire-and-forget reductions (RED);
// the list holds the spiking lane-neurons alone, so delivery costs what the
// step's spikes need; the spikes in flight at once (a block each) are
// neighbours in the list, mostly of one or two lanes; and the grid is fixed
// and reads the list's length on the device, so no step waits on the host.
// A warp a spike instead measured 5% slower on an H100 at the
// microcircuit's steady state (7.18 against 6.80 ms a step at 1,024
// lanes).  pending_lif issues every load before its first store, through
// restrict pointers: with the slot zeroed first, each thread waited out a
// second round trip to device memory, and the kernel took 4.85 ms at
// 1,024 lanes on an H100 instead of 1.24.
#include <cuda_runtime.h>

#include <cstdint>

#include "lif.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDeliverThreads = 1024;  // a block a spike, two an SM
constexpr unsigned kAll = 0xffffffffu;

// The step's drive; a null pointer is an absent channel.
struct Drive {
  const int64_t* bits;   // [B*n] threefry words (low 32 bits), or null
  const int32_t* pop;    // [n] population of each neuron
  const int64_t* table;  // [P, K] CDF thresholds, 2**32 past the last
  int K;
  float w_count;         // weight units an event of the count
  const float* g_units;  // [B*n] further drive onto g, weight units
  const float* v_mv;     // [B*n] membrane drive, mV
  const bool* force;     // [B*n] forced spikes
};

template <bool kFx>
__global__ void __launch_bounds__(kThreads)
    pending_lif_kernel(int32_t* __restrict__ slot,
                       const int32_t* __restrict__ v_in,
                       const int32_t* __restrict__ g_in,
                       const int32_t* __restrict__ refrac_in,
                       int32_t* __restrict__ v_out, int32_t* __restrict__ g_out,
                       int32_t* __restrict__ refrac_out,
                       bool* __restrict__ spikes, int32_t* __restrict__ list,
                       unsigned long long* __restrict__ scratch, Drive d,
                       int64_t n, int64_t total, lif::F32Params pf,
                       lif::FxParams px, float w_scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int lane = -1;
  unsigned count = 0;
  bool spike = false;
  if (i < total) {
    // every load first, the slot's zeroing last: the state (v and g as
    // their 32 bits, int32 or float32) never aliases the ring
    const int32_t pend = slot[i];
    const int32_t v_bits = v_in[i], g_bits = g_in[i];
    int32_t refrac = refrac_in[i];
    const int64_t u =
        d.bits != nullptr ? static_cast<uint32_t>(d.bits[i]) : 0u;
    const float g_units = d.g_units != nullptr ? d.g_units[i] : 0.0f;
    const float v_mv = d.v_mv != nullptr ? d.v_mv[i] : 0.0f;
    const bool force = d.force != nullptr && d.force[i];
    // total < 2**31 (the wrapper checks): 32-bit division
    const int ii = static_cast<int>(i), nn = static_cast<int>(n);
    lane = ii / nn;
    if (d.bits != nullptr) {
      const int64_t* row =
          d.table + static_cast<int64_t>(d.pop[ii - lane * nn]) * d.K;
      while (count < static_cast<unsigned>(d.K) && u >= row[count]) ++count;
    }
    // the drive onto g, summed in the order apply_drive sums it: the g
    // channel, then the count's units
    float dg = 0.0f;
    bool has_dg = false;
    if (d.g_units != nullptr) {
      dg = g_units;
      has_dg = true;
    }
    if (d.bits != nullptr) {
      const float c = __fmul_rn(static_cast<float>(count), d.w_count);
      dg = has_dg ? __fadd_rn(dg, c) : c;
      has_dg = true;
    }
    float gu = static_cast<float>(pend);
    if (has_dg) gu = lif::ftz(__fadd_rn(lif::ftz(gu), lif::ftz(dg)));
    const bool has_vin = d.v_mv != nullptr;
    if (kFx) {
      int32_t v = v_bits, g = g_bits;
      const int32_t vin =
          has_vin ? __float2int_rn(__fdiv_rn(v_mv, w_scale)) : 0;
      spike = lif::step_fx<true>(v, g, refrac, __float2int_rn(gu), has_vin,
                                 vin, force, px);
      v_out[i] = v;
      g_out[i] = g;
    } else {
      float v = __int_as_float(v_bits), g = __int_as_float(g_bits);
      spike = lif::step_f32(v, g, refrac, gu, has_vin, v_mv, force, pf);
      v_out[i] = __float_as_int(v);
      g_out[i] = __float_as_int(g);
    }
    refrac_out[i] = refrac;
    spikes[i] = spike;
    slot[i] = 0;
  }
  // the spikes into the list: one atomic a warp
  const int me = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(kAll, spike);
  if (ballot != 0u) {
    const int leader = __ffs(ballot) - 1;
    unsigned long long base = 0;
    if (me == leader)
      base = atomicAdd(&scratch[0],
                       static_cast<unsigned long long>(__popc(ballot)));
    base = __shfl_sync(kAll, base, leader);
    if (spike) list[base + __popc(ballot & ((1u << me) - 1u))] =
        static_cast<int32_t>(i);
  }
  // the count's events, summed in shared memory over the block's threads of
  // each lane (a block of 256 spans 256 / n + 2 lanes at most), then one
  // atomic a lane a block
  if (d.bits != nullptr) {
    __shared__ unsigned events[kThreads + 1];
    const int lane0 = static_cast<int>(
        static_cast<int64_t>(blockIdx.x) * kThreads / n);
    const int lanes = static_cast<int>(
        (static_cast<int64_t>(blockIdx.x + 1) * kThreads - 1) / n) - lane0 + 1;
    if (threadIdx.x < lanes) events[threadIdx.x] = 0u;
    __syncthreads();
    if (count != 0u) atomicAdd(&events[lane - lane0], count);
    __syncthreads();
    if (threadIdx.x < lanes && events[threadIdx.x] != 0u)
      atomicAdd(&scratch[1 + lane0 + threadIdx.x],
                static_cast<unsigned long long>(events[threadIdx.x]));
  }
}

// A block a spike, the blocks taking the listed spikes in list order.
__global__ void __launch_bounds__(kDeliverThreads)
    delay_deliver_kernel(const int32_t* __restrict__ list,
                         const unsigned long long* __restrict__ scratch,
                         unsigned long long* __restrict__ syn_events,
                         const int64_t* __restrict__ indptr,
                         const uint32_t* __restrict__ words,
                         int32_t* __restrict__ pending, int64_t n,
                         int64_t slot_stride, int depth, int ptr, int tbits,
                         int wbits) {
  const unsigned long long spikes = scratch[0];
  const uint32_t tmask = (1u << tbits) - 1u;
  const uint32_t wmask = (1u << wbits) - 1u;
  const int wshift = 32 - wbits;
  const int dshift = tbits + wbits;
  for (int64_t s = blockIdx.x; s < static_cast<int64_t>(spikes);
       s += gridDim.x) {
    const int e = list[s];
    const int lane = e / static_cast<int>(n);
    const int src = e - lane * static_cast<int>(n);
    const int64_t beg = indptr[src], end = indptr[src + 1];
    int32_t* base = pending + static_cast<int64_t>(lane) * n;
    for (int64_t k = beg + threadIdx.x; k < end; k += kDeliverThreads) {
      const uint32_t w = words[k];
      const int32_t weight =
          static_cast<int32_t>(((w >> tbits) & wmask) << wshift) >> wshift;
      int slot = ptr + static_cast<int>(w >> dshift);
      if (slot >= depth) slot -= depth;
      atomicAdd(base + slot * slot_stride + (w & tmask), weight);
    }
    if (threadIdx.x == 0)
      atomicAdd(&syn_events[lane], static_cast<unsigned long long>(end - beg));
  }
}

}  // namespace

extern "C" int pending_lif_launch(
    int fixed_point, void* slot, const void* v, const void* g,
    const void* refrac, void* v_out, void* g_out, void* refrac_out,
    void* spikes, void* list, void* scratch, const void* bits,
    const void* pop, const void* table, int K, float w_count,
    const void* g_units, const void* v_mv, const void* force, long long n,
    long long total, float w_scale, float alpha_m, float v0, float decay_g,
    float v_th, float v_r, int fx_v0, int fx_alpha_m16, int fx_gdecay16,
    int fx_v_th, int fx_v_r, int ref_steps, void* stream) {
  const Drive d{static_cast<const int64_t*>(bits),
                static_cast<const int32_t*>(pop),
                static_cast<const int64_t*>(table),
                K,
                w_count,
                static_cast<const float*>(g_units),
                static_cast<const float*>(v_mv),
                static_cast<const bool*>(force)};
  const lif::F32Params pf{w_scale, alpha_m, v0, decay_g, v_th, v_r,
                          ref_steps};
  const lif::FxParams px{fx_v0,   fx_alpha_m16, fx_gdecay16,
                         fx_v_th, fx_v_r,       ref_steps};
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    auto* sl = static_cast<int32_t*>(slot);
    auto* ri = static_cast<const int32_t*>(refrac);
    auto* ro = static_cast<int32_t*>(refrac_out);
    auto* sp = static_cast<bool*>(spikes);
    auto* li = static_cast<int32_t*>(list);
    auto* sc = static_cast<unsigned long long*>(scratch);
    auto* vi = static_cast<const int32_t*>(v);
    auto* gi = static_cast<const int32_t*>(g);
    auto* vo = static_cast<int32_t*>(v_out);
    auto* go = static_cast<int32_t*>(g_out);
    if (fixed_point) {
      pending_lif_kernel<true><<<blocks, kThreads, 0, s>>>(
          sl, vi, gi, ri, vo, go, ro, sp, li, sc, d, n, total, pf, px,
          w_scale);
    } else {
      pending_lif_kernel<false><<<blocks, kThreads, 0, s>>>(
          sl, vi, gi, ri, vo, go, ro, sp, li, sc, d, n, total, pf, px,
          w_scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delay_deliver_launch(const void* list, const void* scratch,
                                    void* syn_events, const void* indptr,
                                    const void* words, void* pending,
                                    long long n, long long slot_stride,
                                    int depth, int ptr, int tbits, int wbits,
                                    int sms, void* stream) {
  delay_deliver_kernel<<<sms * 2, kDeliverThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(list),
      static_cast<const unsigned long long*>(scratch),
      static_cast<unsigned long long*>(syn_events),
      static_cast<const int64_t*>(indptr),
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(pending), n,
      slot_stride, depth, ptr, tbits, wbits);
  return static_cast<int>(cudaGetLastError());
}
