// Flash attention forward (online softmax) in float32, GQA, with causal,
// sliding-window and kv-length masks.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _attn_body).  The TPU kernel's grid is (batch*heads, q blocks, kv
// blocks) with the kv axis sequential and the running max m, sum l and
// accumulator in VMEM scratch.  Here one block of 256 threads owns one
// (batch*head, 64-query block) pair and loops over 64-key tiles itself;
// m, l and the accumulator stay in registers for the whole loop.
//
// Semantics (as _attn_body): s = (q . k) * scale; key j of query i is kept
// iff j < Skv, and j <= i when causal, and j > i - window - 1 with a
// window; masked scores are -1e30 and their probabilities 0; tiles that
// the causal or window mask empties entirely are skipped; the output is
// acc / l with l == 0 -> 1.  Query head h reads kv head h / groups in
// place (no GQA-expanded copy).  Every product is a float32 FMA (fmaf); no
// tensor cores, so no TF32 rounding.
//
// Bound on an H100: operations.  4 * D flops per kept (query, key) pair
// (q.k and p.v), ~10.7 GFLOP for a 1,024-token causal prefill of 40 heads
// of 128, against ~50 MB of q, k, v and output: at 67 TFLOP/s float32
// (no tensor cores) the flops take ~0.16 ms, the bytes ~0.015 ms.
// Design against that bound, kept simple: each thread computes a 4 x 4
// block of the 64 x 64 score tile and a 4 x (D/16) block of the output, so
// every value loaded from shared memory feeds four FMAs; row statistics
// are reduced over the 16 threads of a row with warp shuffles.  Shared
// memory rows are padded by one float so that the 16 threads of a row
// group read 16 different banks.  wgmma, TMA and lower precisions are
// later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64, BK = 64;   // queries and keys per tile
constexpr int TX = 16, TY = 16;   // thread grid of a block
constexpr int NT = TX * TY;
constexpr int RM = BQ / TY;       // query rows per thread
constexpr int CN = BK / TX;       // score columns per thread
constexpr int LDP = BK + 1;       // row stride of the probability tile
constexpr float kNegInf = -1e30f;

template <int DP>
constexpr int smem_floats() {
  return 3 * BQ * (DP + 1) + BQ * LDP;
}

// DP: head dim rounded up to 32, 64, 128 or 256; columns D..DP-1 are zero.
template <int DP>
__global__ void __launch_bounds__(NT)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int groups, int Sq, int Skv, int D, float scale, int causal,
                 int window) {
  constexpr int LD = DP + 1;
  constexpr int DC = DP / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ks = Qs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ps = Vs + BK * LD;    // [BQ][LDP]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hkv = (bh / H) * (H / groups) + (bh % H) / groups;
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + static_cast<size_t>(hkv) * Skv * D;
  const float* vb = v + static_cast<size_t>(hkv) * Skv * D;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP, i = q0 + r;
    Qs[r * LD + d] =
        (i < Sq && d < D) ? qb[static_cast<size_t>(i) * D + d] : 0.0f;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.0f;
  }

  // the tiles that hold at least one kept key for some query of the block
  const int n_kv = (Skv + BK - 1) / BK;
  int t_end = n_kv;
  if (causal) t_end = min(n_kv, (q0 + BQ - 1) / BK + 1);
  int t_begin = 0;
  if (window >= 0) {
    const int lo = q0 - window - (BK - 1);  // first key of a live tile
    t_begin = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int r = idx / DP, d = idx % DP, j = k0 + r;
      const bool in = j < Skv && d < D;
      const size_t off = static_cast<size_t>(j) * D + d;
      Ks[r * LD + d] = in ? kb[off] : 0.0f;
      Vs[r * LD + d] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int a = 0; a < RM; ++a) qv[a] = Qs[(ty + TY * a) * LD + d];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = Ks[(tx + TX * c) * LD + d];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = q0 + ty + TY * a;
      bool keep[CN];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = k0 + tx + TX * c;
        bool ok = j < Skv;
        if (causal) ok = ok && j <= i;
        if (window >= 0) ok = ok && j > i - window - 1;
        keep[c] = ok;
        s[a][c] = ok ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = keep[c] ? expf(s[a][c] - m_new) : 0.0f;
        Ps[(ty + TY * a) * LDP + tx + TX * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[a] - m_new);
      l[a] = fmaf(l[a], corr, sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a) pv[a] = Ps[(ty + TY * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * LD + tx + TX * c];
#pragma unroll
        for (int a = 0; a < RM; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + TY * a;
    if (i >= Sq) continue;
    const float denom = l[a] == 0.0f ? 1.0f : l[a];
    float* orow = o + (static_cast<size_t>(bh) * Sq + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + TX * c;
      if (d < D) orow[d] = acc[a][c] / denom;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hkv, int Sq, int Skv, int D, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<DP><<<grid, NT, bytes, stream>>>(q, k, v, o, H, H / Hkv, Sq,
                                                Skv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, H, Sq, D], k/v: [B, Hkv, Skv, D], o: [B, H, Sq, D], all float32
// and contiguous; D <= 256; window < 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int window,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch<32>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                      window, s);
  if (D <= 64)
    return launch<64>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                      window, s);
  if (D <= 128)
    return launch<128>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                       window, s);
  return launch<256>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                     window, s);
}
