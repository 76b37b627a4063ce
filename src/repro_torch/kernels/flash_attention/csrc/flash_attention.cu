// Flash attention forward (online softmax) at float32 accuracy on the
// tensor cores (3xTF32), GQA, with causal, sliding-window and kv-length
// masks.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _attn_body).  The TPU kernel's grid is (batch*heads, q blocks, kv
// blocks) with the kv axis sequential and the running max m, sum l and
// accumulator in VMEM scratch.  Here one block of 4 warps owns one
// (batch*head, 64-query block) pair, each warp 16 query rows, and loops
// over key tiles itself; m, l and the accumulator stay in registers for
// the whole loop.
//
// Semantics (as _attn_body): s = (q . k) * scale; key j of query i is kept
// iff j < Skv, and j <= i when causal, and j > i - window - 1 with a
// window; masked scores are -1e30 and their probabilities 0; tiles that
// the causal or window mask empties entirely are skipped; the output is
// acc / l with l == 0 -> 1.  Query head h reads kv head h / groups in
// place (no GQA-expanded copy).
//
// Bound on an H100: operations.  4 * D flops per kept (query, key) pair
// (q.k and p.v): 10.748 GFLOP for a 1,024-token causal prefill of 40 heads
// of 128, against ~50 MB of q, k, v and output (0.015 ms at 3.35 TB/s).
// Done as 3xTF32 (three TF32 products per float32 product) at 495 TFLOP/s
// dense TF32 that is 0.0651 ms; the same flops as float32 FMAs on the CUDA
// cores (67 TFLOP/s) would take 0.160 ms.
//
// Design against that bound:
//   * Tensor cores at float32 accuracy.  Every operand x is split into
//     hi = x rounded to TF32 (to nearest, ties away, as cvt.rna) and
//     lo = x - hi truncated to TF32, and each product is formed as
//     lo.hi + hi.lo + hi.hi with mma.sync.m16n8k8 TF32 and float32
//     accumulators, for Q.K^T and P.V.  What this drops (lo.lo and the
//     residual of x - hi - lo) is ~2^-20 of a product, against 2^-11 for
//     one TF32 product: plain TF32 would not hold the 2e-4 tolerance nor
//     the qwen tokens.  The split is done in registers from shared memory
//     as the fragments are loaded, in integer operations (see split()).
//   * Softmax in registers.  The online softmax runs on the score
//     accumulator fragments (row statistics reduced over the 4 lanes of a
//     quad with shuffles), and P feeds the P.V product straight from those
//     registers: the k index of the A fragment is permuted (k = t <-> key
//     2t, k = t + 4 <-> key 2t + 1) so that each thread's accumulator pair
//     is its own A operand, and V's B fragment is read with the same
//     permutation.  P never goes through shared memory.
//   * Asynchronous copies.  Q, K and V tiles arrive by cp.async (16 bytes
//     a copy when D % 4 == 0, ragged rows and padded columns zero-filled).
//     K and V have a buffer each: K(j+1) lands while the block computes the
//     softmax and P.V of tile j, V(j+1) while it computes Q.K(j+1)^T.
//   * Shared-memory rows are padded (Q and K by 8 floats, V by 4) so that
//     every fragment load of a warp hits 32 distinct banks.  At D = 128
//     (64-key tiles) a block uses 101 KB and two blocks share an SM; at
//     D = 256 the key tile is 32 (132 KB).  The grid is ordered longest
//     q block first, so the causal tail is short.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int BQ = 64;                 // queries per block
constexpr int NWARP = 4, NT = 32 * NWARP;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// DP: head dim rounded up to 32, 64, 128 or 256; columns D..DP-1 are zero.
template <int DP>
struct Cfg {
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per tile
  static constexpr int LDK = DP + 8;             // Q and K row stride
  static constexpr int LDV = DP + 4;             // V row stride
  static constexpr int SMEM_BYTES = 4 * (BQ * LDK + BK * LDK + BK * LDV);
};

// x = hi + lo in TF32 parts.  hi is x rounded to TF32 as cvt.rna.tf32.f32
// rounds finite values (to nearest, ties away from zero: half a TF32 ulp
// added to the magnitude bits, then truncated); lo is the exact rest
// x - hi truncated to TF32, which is what the tensor cores read of it.
// Four integer and float operations; cvt.rna itself also screens NaN and
// infinity, a compare and a select more per value.  A NaN x leaves lo NaN,
// so it still reaches the output.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a * b[n] for n < N to float32 accuracy, the two small products
// first.  The N accumulators are independent, so each pass issues N MMAs
// back to back and none waits on the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (*bh)[2],
                                           const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bh[n]);
}

// Copy rows r0..r0+R-1 of a [len, D] matrix into an [R][LD] tile with
// cp.async; rows at or past len and columns D..DP-1 are zero-filled.
template <int R, int LD, int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int len, int D, bool vec) {
  if (vec) {  // D % 4 == 0 and 16-byte aligned rows
    constexpr int C4 = DP / 4;
    for (int c = threadIdx.x; c < R * C4; c += NT) {
      const int rr = c / C4, col = (c % C4) * 4, i = r0 + rr;
      const bool ok = i < len && col < D;
      async_copy::copy16(dst + rr * LD + col,
                 ok ? src + static_cast<size_t>(i) * D + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < R * DP; c += NT) {
      const int rr = c / DP, col = c % DP, i = r0 + rr;
      const bool ok = i < len && col < D;
      async_copy::copy4(dst + rr * LD + col,
                ok ? src + static_cast<size_t>(i) * D + col : src,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ bool kept(int i, int j, int Skv, int causal,
                                     int window) {
  return j < Skv && (!causal || j <= i) && (window < 0 || j > i - window - 1);
}

template <int DP>
__global__ void __launch_bounds__(NT, 2)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int groups, int Sq, int Skv, int D, float scale, int causal,
                 int window, int vec) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK, LDK = C::LDK, LDV = C::LDV;
  constexpr int NS = BK / 8;   // score fragments (8 keys each) of a row
  constexpr int NO = DP / 8;   // output fragments (8 dims each) of a row
  constexpr int NG = NO < 8 ? NO : 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ][LDK]
  float* Ks = Qs + BQ * LDK;   // [BK][LDK]
  float* Vs = Ks + BK * LDK;   // [BK][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // quad (row) and lane in quad
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int hkv = (bh / H) * (H / groups) + (bh % H) / groups;
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + static_cast<size_t>(hkv) * Skv * D;
  const float* vb = v + static_cast<size_t>(hkv) * Skv * D;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2f below

  // the tiles that hold at least one kept key for some query of the block
  const int n_kv = (Skv + BK - 1) / BK;
  int t_end = n_kv;
  if (causal) t_end = min(n_kv, (q0 + BQ - 1) / BK + 1);
  int t_begin = 0;
  if (window >= 0) {
    const int lo = q0 - window - (BK - 1);  // first key of a live tile
    t_begin = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  // group 0: Q and the first K tile; group 1: the first V tile
  load_rows<BQ, LDK, DP>(Qs, qb, q0, Sq, D, vec);
  if (t_begin < t_end)
    load_rows<BK, LDK, DP>(Ks, kb, t_begin * BK, Skv, D, vec);
  async_copy::commit();
  if (t_begin < t_end)
    load_rows<BK, LDV, DP>(Vs, vb, t_begin * BK, Skv, D, vec);
  async_copy::commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int row = warp * 16 + gq;  // this thread's rows: row and row + 8
  const int i_q[2] = {q0 + row, q0 + row + 8};

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    async_copy::wait<1>();  // Q and K(t) have landed (V(t) may be coming)
    __syncthreads();

    // S = Q K^T: A = Q rows (k index permuted: t <-> 2t, t+4 <-> 2t+1),
    // B = K rows with the same permutation of d.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll 2
    for (int d0 = 0; d0 < DP; d0 += 8) {
      const float2 qa = *reinterpret_cast<const float2*>(
          Qs + row * LDK + d0 + 2 * tq);
      const float2 qc = *reinterpret_cast<const float2*>(
          Qs + (row + 8) * LDK + d0 + 2 * tq);
      uint32_t ah[4], al[4];
      split(qa.x, ah[0], al[0]);
      split(qc.x, ah[1], al[1]);
      split(qa.y, ah[2], al[2]);
      split(qc.y, ah[3], al[3]);
      uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 kk = *reinterpret_cast<const float2*>(
            Ks + (n * 8 + gq) * LDK + d0 + 2 * tq);
        split(kk.x, bh[n][0], bl[n][0]);
        split(kk.y, bh[n][1], bl[n][1]);
      }
      mma_3xtf32<NS>(s, ah, al, bh, bl);
    }
    __syncthreads();  // every warp is done with K(t)
    if (t + 1 < t_end)
      load_rows<BK, LDK, DP>(Ks, kb, k0 + BK, Skv, D, vec);
    async_copy::commit();

    // online softmax on the fragments: s[n][0..1] row `row`, keys
    // k0 + 8n + 2tq + {0, 1}; s[n][2..3] row `row + 8`, the same keys.
    // A tile that keeps every key for every query of the block skips the
    // masks (the interior of a causal prefill).
    const bool whole = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                       (window < 0 || k0 > q0 + BQ - 1 - window - 1);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * tq + (e & 1);
        const bool keep =
            whole || kept(i_q[e >> 1], j, Skv, causal, window);
        s[n][e] = keep ? __fmul_rn(s[n][e], sl2) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[n][e] == kNegInf ? 0.0f : exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    async_copy::wait<1>();  // V(t) has landed (K(t+1) may still be coming)
    __syncthreads();
    // O += P V: A = P straight from the score fragments (k = tq <-> key
    // 2tq, k = tq + 4 <-> key 2tq + 1), B = V rows 2tq and 2tq + 1.
#pragma unroll
    for (int n8 = 0; n8 < NS; ++n8) {
      uint32_t ah[4], al[4];
      split(s[n8][0], ah[0], al[0]);
      split(s[n8][2], ah[1], al[1]);
      split(s[n8][1], ah[2], al[2]);
      split(s[n8][3], ah[3], al[3]);
      const float* vr = Vs + (n8 * 8 + 2 * tq) * LDV + gq;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NG) {  // NG output fragments at once
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          split(vr[(n0 + n) * 8], bh[n][0], bl[n][0]);
          split(vr[LDV + (n0 + n) * 8], bh[n][1], bl[n][1]);
        }
        mma_3xtf32<NG>(acc + n0, ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with V(t)
    if (t + 1 < t_end)
      load_rows<BK, LDV, DP>(Vs, vb, k0 + BK, Skv, D, vec);
    async_copy::commit();
  }
  // with no live tile, Q's copy is still outstanding
  async_copy::wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i_q[h];
    if (i >= Sq) continue;
    const float denom = l[h] == 0.0f ? 1.0f : l[h];
    float* orow = o + (static_cast<size_t>(bh) * Sq + i) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * tq;
      if (d < D) orow[d] = acc[n][2 * h] / denom;
      if (d + 1 < D) orow[d + 1] = acc[n][2 * h + 1] / denom;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hkv, int Sq, int Skv, int D, float scale, int causal,
           int window, int vec, cudaStream_t stream) {
  constexpr int bytes = Cfg<DP>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_kernel<DP><<<grid, NT, bytes, stream>>>(
      q, k, v, o, H, H / Hkv, Sq, Skv, D, scale, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, H, Sq, D], k/v: [B, Hkv, Skv, D], o: [B, H, Sq, D], all float32
// and contiguous; D <= 256; window < 0 means none; vec != 0 promises
// D % 4 == 0 and 16-byte aligned q, k and v (16-byte copies).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int window,
                                      int vec, void* stream) {
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
                      window, vec, s);
  if (D <= 64)
    return launch<64>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                      window, vec, s);
  if (D <= 128)
    return launch<128>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                       window, vec, s);
  return launch<256>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, D, scale, causal,
                     window, vec, s);
}
