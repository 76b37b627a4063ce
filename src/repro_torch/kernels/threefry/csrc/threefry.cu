// JAX's threefry-2x32 counter hash as one kernel a call: the key split, the
// raw bits and the Bernoulli draws of repro_torch/random.py.
//
// Replaces no TPU kernel: the JAX package draws through jax.random, which
// XLA fuses.  It replaces the port's stand-in for jax.random, the int64
// PyTorch chain in ../ref.py, which issues ~175 elementwise launches a call
// (20 rounds of add, rotate and xor on uint32 words held in int64 and masked
// after every step) and streams an int64 temporary through device memory in
// each of them.  The kernel gives the same bits in both of JAX's threefry
// modes.
//
// Bound on an H100: integer operations.  A block is ~85 instructions (four
// key words, 20 rounds of IADD, SHF and LOP3, five key injections, the
// epilogue) for 8 bytes of output at most, and 1 byte for a draw: the card's
// ~17 T int32 operations a second against 3.35 TB/s put the bound far on the
// side of the operations.  Design against that bound: the words stay in
// uint32 registers, a rotation is one funnel shift, the rounds are unrolled
// so that every rotation count is an immediate, a thread reads its lane's
// key once (and again only where its draws cross into the next lane), and
// nothing but the result is written: four Bernoulli draws a thread leave as
// one 32-bit store.
//
// Layout.  The keys are L rows of two int64 words (the leading axes of
// [..., 2] flattened), read through their row and word strides: the carry's
// key is a strided view of the last split.  A call hashes `size` counters
// for each row; the grid covers rows x counters with 64-bit offsets.
//  * partitionable mode (jax_threefry_partitionable): counter i is the block
//    (i >> 32, i & 0xFFFFFFFF); a split writes both words as a key, bits are
//    their xor.
//  * original mode: the counts 0 .. size-1 (padded with one zero to even)
//    are hashed in pairs (j, j + half); thread j writes outputs j and
//    j + half, and the padded zero's output is dropped.  A split of num keys
//    is 2 num such words, as [num, 2].
// A Bernoulli draw forms u exactly as the plain version does, the top 23
// bits as the mantissa of a float in [1, 2) minus 1.0f, compares it with
// float32 p.  A mask is applied by the caller, after the launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDrawsPerThread = 4;  // draws a thread: one 32-bit store

// What a call writes (the wrapper's `out_kind`).
constexpr int kKeys = 0;  // int64 [L, size, 2]: both words (partitionable)
constexpr int kBits = 1;  // int64 [L, size]: the xor, or the word (original)
constexpr int kDraw = 2;  // bool [L, size]: u < p

constexpr uint32_t kParity = 0x1BD11BDA;

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ Key load_key(const int64_t* keys, int64_t row,
                                        int64_t row_stride,
                                        int64_t word_stride) {
  const int64_t* k = keys + row * row_stride;
  const uint32_t k0 = static_cast<uint32_t>(k[0]);
  const uint32_t k1 = static_cast<uint32_t>(k[word_stride]);
  return {k0, k1, k0 ^ k1 ^ kParity};
}

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

// Four rounds of the rotation set (13, 15, 26, 6) or (17, 29, 16, 24).
template <int A, int B, int C, int D>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// The 20-round Threefry-2x32 block of counter (x0, x1) under key k.
__device__ __forceinline__ uint2 threefry(const Key& k, uint32_t x0,
                                          uint32_t x1) {
  x0 += k.k0;
  x1 += k.k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k1;
  x1 += k.k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k2;
  x1 += k.k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k0;
  x1 += k.k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k1;
  x1 += k.k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k2;
  x1 += k.k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.bernoulli's draw from 32 random bits.
__device__ __forceinline__ bool draw(uint32_t bits, float p) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f < p;
}

struct Args {
  const int64_t* keys;
  int64_t row_stride, word_stride;
  int64_t rows, size;
  void* out;
  float p;
};

// Partitionable mode, one counter a thread (keys and bits).
template <int kOut>
__global__ void __launch_bounds__(kThreads)
    partitionable_words(const Args a) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= a.rows * a.size) return;
  const int64_t row = f / a.size, i = f - row * a.size;
  const uint2 y = threefry(load_key(a.keys, row, a.row_stride, a.word_stride),
                           static_cast<uint32_t>(i >> 32),
                           static_cast<uint32_t>(i));
  int64_t* out = static_cast<int64_t*>(a.out);
  if (kOut == kKeys) {
    out[2 * f] = y.x;
    out[2 * f + 1] = y.y;
  } else {
    out[f] = y.x ^ y.y;
  }
}

// Partitionable mode, kDrawsPerThread consecutive draws of the flat [L, size]
// output a thread, crossing into the next row where a row ends.
__global__ void __launch_bounds__(kThreads) partitionable_draws(const Args a) {
  const int64_t total = a.rows * a.size;
  const int64_t f0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) *
      kDrawsPerThread;
  if (f0 >= total) return;
  int64_t row = f0 / a.size, i = f0 - row * a.size;
  Key k = load_key(a.keys, row, a.row_stride, a.word_stride);
  const int m = total - f0 < kDrawsPerThread ? static_cast<int>(total - f0)
                                             : kDrawsPerThread;
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < kDrawsPerThread; ++e) {
    if (e < m) {
      if (i == a.size) {
        i = 0;
        k = load_key(a.keys, ++row, a.row_stride, a.word_stride);
      }
      const uint2 y = threefry(k, static_cast<uint32_t>(i >> 32),
                               static_cast<uint32_t>(i));
      packed |= static_cast<uint32_t>(draw(y.x ^ y.y, a.p)) << (8 * e);
      ++i;
    }
  }
  uint8_t* out = static_cast<uint8_t*>(a.out) + f0;
  if (m == kDrawsPerThread) {
    *reinterpret_cast<uint32_t*>(out) = packed;  // f0 % 4 == 0: aligned
  } else {
    for (int e = 0; e < m; ++e) out[e] = (packed >> (8 * e)) & 1u;
  }
}

// Original mode: thread (row, j) hashes the pair (j, j + half) of the counts
// and writes outputs j and j + half of its row (bits, or draws).
template <int kOut>
__global__ void __launch_bounds__(kThreads) original(const Args a) {
  const int64_t half = (a.size + 1) / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.rows * half) return;
  const int64_t row = t / half, j = t - row * half;
  const bool second = j + half < a.size;  // else the pad zero's: dropped
  const uint2 y = threefry(load_key(a.keys, row, a.row_stride, a.word_stride),
                           static_cast<uint32_t>(j),
                           second ? static_cast<uint32_t>(j + half) : 0u);
  const int64_t base = row * a.size;
  if (kOut == kDraw) {
    uint8_t* out = static_cast<uint8_t*>(a.out) + base;
    out[j] = draw(y.x, a.p);
    if (second) out[j + half] = draw(y.y, a.p);
  } else {
    int64_t* out = static_cast<int64_t*>(a.out) + base;
    out[j] = y.x;
    if (second) out[j + half] = y.y;
  }
}

unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// One call: `size` counters (original mode: counts) for each of `rows` keys,
// written as `out_kind` (0 keys, 1 bits, 2 draws).  An original-mode split is
// out_kind 1 over 2 num counts.  Returns the launch's cudaError_t.
extern "C" int threefry_launch(const void* keys, long long row_stride,
                               long long word_stride, long long rows,
                               long long size, int partitionable,
                               int out_kind, void* out, float p,
                               void* stream) {
  const Args a{static_cast<const int64_t*>(keys), row_stride, word_stride,
               rows, size, out, p};
  const int64_t total = static_cast<int64_t>(rows) * size;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (out_kind < kKeys || out_kind > kDraw ||
      (!partitionable && out_kind == kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t threads =
      partitionable ? (out_kind == kDraw ? (total + kDrawsPerThread - 1) /
                                               kDrawsPerThread
                                         : total)
                    : static_cast<int64_t>(rows) * ((size + 1) / 2);
  if ((threads + kThreads - 1) / kThreads > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (partitionable) {
    if (out_kind == kDraw) {
      partitionable_draws<<<blocks(threads), kThreads, 0, s>>>(a);
    } else if (out_kind == kKeys) {
      partitionable_words<kKeys><<<blocks(threads), kThreads, 0, s>>>(a);
    } else {
      partitionable_words<kBits><<<blocks(threads), kThreads, 0, s>>>(a);
    }
  } else {
    if (out_kind == kDraw) {
      original<kDraw><<<blocks(threads), kThreads, 0, s>>>(a);
    } else {
      original<kBits><<<blocks(threads), kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
