// Asynchronous global -> shared copies (cp.async, sm_80 and later).
//
// A thread issues copies, closes them into a group with commit(), and
// waits with wait<N>() until at most N of its groups are still in flight;
// a copy is visible to the other threads of the block only after a
// __syncthreads() that follows the wait.  The 16-byte form bypasses L1
// (.cg); the 4-byte form, which .cg does not allow, goes through it (.ca).
// src_bytes < the copy's size zero-fills the rest of the destination, so
// src_bytes = 0 writes zeros and reads nothing (src must still be a valid
// address).
//
// The two delivery kernels (kernels/spike_prop, through deliver.cuh) and the
// flash-attention kernel (kernels/flash_attention) include it from this
// shared directory, whose files kernels/build.py hashes into every
// library's name.
#pragma once

namespace async_copy {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Commit what is open and wait for every copy of this thread.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace async_copy
