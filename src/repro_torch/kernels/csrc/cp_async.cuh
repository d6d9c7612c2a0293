// Asynchronous global-to-shared staging shared by the kernels that keep a
// ring of rows or planes in shared memory (chain2d.cu, stencil3d.cu).
//
// A span of a row starts wherever the row does, so it is staged as the
// 16-byte-aligned chunks that cover it, and a reader adds align_offset() of
// the span's first element.  A chunk that lies wholly inside the tensor goes
// by cp.async; the one or two chunks that straddle the tensor's first or last
// byte are copied element by element, so nothing outside the tensor is read.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of T between p and the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int align_offset(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Stage the 16-byte chunk at ``src`` (16-byte aligned) into ``dst``: by
// cp.async where ``inside`` (the chunk lies wholly in the tensor [lo, hi)),
// else only its elements inside the tensor, one by one.
template <typename T>
__device__ __forceinline__ void stage16(unsigned char* dst, uintptr_t src, bool inside,
                                        uintptr_t lo, uintptr_t hi) {
  if (inside) {
    cp_async16(dst, reinterpret_cast<const void*>(src));
    return;
  }
  T* d = reinterpret_cast<T*>(dst);
  for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e) {
    const uintptr_t a = src + e * sizeof(T);
    if (a >= lo && a < hi) d[e] = *reinterpret_cast<const T*>(a);
  }
}

// Stage chunk k of the span [p, p + count) of the tensor [x, x + n) into
// dst + 16 k, where chunk 0 is the 16 bytes holding p.  Chunks that hold no
// element of the span are skipped.
template <typename T>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const T* p,
                                            int count, int k, const T* x,
                                            int64_t n) {
  const uintptr_t src = (reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15)) + 16u * k;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(x + n);
  if (src >= reinterpret_cast<uintptr_t>(p + count)) return;
  stage16<T>(dst + 16 * k, src, src >= lo && src + 16 <= hi, lo, hi);
}

}  // namespace ring
