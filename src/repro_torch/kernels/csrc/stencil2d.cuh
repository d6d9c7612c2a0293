// One 2-D 5-point star sweep as a row march: the kernel behind the entry
// points of stencil2d.cu, and the one-sweep (K = 1) launch of chain2d.cu.
// The design and its reasons are in the note at the head of stencil2d.cu.
//
// A warp owns a strip of S = 32 V output columns, V = 16 / sizeof(Tin) (the
// elements of one 16-byte chunk), and marches down a segment of kRows =
// kPoints / S output rows.  It stages all kRows + 2 input rows of the
// segment into shared memory at once by cp.async (cp_async.cuh), one commit
// group a row, and sweeps each row as soon as its group has landed.  Lane l
// owns the V columns l, l + 32, ..., l + 32 (V-1) of the strip and keeps
// their values of the last three rows in registers (the row loop is
// unrolled, so the three register sets change roles at compile time and no
// row is copied); the left and right neighbours it reads from the staged
// centre row.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace sweep2d {

constexpr int kWarps = 4;       // strips a block
constexpr int kPoints = 2048;   // output points a warp sweeps

// Columns a lane owns: as many as one 16-byte chunk of the input type holds.
template <typename T>
__host__ __device__ constexpr int lane_cols() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T>
__host__ __device__ constexpr int strip_cols() { return 32 * lane_cols<T>(); }

// Output rows a warp marches: 16 in fp32, 8 in bf16.
template <typename T>
__host__ __device__ constexpr int seg_rows() { return kPoints / strip_cols<T>(); }

// 16-byte chunks a staged row holds: the strip, its two halo columns and
// the row's alignment offset (at most V - 1 elements).
template <typename T>
__host__ __device__ constexpr int row_chunks() {
  return (strip_cols<T>() + 2 + 2 * (lane_cols<T>() - 1)) / lane_cols<T>();
}

// Shared memory of a block: each warp's staged rows.
template <typename T>
constexpr int block_bytes() { return kWarps * (seg_rows<T>() + 2) * row_chunks<T>() * 16; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The point update, in the order of the elementwise PyTorch formula and with
// nothing contracted into an FMA.
__device__ __forceinline__ float point(float c0, float cx, float cy, float core,
                                       float up, float dn, float lf, float rt) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(c0, core), __fmul_rn(cx, __fadd_rn(up, dn))),
      __fmul_rn(cy, __fadd_rn(lf, rt)));
}

// f(integral_constant<int, T>) for T in Ts, in order.
template <typename F, int... Ts>
__device__ __forceinline__ void for_each_row(F&& f, std::integer_sequence<int, Ts...>) {
  (f(std::integral_constant<int, Ts>{}), ...);
}

// x is (H+2, W+2) of Tin, out (H, W) of Tout.  blockIdx.x = segment * groups
// + strip group; warp w of the block takes strip group * kWarps + w.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kWarps)
kernel(const Tin* __restrict__ x, Tout* __restrict__ out, int H, int W,
       int strips, int groups, float c0, float cx, float cy) {
  constexpr int V = lane_cols<Tin>(), S = strip_cols<Tin>(), kChunks = row_chunks<Tin>();
  constexpr int kRows = seg_rows<Tin>(), kIn = kRows + 2;
  __shared__ __align__(16) unsigned char buf[kWarps][kIn][kChunks * 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = static_cast<int>(blockIdx.x % groups) * kWarps + warp;
  if (strip >= strips) return;
  const int i0 = static_cast<int>(blockIdx.x / groups) * kRows;
  const int c = strip * S;                        // first output column
  const int64_t Wp = static_cast<int64_t>(W) + 2;
  const int64_t n = (static_cast<int64_t>(H) + 2) * Wp;
  const int rows = min(kRows, H - i0) + 2;        // input rows of the segment
  const int span = Wp - c < S + 2 ? static_cast<int>(Wp - c) : S + 2;
  const Tin* row0 = x + static_cast<int64_t>(i0) * Wp + c;
  Tout* o = out + static_cast<int64_t>(i0) * W + c + lane;
  unsigned char(*staged)[kChunks * 16] = buf[warp];

  // Every input row of the segment at once, one group a row; a short last
  // segment commits empty groups, so that row t's group is always the t-th.
  for (int t = 0; t < kIn; ++t) {
    if (t < rows)
      for (int k = lane; k < kChunks; k += 32)
        ring::stage_chunk(staged[t], row0 + t * Wp, span, k, x, n);
    ring::commit();
  }

  // Staged input row q of the segment: element k is input column c + k.
  auto staged_row = [&](int q) {
    return reinterpret_cast<const Tin*>(staged[q]) + ring::align_offset(row0 + q * Wp);
  };
  // R[t % 3]: the lane's V values of input row t.
  float R[3][V];
  for_each_row([&](auto row) {
    constexpr int t = decltype(row)::value, d = t % 3, b = (t + 2) % 3, a = (t + 1) % 3;
    if (t >= rows) return;
    ring::wait<kIn - 1 - t>();
    __syncwarp();
    const Tin* e = staged_row(t) + 1 + lane;
#pragma unroll
    for (int v = 0; v < V; ++v) R[d][v] = to_float(e[32 * v]);
    if constexpr (t >= 2) {
      // Output row i0 + t - 2: up is row t-2 (set a), the centre row t-1
      // (set b), down row t (set d); left and right from staged row t-1.
      const Tin* m = staged_row(t - 1) + lane;
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        r[v] = point(c0, cx, cy, R[b][v], R[a][v], R[d][v], to_float(m[32 * v]),
                     to_float(m[2 + 32 * v]));
      Tout* ot = o + static_cast<int64_t>(t - 2) * W;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (c + lane + 32 * v < W) store(ot + 32 * v, r[v]);
    }
  }, std::make_integer_sequence<int, kIn>{});
}

// One sweep: x is (H+2, W+2) of Tin, out (H, W) of Tout.  Returns the CUDA
// error of the launch.
template <typename Tin, typename Tout>
int launch(const void* x, void* out, int H, int W, float c0, float cx, float cy,
           cudaStream_t stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t strips = (static_cast<int64_t>(W) + strip_cols<Tin>() - 1) / strip_cols<Tin>();
  const int64_t groups = (strips + kWarps - 1) / kWarps;
  const int64_t blocks = groups * ((static_cast<int64_t>(H) + seg_rows<Tin>() - 1) / seg_rows<Tin>());
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<Tin, Tout><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), H, W,
      static_cast<int>(strips), static_cast<int>(groups), c0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sweep2d
