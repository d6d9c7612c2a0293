// 3-D 7-point star stencil sweep for Hopper (sm_90a), marching in z with
// planes in flight.
//
// Replaces the TPU kernel src/repro/kernels/stencil3d.py::stencil3d_pallas
// (body _kernel, wrapper ops.py::stencil3d, oracle ref.py::stencil3d_ref):
//
//   out[k,i,j] = c0*u[k+1,i+1,j+1] + cz*(u[k,..] + u[k+2,..])
//              + cx*(u[.,i,.] + u[.,i+2,.]) + cy*(u[..,j] + u[..,j+2])
//
// on a (D+2, H+2, W+2) padded input, fp32 accumulation, result cast to the
// input type (fp32 or bf16).
//
// Bound on an H100 SXM: 10 flops per point against at least 8 bytes moved
// per fp32 point — memory bound.  Counting each input byte read once and
// each output byte written once, at the main path's 512^3 fp32 interior that
// is (514^3 + 512^3) * 4 B = 1.08 GB, or 0.32 ms at 3.35 TB/s; in bf16 half
// that, 0.16 ms.
//
// Design against that bound.  The earlier kernel (one thread a point, every
// neighbour through L1/L2) kept one z-plane's worth of new data in flight per
// block and stalled near half the bound; by Little's law 3.35 TB/s at a few
// hundred ns of latency needs some 15-20 KB in flight per SM.  Here a block
// of kThreads = 256 threads owns a kTx x kTy = 64 x 16 tile of the xy plane
// and walks down a segment of kSeg = 64 z-planes; a thread computes kPy = 4
// points of one column of the tile.  Each thread keeps zm and core of its
// points in registers.  The planes' tiles, each with its 1-cell xy halo, go
// through a ring of kStages = 6 planes in shared memory filled by cp.async
// (16-byte chunks from each row's aligned-down start, cp_async.cuh), up to
// four planes ahead of the plane being swept: about 20 KB in flight per fp32
// block, four blocks an SM.  Of the in-plane neighbours, the ones in the
// thread's own column are its other points' cores (registers); the rest,
// and zp, come from the ring: 3.5 shared loads a point.  Ragged edges are
// masked at the store; rows and chunks beyond the input are not read.
// __fadd_rn and __fmul_rn keep the arithmetic free of FMA contraction, in
// the order of the elementwise PyTorch formula, so the result is
// bit-identical to it.
//
// Trade-offs of the tile: a plane of a block stages 18 rows of 72 fp32 (or
// 80 bf16) values for 64 x 16 outputs, 1.27x (1.41x) the tile, the excess
// mostly from L2 since the neighbouring tiles read the same rows at about
// the same time; the z segment reads 2 halo planes per 64, 3%.  At 512^3
// that is 256 tiles x 8 segments = 2048 blocks.  On the H100, one point a
// thread (a 64 x 8 tile of 512 threads) was clearly slower, and two points
// a thread, 8 ring planes, 32- or 128-plane segments and L2 prefetch hints
// were no faster.
//
// Left for later work: TMA loads of whole plane tiles, and wider loads from
// the ring (several x-points a thread).
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kTx = 64;        // tile columns (W), one thread each
constexpr int kPy = 4;         // tile rows a thread computes
constexpr int kTy = 16;        // tile rows (H), kTy / kPy threads each
constexpr int kThreads = kTx * kTy / kPy;
constexpr int kSeg = 64;       // z-planes a block sweeps
constexpr int kStages = 6;     // ring planes
constexpr int kBlocksPerSM = 4;

// 16-byte chunks a ring row holds: kTx + 2 values plus the alignment offset.
template <typename T>
__host__ __device__ constexpr int row_chunks() {
  return (kTx + 2 + 2 * (16 / static_cast<int>(sizeof(T)) - 1)) /
         (16 / static_cast<int>(sizeof(T)));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// blockIdx.x = (z segment * tiles_y + tile row) * tiles_x + tile column.
// Thread (tx, g) computes tile column tx of tile rows kPy g .. kPy g + kPy-1.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
stencil3d_kernel(const T* __restrict__ x, T* __restrict__ out, int D, int H,
                 int W, int tiles_x, int tiles_y, float c0, float cz, float cx,
                 float cy) {
  constexpr int kChunks = row_chunks<T>();
  constexpr int kRow = kChunks * 16 / static_cast<int>(sizeof(T));  // values a ring row
  constexpr int kMask = 16 / static_cast<int>(sizeof(T)) - 1;
  __shared__ __align__(16) unsigned char buf[kStages][(kTy + 2) * kChunks * 16];
  const int tx = threadIdx.x % kTx, r0 = threadIdx.x / kTx * kPy;
  const int bx = static_cast<int>(blockIdx.x % tiles_x);
  const int by = static_cast<int>(blockIdx.x / tiles_x % tiles_y);
  const int bz = static_cast<int>(blockIdx.x / tiles_x / tiles_y);
  const int j0 = bx * kTx, i0 = by * kTy, k0 = bz * kSeg;
  const int64_t wp = static_cast<int64_t>(W) + 2;
  const int64_t plane = (static_cast<int64_t>(H) + 2) * wp;
  const int64_t n = (static_cast<int64_t>(D) + 2) * plane;
  const int planes = min(kSeg, D - k0) + 2;      // padded planes k0 .. k0+planes-1
  const int rows = min(kTy + 2, H + 2 - i0);     // padded rows i0 .. i0+rows-1
  const int cols = min(kTx + 2, W + 2 - j0);     // padded cols j0 .. j0+cols-1
  const T* tile0 = x + static_cast<int64_t>(k0) * plane + i0 * wp + j0;

  // Padded plane k0+q into buf[q % kStages], tile row r at r * kChunks
  // chunks, from the row's aligned-down start.
  auto stage = [&](int q) {
    if (q < planes) {
      for (int c = threadIdx.x; c < (kTy + 2) * kChunks; c += kThreads) {
        const int r = c / kChunks;
        if (r < rows)
          ring::stage_chunk(buf[q % kStages] + r * kChunks * 16,
                            tile0 + q * plane + r * wp, cols, c % kChunks, x, n);
      }
    }
    ring::commit();
  };
  // Tile row r of plane q's ring slot, shifted by the row's alignment
  // offset ``off`` so that index 0 is tile column 0.
  auto row = [&](int q, int r, int off) {
    return reinterpret_cast<const T*>(buf[q % kStages]) + r * kRow + off;
  };
  // off[p]: the alignment offset of tile row r0 + p of the current centre
  // plane; it moves by the plane's stride (mod 16 bytes) from plane to plane.
  const int dq = static_cast<int>(plane & kMask);
  int off[kPy + 2];
#pragma unroll
  for (int p = 0; p < kPy + 2; ++p) off[p] = ring::align_offset(tile0 + (r0 + p) * wp);
  auto advance = [&]() {
#pragma unroll
    for (int p = 0; p < kPy + 2; ++p) off[p] = (off[p] + dq) & kMask;
  };

  for (int q = 0; q < kStages; ++q) stage(q);
  ring::wait<kStages - 2>();
  __syncthreads();
  float zm[kPy], core[kPy];
#pragma unroll
  for (int p = 0; p < kPy; ++p) zm[p] = to_float(row(0, r0 + p + 1, off[p + 1])[tx + 1]);
  advance();
#pragma unroll
  for (int p = 0; p < kPy; ++p) core[p] = to_float(row(1, r0 + p + 1, off[p + 1])[tx + 1]);
  const int j = j0 + tx;
  T* o = out + (static_cast<int64_t>(k0) * H + i0 + r0) * W + j;
  for (int t = 0; t + 2 < planes; ++t) {
    ring::wait<kStages - 3>();   // plane t+2 has landed
    __syncthreads();             // and plane t is read by every thread
    stage(t + kStages);          // into plane t's ring slot
    const float above = to_float(row(t + 1, r0, off[0])[tx + 1]);
    const float below = to_float(row(t + 1, r0 + kPy + 1, off[kPy + 1])[tx + 1]);
    float ym[kPy], yp[kPy], zp[kPy];
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      const T* mid = row(t + 1, r0 + p + 1, off[p + 1]);
      ym[p] = to_float(mid[tx]);
      yp[p] = to_float(mid[tx + 2]);
    }
    advance();
#pragma unroll
    for (int p = 0; p < kPy; ++p) zp[p] = to_float(row(t + 2, r0 + p + 1, off[p + 1])[tx + 1]);
    T* ot = o + static_cast<int64_t>(t) * H * W;
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      const float xm = p == 0 ? above : core[p - 1];
      const float xp = p == kPy - 1 ? below : core[p + 1];
      const float v = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(c0, core[p]), __fmul_rn(cz, __fadd_rn(zm[p], zp[p]))),
                    __fmul_rn(cx, __fadd_rn(xm, xp))),
          __fmul_rn(cy, __fadd_rn(ym[p], yp[p])));
      if (j < W && i0 + r0 + p < H) store(ot + static_cast<int64_t>(p) * W, v);
    }
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      zm[p] = core[p];
      core[p] = zp[p];
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int D, int H, int W, float c0, float cz,
           float cx, float cy, void* stream) {
  const int64_t tiles_x = (static_cast<int64_t>(W) + kTx - 1) / kTx;
  const int64_t tiles_y = (static_cast<int64_t>(H) + kTy - 1) / kTy;
  const int64_t blocks = tiles_x * tiles_y * ((static_cast<int64_t>(D) + kSeg - 1) / kSeg);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  stencil3d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), D, H, W,
      static_cast<int>(tiles_x), static_cast<int>(tiles_y), c0, cz, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil3d_f32(const void* x, void* out, int D, int H, int W,
                             float c0, float cz, float cx, float cy,
                             void* stream) {
  return launch<float>(x, out, D, H, W, c0, cz, cx, cy, stream);
}

extern "C" int stencil3d_bf16(const void* x, void* out, int D, int H, int W,
                              float c0, float cz, float cx, float cy,
                              void* stream) {
  return launch<__nv_bfloat16>(x, out, D, H, W, c0, cz, cx, cy, stream);
}
