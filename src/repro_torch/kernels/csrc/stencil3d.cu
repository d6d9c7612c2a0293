// 3-D 7-point star stencil sweep for Hopper (sm_90a), marching in z with
// planes in flight: one kernel for fp32 inputs and one for bf16.
//
// Replaces the TPU kernel src/repro/kernels/stencil3d.py::stencil3d_pallas
// (body _kernel, wrapper ops.py::stencil3d, oracle ref.py::stencil3d_ref):
//
//   out[k,i,j] = c0*u[k+1,i+1,j+1] + cz*(u[k,..] + u[k+2,..])
//              + cx*(u[.,i,.] + u[.,i+2,.]) + cy*(u[..,j] + u[..,j+2])
//
// on a (D+2, H+2, W+2) padded input, fp32 accumulation, result cast to the
// input type (fp32 or bf16).  __fadd_rn and __fmul_rn keep the arithmetic
// free of FMA contraction, in the order of the elementwise PyTorch formula,
// and a bf16 result is one round to nearest even of the fp32 sum, so both
// kernels are bit-identical to the plain version.
//
// Bound on an H100 SXM: 10 flops per point against at least 8 bytes moved
// per fp32 point (4 in bf16) — memory bound.  Counting each input byte read
// once and each output byte written once, at the main path's 512^3 interior
// that is (514^3 + 512^3) * 4 B = 1.08 GB, or 0.322 ms at 3.35 TB/s, in
// fp32; in bf16 half that, 0.54 GB and 0.161 ms.
//
// Both kernels.  A block owns a tile of the xy plane and walks down a
// segment of kSeg z-planes.  The planes' tiles, each with its 1-cell xy
// halo, go through a ring of kStages planes in shared memory filled by
// cp.async (16-byte chunks from each row's aligned-down start), up to
// kStages - 2 planes ahead of the plane being swept; one __syncthreads a
// plane hands a slot back.  Each thread keeps zm and the centre plane of
// its points in registers; the in-plane neighbours in its own column are
// its other points' centres, the rest, and zp, come from the ring.
// Ragged edges are masked at the store; rows and chunks beyond the input
// are not read.  blockIdx.x runs along x, then y, then z, so neighbouring
// tiles read each other's halo rows at about the same time, from L2.
//
// fp32.  256 threads own a kTx x kTy = 64 x 16 tile, a thread kPy = 4
// points of one column; kSeg = 64, kStages = 6, four blocks an SM.  A
// plane's tile is 18 rows x 18 chunks = 5.2 KB, about 20 KB in flight a
// block and 83 KB an SM.  Per point: 3.5 scalar shared loads, one 4-byte
// store, a barrier for every 4 points a thread.  The earlier kernel (one
// thread a point, every neighbour through L1/L2) stalled near half the
// bound; one point a thread (a 64 x 8 tile of 512 threads) was clearly
// slower, and two points a thread, 8 ring planes, 32- or 128-plane
// segments and L2 prefetch hints were no faster.
//
// bf16.  Run through the fp32 kernel's design at 2 bytes a value, a bf16
// input took 0.385-0.419 ms at 512^3 on the H100 (38-42% of its bound) at
// the fp32 kernel's rate of points: the per-point work (the loads, 3.5
// conversions, a 2-byte store a point) bounded it, not bytes.  So here a
// warp owns kPy = 4 rows of a 128-column tile and a lane 4 neighbouring
// columns of them: 16 points a thread a plane, one barrier for all 16.
// kTy = 16 rows (128 threads), kSeg = 32, kStages = 6, four blocks an SM
// (105 registers, no spills).  A ring row holds 18 chunks (130 values and
// up to 7 of alignment offset), so a plane's tile is 18 x 18 x 16 B = 5.2
// KB, as in fp32: up to 4 planes, 21 KB, in flight a block, 83 KB an SM.
//   Staging.  A thread stages the same 3 chunks of every plane: their
// addresses are worked out once and step by a plane's bytes, and a chunk
// that stays inside the tensor through the whole segment goes by cp.async
// (ring::stage16, which copies the others element by element).
//   Reads.  A row's 6 values around a lane's 4 are 4 aligned 32-bit shared
// loads and 3 funnel shifts, by 16 bits where the row starts at an odd
// bf16 (its offset moves from row to row and plane to plane with W + 2 and
// the plane's size, so a packed read at a fixed index would be
// misaligned); the kPy rows of zp and the two halo rows of the centre
// plane are read so, the rest is in registers.  Per point: 1.5 shared
// loads and 2 conversions (3.5 and 3.5 before), 10 fp32 operations as
// before.  Three register sets of windows (planes t, t + 1, t + 2) change
// roles as the plane loop, unrolled three times, goes round, so no value
// is copied; the ring slots are counted at run time.
//   Stores.  4 results a lane as one 8-byte store where the row allows it
// (a warp writes 256 B of a row), else two bf16x2 stores or, on an odd row
// start (odd W) and at the ragged end, one bf16 at a time.
//   Measured at 512^3 on the H100 (80 GB HBM3, 700 W; chip_smoke.py
// phase 3): 0.213 ms a launch with launches queued back to back, 76% of
// the bound, and 0.256-0.284 ms launched one at a time, against 0.196-0.198
// ms for a contiguous copy of the same bytes: the kernel runs at 92-93% of
// the copy's rate.  The earlier bf16 kernel (fp32's design) took
// 0.414-0.428 ms a launch in the same run.
//   Tried, at 512^3 on the H100 with launches queued back to back: tiles
// of 8, 16 and 32 rows (8, 4 and 2 blocks an SM), segments of 16, 32 and
// 64 planes and rings of 3 to 8 planes all timed within a few percent of
// one another; rings of 4 planes were slightly faster than 6 but hold half
// the bytes in flight, so the kernel keeps 6.  Five blocks an SM (96
// registers) spilled and was clearly slower, streaming stores (__stcs) no
// faster.  Staging through ring::stage_chunk, each chunk's address worked
// out anew every plane, was slower than stepping addresses worked out
// once.  A first version unrolled the plane loop by the ring depth and
// rotated the windows by register copies: rings deeper than 6 then slowed
// it by up to half, its loop outgrowing the instruction cache.  TMA loads
// of whole plane tiles are left out: a tensor map needs row strides that
// are multiples of 16 bytes, (W + 2) * 2 bytes only where W = 6 mod 8.
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
// 16-byte chunks a ring row holds: kTx + 2 values and up to 3 of offset.
constexpr int kChunks = (kTx + 2 + 3 + 3) / 4;

// blockIdx.x = (z segment * tiles_y + tile row) * tiles_x + tile column.
// Thread (tx, g) computes tile column tx of tile rows kPy g .. kPy g + kPy-1.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
stencil3d_kernel(const float* __restrict__ x, float* __restrict__ out, int D, int H,
                 int W, int tiles_x, int tiles_y, float c0, float cz, float cx,
                 float cy) {
  constexpr int kRow = kChunks * 4;  // values a ring row
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
  const float* tile0 = x + static_cast<int64_t>(k0) * plane + i0 * wp + j0;

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
    return reinterpret_cast<const float*>(buf[q % kStages]) + r * kRow + off;
  };
  // off[p]: the alignment offset of tile row r0 + p of the current centre
  // plane; it moves by the plane's stride (mod 16 bytes) from plane to plane.
  const int dq = static_cast<int>(plane & 3);
  int off[kPy + 2];
#pragma unroll
  for (int p = 0; p < kPy + 2; ++p) off[p] = ring::align_offset(tile0 + (r0 + p) * wp);
  auto advance = [&]() {
#pragma unroll
    for (int p = 0; p < kPy + 2; ++p) off[p] = (off[p] + dq) & 3;
  };

  for (int q = 0; q < kStages; ++q) stage(q);
  ring::wait<kStages - 2>();
  __syncthreads();
  float zm[kPy], core[kPy];
#pragma unroll
  for (int p = 0; p < kPy; ++p) zm[p] = row(0, r0 + p + 1, off[p + 1])[tx + 1];
  advance();
#pragma unroll
  for (int p = 0; p < kPy; ++p) core[p] = row(1, r0 + p + 1, off[p + 1])[tx + 1];
  const int j = j0 + tx;
  float* o = out + (static_cast<int64_t>(k0) * H + i0 + r0) * W + j;
  for (int t = 0; t + 2 < planes; ++t) {
    ring::wait<kStages - 3>();   // plane t+2 has landed
    __syncthreads();             // and plane t is read by every thread
    stage(t + kStages);          // into plane t's ring slot
    const float above = row(t + 1, r0, off[0])[tx + 1];
    const float below = row(t + 1, r0 + kPy + 1, off[kPy + 1])[tx + 1];
    float ym[kPy], yp[kPy], zp[kPy];
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      const float* mid = row(t + 1, r0 + p + 1, off[p + 1]);
      ym[p] = mid[tx];
      yp[p] = mid[tx + 2];
    }
    advance();
#pragma unroll
    for (int p = 0; p < kPy; ++p) zp[p] = row(t + 2, r0 + p + 1, off[p + 1])[tx + 1];
    float* ot = o + static_cast<int64_t>(t) * H * W;
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      const float xm = p == 0 ? above : core[p - 1];
      const float xp = p == kPy - 1 ? below : core[p + 1];
      const float v = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(c0, core[p]), __fmul_rn(cz, __fadd_rn(zm[p], zp[p]))),
                    __fmul_rn(cx, __fadd_rn(xm, xp))),
          __fmul_rn(cy, __fadd_rn(ym[p], yp[p])));
      if (j < W && i0 + r0 + p < H) ot[static_cast<int64_t>(p) * W] = v;
    }
#pragma unroll
    for (int p = 0; p < kPy; ++p) {
      zm[p] = core[p];
      core[p] = zp[p];
    }
  }
}

int launch(const void* x, void* out, int D, int H, int W, float c0, float cz,
           float cx, float cy, void* stream) {
  const int64_t tiles_x = (static_cast<int64_t>(W) + kTx - 1) / kTx;
  const int64_t tiles_y = (static_cast<int64_t>(H) + kTy - 1) / kTy;
  const int64_t blocks = tiles_x * tiles_y * ((static_cast<int64_t>(D) + kSeg - 1) / kSeg);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  stencil3d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), D, H, W,
      static_cast<int>(tiles_x), static_cast<int>(tiles_y), c0, cz, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: four columns a thread, packed reads and stores -----------------------

namespace bf16 {

using T = __nv_bfloat16;

constexpr int kTx = 128;       // tile columns: 4 a lane, so a warp spans the tile
constexpr int kPy = 4;         // tile rows a warp computes
constexpr int kTy = 16;        // tile rows, kPy a warp
constexpr int kSeg = 32;       // z-planes a block sweeps
constexpr int kStages = 6;     // ring planes
constexpr int kBlocksPerSM = 4;
constexpr int kThreads = 32 * kTy / kPy;
// 16-byte chunks a ring row holds: kTx + 2 values and up to 7 of offset.
constexpr int kChunks = (kTx + 2 + 7 + 7) / 8;
constexpr int kRowBytes = kChunks * 16;
constexpr int kSlotBytes = (kTy + 2) * kRowBytes;
constexpr int kSlotChunks = (kTy + 2) * kChunks;
constexpr int kPer = (kSlotChunks + kThreads - 1) / kThreads;  // chunks a thread a plane

// The two bf16 halves of a 32-bit word as floats (exact).
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Values m = 0..5 of a ring row, m being tile column 4 lane + m: four
// aligned words from the word holding it, each neighbouring pair shifted by
// 16 bits where the row's alignment offset is odd.  ``s`` is the row's
// first byte address mod 16 (only its bits 1-3 matter).
__device__ __forceinline__ void window(const unsigned char* row, uint32_t s, float v[6]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (s & 12));
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const uint32_t sh = s << 3;   // 16 where s & 2, else 0 (the shift reads 5 bits)
  const uint32_t p0 = __funnelshift_r(w0, w1, sh), p1 = __funnelshift_r(w1, w2, sh),
                 p2 = __funnelshift_r(w2, w3, sh);
  v[0] = lo(p0); v[1] = hi(p0); v[2] = lo(p1); v[3] = hi(p1); v[4] = lo(p2); v[5] = hi(p2);
}

// Four results to o[0..3], of which ``valid`` lie inside the row: one
// 8-byte store where o is 8-byte aligned, two bf16x2 stores where it is
// 4-byte aligned, else (odd W, ragged end) one bf16 at a time.
__device__ __forceinline__ void store4(T* o, const float r[4], int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(o);
  if (valid >= 4 && (a & 3) == 0) {
    const __nv_bfloat162 l = __floats2bfloat162_rn(r[0], r[1]);
    const __nv_bfloat162 h = __floats2bfloat162_rn(r[2], r[3]);
    if ((a & 7) == 0) {
      *reinterpret_cast<uint2*>(o) = make_uint2(bits(l), bits(h));
    } else {
      reinterpret_cast<__nv_bfloat162*>(o)[0] = l;
      reinterpret_cast<__nv_bfloat162*>(o)[1] = h;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < valid) o[e] = __float2bfloat16(r[e]);
}

// blockIdx.x = (z segment * tiles_y + tile row) * tiles_x + tile column.
// Warp g computes tile rows kPy g .. kPy g + kPy-1, lane l tile columns
// 4 l .. 4 l + 3 of them.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
kernel(const T* __restrict__ x, T* __restrict__ out, int D, int H, int W,
       int tiles_x, int tiles_y, float c0, float cz, float cx, float cy) {
  constexpr int S = kStages;
  __shared__ __align__(16) unsigned char buf[kStages * kSlotBytes];
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * kPy;
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
  const uintptr_t plane_bytes = static_cast<uintptr_t>(plane) * sizeof(T);

  const uintptr_t lo_x = reinterpret_cast<uintptr_t>(x);
  const uintptr_t hi_x = reinterpret_cast<uintptr_t>(x + n);
  // The chunks this thread stages, the same in every plane: chunk k of
  // tile row r at r * kRowBytes + 16 k of a slot.  src[i] is the address
  // 16 k bytes past the row's first element in the next plane to stage:
  // its 16-byte aligned-down address is the chunk, and the chunk holds an
  // element of the row's span iff src[i] mod 16 > lim[i].  A chunk that
  // stays inside the tensor in every plane of the segment goes by
  // cp.async; the others (at the tensor's two ends) element by element.
  uintptr_t src[kPer];
  int lim[kPer], dst[kPer];
  bool on[kPer], fast[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, k = c % kChunks;
    on[i] = c < kSlotChunks && r < rows;
    src[i] = reinterpret_cast<uintptr_t>(tile0 + r * wp) + 16u * k;
    lim[i] = 16 * k - 2 * cols;
    dst[i] = r * kRowBytes + 16 * k;
    const uintptr_t first = src[i] & ~uintptr_t(15);
    const uintptr_t last = (src[i] + (planes - 1) * plane_bytes) & ~uintptr_t(15);
    fast[i] = first >= lo_x && last + 16 <= hi_x;
  }
  // Plane k0+q into the ring slot at byte ``at`` (q counts up by one a
  // call).
  auto stage = [&](int q, int at) {
    if (q < planes) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (on[i] && static_cast<int>(src[i] & 15) > lim[i])
          ring::stage16<T>(buf + at + dst[i], src[i] & ~uintptr_t(15), fast[i], lo_x, hi_x);
        src[i] += plane_bytes;
      }
    }
    ring::commit();
  };

  // The first byte of tile row r of plane q lies at s(q, r) mod 16, with
  // s(q, r) = s0 + q * plane bytes + r * row bytes (mod 2^32).
  const uint32_t s0 = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(tile0));
  const uint32_t ds = static_cast<uint32_t>(plane_bytes);
  const uint32_t dr = static_cast<uint32_t>(wp * sizeof(T));
  const unsigned char* mine = buf + r0 * kRowBytes + 8 * lane;
  // Row r0 + r of the plane in the ring slot at byte ``at``, whose row
  // r0 + r starts at s = sq + (r0 + r) * dr.
  auto read = [&](int at, int r, uint32_t sq, float v[6]) {
    window(mine + at + r * kRowBytes, sq + (r0 + r) * dr, v);
  };

#pragma unroll
  for (int q = 0; q < S; ++q) stage(q, q * kSlotBytes);
  ring::wait<S - 2>();
  __syncthreads();
  // w[q % 3][p]: the 6 values around the thread's columns of its row p in
  // plane q, for planes t (zm), t + 1 (the centre) and t + 2 (zp).  The
  // plane loop is unrolled three times, so the sets change roles at
  // compile time and no value is copied.
  float w[3][kPy][6];
#pragma unroll
  for (int p = 0; p < kPy; ++p) {
    read(0, p + 1, s0, w[0][p]);
    read(kSlotBytes, p + 1, s0 + ds, w[1][p]);
  }
  const int j = j0 + 4 * lane;
  const int valid = min(4, W - j);
  T* o = out + (static_cast<int64_t>(k0) * H + i0 + r0) * W + j;
  uint32_t sq = s0 + ds;   // s of the centre plane, t + 1
  int slot = 0;            // plane t's ring slot, t % S, in bytes
  for (int t0 = 0; t0 + 2 < planes; t0 += 3) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + u;
      if (t + 2 >= planes) break;
      const int c_slot = slot + kSlotBytes == S * kSlotBytes ? 0 : slot + kSlotBytes;
      const int n_slot = c_slot + kSlotBytes == S * kSlotBytes ? 0 : c_slot + kSlotBytes;
      ring::wait<S - 3>();   // plane t+2 has landed
      __syncthreads();       // and plane t is read by every thread
      stage(t + S, slot);    // into plane t's ring slot
      float(&zm)[kPy][6] = w[u];
      float(&cur)[kPy][6] = w[(u + 1) % 3];
      float(&nxt)[kPy][6] = w[(u + 2) % 3];
      float above[6], below[6];
      read(c_slot, 0, sq, above);
      read(c_slot, kPy + 1, sq, below);
#pragma unroll
      for (int p = 0; p < kPy; ++p) read(n_slot, p + 1, sq + ds, nxt[p]);
      T* ot = o + static_cast<int64_t>(t) * H * W;
#pragma unroll
      for (int p = 0; p < kPy; ++p) {
        float r[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float xm = p == 0 ? above[m + 1] : cur[p - 1][m + 1];
          const float xp = p == kPy - 1 ? below[m + 1] : cur[p + 1][m + 1];
          r[m] = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(c0, cur[p][m + 1]),
                                  __fmul_rn(cz, __fadd_rn(zm[p][m + 1], nxt[p][m + 1]))),
                        __fmul_rn(cx, __fadd_rn(xm, xp))),
              __fmul_rn(cy, __fadd_rn(cur[p][m], cur[p][m + 2])));
        }
        if (i0 + r0 + p < H) store4(ot + static_cast<int64_t>(p) * W, r, valid);
      }
      sq += ds;
      slot = c_slot;
    }
  }
}

int launch(const void* x, void* out, int D, int H, int W, float c0, float cz,
           float cx, float cy, void* stream) {
  const int64_t tiles_x = (static_cast<int64_t>(W) + kTx - 1) / kTx;
  const int64_t tiles_y = (static_cast<int64_t>(H) + kTy - 1) / kTy;
  const int64_t blocks = tiles_x * tiles_y * ((static_cast<int64_t>(D) + kSeg - 1) / kSeg);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), D, H, W,
      static_cast<int>(tiles_x), static_cast<int>(tiles_y), c0, cz, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

}  // namespace

extern "C" int stencil3d_f32(const void* x, void* out, int D, int H, int W,
                             float c0, float cz, float cx, float cy,
                             void* stream) {
  return launch(x, out, D, H, W, c0, cz, cx, cy, stream);
}

extern "C" int stencil3d_bf16(const void* x, void* out, int D, int H, int W,
                              float c0, float cz, float cx, float cy,
                              void* stream) {
  return bf16::launch(x, out, D, H, W, c0, cz, cx, cy, stream);
}

// The tiling of one launch for an input of ``elem_bytes`` (4: fp32, 2:
// bf16): the output rows and columns of a block's tile, threads per block,
// and shared memory per block in bytes.
extern "C" int stencil3d_tile(int elem_bytes, int* rows, int* cols, int* threads,
                              int* smem_bytes) {
  if (elem_bytes == 4) {
    *rows = kTy;
    *cols = kTx;
    *threads = kThreads;
    *smem_bytes = kStages * (kTy + 2) * kChunks * 16;
    return 0;
  }
  if (elem_bytes == 2) {
    *rows = bf16::kTy;
    *cols = bf16::kTx;
    *threads = bf16::kThreads;
    *smem_bytes = bf16::kStages * bf16::kSlotBytes;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The z-planes a block sweeps for an input of ``elem_bytes``, or -1.
extern "C" int stencil3d_segment(int elem_bytes) {
  return elem_bytes == 4 ? kSeg : elem_bytes == 2 ? bf16::kSeg : -1;
}
