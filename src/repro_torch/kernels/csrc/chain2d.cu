// K fused 2-D 5-point star sweeps for Hopper (sm_90a), the window in shared
// memory.
//
// Replaces the TPU kernel src/repro/kernels/chain2d.py::chain2d_pallas
// (body _kernel, wrapper ops.py::chain2d, oracle ref.py::chain2d_ref):
//
//   u_0 = x,   u_s[i,j] = c0*u[i+1,j+1] + cx*(u[i,j+1] + u[i+2,j+1])
//                                        + cy*(u[i+1,j] + u[i+1,j+2])
//
// on a (H+2K, W+2K) input for s = 1..K, each sweep one cell smaller on every
// side, returning u_K of shape (H, W).  Everything is fp32 from the first
// load to the last sweep; the result is cast once, at the store, to the
// output type (fp32 or bf16).
//
// Bound on an H100 SXM: each input byte read once and each output byte
// written once, over 3.35 TB/s; 7 flops per point per sweep, summed over the
// shrinking regions, over 67 TFLOP/s of fp32.  At a 16384^2 fp32 interior
// with K = 8: (16400^2 + 16384^2) * 4 B = 2.15 GB, 0.64 ms; 15.0 GFLOP,
// 0.22 ms.  The bytes barely grow with K and the flops grow as K, so the
// function is bound by bytes up to K ~ 22 and by operations above.  Unfused,
// K launches of stencil2d move 2*K times the interior.
//
// Design.  The Pallas kernel keeps a full-width row slab (bm+2K, W+2K) in
// VMEM; at W = 16384 that slab is far beyond the 227 KB of shared memory a
// block may hold, and Hopper's blocks run in no order, so the window is
// tiled in 2-D.  A block owns a TM x TN output tile and stages its
// (TM+2K) x (TN+2K) input window, converted to fp32, into shared memory
// (out-of-range cells of ragged right and bottom tiles are zero-filled, never
// read from x; they feed only outputs that are masked at the store).  It
// then runs the sweeps between two fp32 buffers (ping-pong,
// __syncthreads() between sweeps), each over the region that is still
// valid, one cell smaller per side per sweep, and the last sweep writes its
// TM x TN straight to device memory.  Each sweep's region is cut into items
// of 8 rows by 32 columns, dealt out to the 16 warps in turn: the 32 lanes
// take neighbouring columns (conflict-free banks, coalesced global loads
// and stores) and each lane walks down its column keeping the up and centre
// values in registers, so a point costs three shared loads and one store
// (and two more loads per item).  Every sum uses __fadd_rn/__fmul_rn in the
// order of stencil2d.cu, so no FMA is contracted and the fp32 result is
// bit-identical to the plain version and to K launches of stencil2d.
//
// Trade-offs of the tile (TM = 64, 512 threads; TN = 128 keeps the stores
// 128-byte rows):
//
//   K        TN   shared/block           window reads  computed     blocks/SM
//   1        128   34,320 B (one buffer)  1.05x         1.00x        4
//   2..3     128   71,808-75,040 B        1.10-1.15x    1.02-1.05x   3
//   4..14    128   78,336-114,816 B       1.20-1.75x    1.07-1.33x   2
//   15..16    96   94,752-98,304 B        1.93-2.00x    1.41-1.44x   2
//
// "window reads" is (TM+2K)(TN+2K)/(TM*TN), the skirt that neighbouring
// blocks read again (mostly from L2); "computed" is the points swept,
// summed over the shrinking regions, per point of useful work.  A larger
// tile lowers both but holds fewer blocks on an SM, and a block that is
// staging its window cannot sweep, so the tile keeps at least two blocks on
// an SM: where two 64 x 128 windows no longer fit, TN drops to 96.  Other
// tile shapes (32 to 128 rows, 96 or 128 columns, 8 to 32 warps) tried on
// the H100 were not clearly faster below K = 16.  Above 48 KB the window
// is dynamic shared memory, enabled per kernel with
// cudaFuncSetAttribute.  From K = 4 up the time goes to the sweeps, which
// the shared-memory pipe limits (about 4.25 accesses of 4 bytes per point
// at 128 bytes a clock per SM), not device memory: fewer accesses per point
// need register blocking along rows.
//
// K beyond kMaxSteps (16): shared memory would hold a window up to K = 45
// at TN = 96, but with one block per SM and, at K = 24 already, 1.7x the
// useful points swept and the window read 2.6x.  So the wrapper
// (ops.py::chain2d) runs ceil(K/16) balanced passes of at most 16 sweeps
// through fp32 intermediates (entry points chain2d_bf16_f32, chain2d_f32
// and chain2d_f32_bf16).  That keeps the result fp32 throughout and
// bit-identical to one pass, at the price of one fp32 write and read of the
// interior per extra pass.
//
// Left for later work: cp.async/TMA staging overlapped with the sweeps,
// a persistent grid, register blocking along rows.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSteps = 16;
constexpr int kTileRows = 64;
constexpr int kTileCols = 128;     // or kNarrowCols where two wide windows don't fit
constexpr int kNarrowCols = 96;
constexpr int kWarps = 16;
constexpr int kBand = 8;           // rows a lane walks down per work item
constexpr int kMaxGroups = (kTileCols + 2 * kMaxSteps + 31) / 32;  // window cols / 32
// Shared memory of an SM (228 KB) split between two blocks, less the 1 KB
// the SM reserves for each.
constexpr size_t kTwoBlockBytes = 233472 / 2 - 1024;

struct Tile {
  int rows, cols;
};

size_t window_bytes(int K, const Tile& t) {
  const size_t buffers = K == 1 ? 1 : 2;
  return buffers * (t.rows + 2 * K) * (t.cols + 2 * K) * sizeof(float);
}

Tile tile_for(int K) {
  const Tile wide{kTileRows, kTileCols};
  return window_bytes(K, wide) <= kTwoBlockBytes ? wide : Tile{kTileRows, kNarrowCols};
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float point(float c0, float cx, float cy, float core,
                                       float up, float dn, float lf, float rt) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(c0, core), __fmul_rn(cx, __fadd_rn(up, dn))),
      __fmul_rn(cy, __fadd_rn(lf, rt)));
}

// Sweep s over window rows [s, R-s) and cols [s, C-s), reading src.  Not the
// last sweep: write dst.  The last sweep (s == K): store the tile to out,
// masked to the (H, W) output.  The region is cut into items of kBand rows
// by 32 columns, dealt out to the warps in turn; a lane walks down its
// column of an item.
template <bool kLast, typename Tout>
__device__ __forceinline__ void sweep(const float* __restrict__ src,
                                      float* __restrict__ dst,
                                      Tout* __restrict__ out, int s, int R,
                                      int C, int K, int i0, int j0, int H,
                                      int W, float c0, float cx, float cy) {
  const int groups = (C - 2 * s + 31) / 32;
  const int items = groups * ((R - 2 * s + kBand - 1) / kBand);
  for (int item = threadIdx.y; item < items; item += blockDim.y) {
    const int rb = s + (item / groups) * kBand;
    const int c = s + (item % groups) * 32 + threadIdx.x;
    if (c >= C - s) continue;
    float up = src[(rb - 1) * C + c];
    float core = src[rb * C + c];
#pragma unroll
    for (int r = rb; r < rb + kBand; ++r) {
      if (r >= R - s) break;
      const float dn = src[(r + 1) * C + c];
      const float v = point(c0, cx, cy, core, up, dn, src[r * C + c - 1],
                            src[r * C + c + 1]);
      if (kLast) {
        const int oi = i0 + r - K, oj = j0 + c - K;
        if (oi < H && oj < W) store(out + static_cast<int64_t>(oi) * W + oj, v);
      } else {
        dst[r * C + c] = v;
      }
      up = core;
      core = dn;
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kWarps)
chain2d_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, int H, int W,
               int K, int TM, int TN, int tiles_w, float c0, float cx,
               float cy) {
  extern __shared__ float window[];
  const int R = TM + 2 * K, C = TN + 2 * K;
  const int Hp = H + 2 * K, Wp = W + 2 * K;
  const int i0 = static_cast<int>(blockIdx.x / tiles_w) * TM;
  const int j0 = static_cast<int>(blockIdx.x % tiles_w) * TN;
  float* a = window;
  float* b = window + R * C;

  // Stage the window: a warp per row, kMaxGroups loads in flight per lane.
  for (int r = threadIdx.y; r < R; r += blockDim.y) {
    const int gi = i0 + r;
    float v[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int c = threadIdx.x + 32 * g;
      v[g] = (gi < Hp && c < C && j0 + c < Wp)
                 ? load(x + static_cast<int64_t>(gi) * Wp + j0 + c)
                 : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int c = threadIdx.x + 32 * g;
      if (c < C) a[r * C + c] = v[g];
    }
  }
  __syncthreads();

  for (int s = 1; s < K; ++s) {
    sweep<false, Tout>(a, b, out, s, R, C, K, i0, j0, H, W, c0, cx, cy);
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  sweep<true, Tout>(a, b, out, K, R, C, K, i0, j0, H, W, c0, cx, cy);
}

// One launch of K <= kMaxSteps sweeps: x is (H+2K, W+2K) of Tin, out (H, W)
// of Tout.  Returns the CUDA error of the attribute call or the launch.
template <typename Tin, typename Tout>
int launch(const void* x, void* out, int H, int W, int K, float c0, float cx,
           float cy, void* stream) {
  if (K < 1 || K > kMaxSteps || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = tile_for(K);
  const int64_t tiles_w = (static_cast<int64_t>(W) + t.cols - 1) / t.cols;
  const int64_t tiles = tiles_w * ((static_cast<int64_t>(H) + t.rows - 1) / t.rows);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = window_bytes(K, t);
  cudaError_t err = cudaFuncSetAttribute(
      chain2d_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chain2d_kernel<Tin, Tout>
      <<<static_cast<unsigned>(tiles), dim3(32, kWarps), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Tin*>(x), static_cast<Tout*>(out), H, W, K, t.rows,
          t.cols, static_cast<int>(tiles_w), c0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most sweeps one launch runs; the wrapper splits deeper chains.
extern "C" int chain2d_max_steps() { return kMaxSteps; }

// The tiling one launch of ``steps`` sweeps uses: output tile rows and cols,
// threads per block, dynamic shared memory per block in bytes.
extern "C" int chain2d_tile(int steps, int* rows, int* cols, int* threads,
                            int* smem_bytes) {
  if (steps < 1 || steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = tile_for(steps);
  *rows = t.rows;
  *cols = t.cols;
  *threads = 32 * kWarps;
  *smem_bytes = static_cast<int>(window_bytes(steps, t));
  return 0;
}

extern "C" int chain2d_f32(const void* x, void* out, int H, int W, int steps,
                           float c0, float cx, float cy, void* stream) {
  return launch<float, float>(x, out, H, W, steps, c0, cx, cy, stream);
}

extern "C" int chain2d_bf16(const void* x, void* out, int H, int W, int steps,
                            float c0, float cx, float cy, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, out, H, W, steps, c0, cx, cy,
                                              stream);
}

// First and last passes of a bf16 chain deeper than kMaxSteps.
extern "C" int chain2d_bf16_f32(const void* x, void* out, int H, int W,
                                int steps, float c0, float cx, float cy,
                                void* stream) {
  return launch<__nv_bfloat16, float>(x, out, H, W, steps, c0, cx, cy, stream);
}

extern "C" int chain2d_f32_bf16(const void* x, void* out, int H, int W,
                                int steps, float c0, float cx, float cy,
                                void* stream) {
  return launch<float, __nv_bfloat16>(x, out, H, W, steps, c0, cx, cy, stream);
}
