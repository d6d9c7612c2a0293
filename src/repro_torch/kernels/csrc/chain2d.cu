// K fused 2-D 5-point star sweeps for Hopper (sm_90a), as a wavefront of
// sweeps in registers walking down column strips.
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
// 0.22 ms.  That flop rate counts fused multiply-adds, which would break
// bit-identity, so the instruction floor lies higher: a point of a sweep
// issues 7 fp32 instructions (3 multiplies, 4 adds, none contracted) and
// about half a shuffle, and 132 SMs x 128 lanes x ~1.98 GHz issue about
// 3.35e13 lane-instructions a second, so a sweep of 16384^2 points costs
// about 0.060 ms before any redundant point.  With the redundancy of the
// strips below, that floor passes the 0.64 ms of bytes near K = 9.  Measured
// on the H100 (PERF.md), the kernel is bound by device memory up to K = 4
// and by instructions from K = 8.
//
// Design, for K >= 2.  A warp owns a column strip of kStrip = 128 input
// columns, kV = 4 consecutive columns a lane, and walks down a segment of TM
// output rows.
// The strip's output is its middle S = 128 - 2K columns, rounded down to a
// multiple of 8 so that every strip's stores start on a 32-byte sector;
// neighbouring strips overlap by the rest (the same rows, read by the same
// block at the same time, so mostly from L2).  Each input row that arrives
// feeds a pipeline of K sweeps held in registers: sweep s keeps the two
// previous rows of sweep s-1 (2 kV K registers in all), and when row r of
// the input arrives, sweep 1 emits row r-1, sweep 2 row r-2, ..., sweep K
// row r-K, which is stored (masked) when it lies in the output.  Left and
// right neighbours come from the lane's own registers or, at its first and
// last column, from the next lanes by __shfl_up_sync/__shfl_down_sync: two
// shuffles a lane per kV points per sweep, and no shared-memory traffic.
// The two held rows of each sweep live in three register sets whose roles
// turn with the step (the row loop is unrolled by three), so no row is ever
// copied.  Columns that have gone invalid at the strip's edges are computed
// and thrown away, as a SIMD warp must; so are the 2K rows that fill the
// pipeline.  Input rows arrive through a ring of kStages rows per warp in
// shared memory, filled by cp.async kStages - 1 rows ahead of the wavefront
// (16-byte chunks from the row's aligned-down start, cp_async.cuh), so each
// warp keeps ~3.5 KB in flight; a finished row goes out through a 512-byte
// row of shared memory so that each store instruction writes 32 neighbouring
// columns.  The sweep count is a template parameter, so the register
// rotation is resolved at compile time (K = 2..kMaxSteps instantiated for
// each entry point).  Cells beyond the ragged right edge are read as zero
// and feed only masked outputs.  Every sum uses __fadd_rn/__fmul_rn in the
// order of stencil2d.cu, so the fp32 result is bit-identical to the plain
// version and to K launches of stencil2d.
//
// One sweep (K = 1) has nothing to pipeline.  It runs the one-sweep kernel
// of stencil2d.cuh, which stencil2d.cu launches too: a 16 x 128 output tile
// a warp (fp32 input), its 18 x 130 window read 1.143 times per output point
// (mostly from L2) and nothing swept twice.  On the H100 it is faster than
// the 2-D window kernel that ran K = 1 before, which was itself faster there
// than this wavefront at K = 1 (PERF.md).
//
// Trade-offs of the strip (kV = 4, 4 warps a block) from
// chip_smoke.py::chain_traffic_model with a 128-column window: "reads" is
// (TM+2K) 128 / (TM S), the input a warp reads per output point; "computed"
// is the points swept per useful point, the same ratio since every sweep
// runs over the whole window; "floor" is the instruction floor above times K
// times "computed", at a 16384^2 interior:
//
//   K    TM   S     reads = computed   floor ms
//   2    64   120   1.133              0.14
//   4    64   120   1.200              0.29
//   8    256  112   1.214              0.58
//   12   512  104   1.288              0.93
//   16   two launches of 8             1.17
//
// Where device memory bounds the kernel (K <= 4) a short segment was fastest
// on the H100, though its skirt of 2K rows is read and swept again; where
// instructions bound it, TM is long enough that the skirt is a few percent
// and short enough to give the card a few thousand warps at 16384^2.  Tried
// and no faster: TM from 32 to 1024, 4 to 12 ring rows, 2, 8 or 16 warps a
// block, 8 columns a lane up to K = 2, stores batched over several rows,
// streaming stores and L2 prefetch hints.
//
// K beyond kMaxSteps (12): the state grows by 8 registers a lane per sweep
// (ptxas: about 180 at K = 12, two blocks of 4 warps an SM) and the column
// overhead with it, so a sweep costs more the deeper the launch; one launch
// of 16 sweeps, built for a trial on the H100, was slower than two launches
// of 8.  The wrapper (ops.py::chain2d) runs ceil(K/12) balanced passes of 6
// to 12 sweeps through fp32 intermediates (entry points chain2d_bf16_f32,
// chain2d_f32 and chain2d_f32_bf16), bit-identical to one pass; an extra
// pass costs one fp32 write and read of the interior, which the sweeps hide
// from K = 8 up.
//
// Left for later work: reads and writes that overlap better in the
// wavefront at small K, and skipping the sweeps that only fill the pipeline.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "stencil2d.cuh"

namespace {

constexpr int kMaxSteps = 12;
constexpr int kV = 4;              // columns a lane holds
constexpr int kStrip = 32 * kV;    // input columns a warp holds
constexpr int kWarps = 4;          // strips a block
constexpr int kStages = 8;         // ring rows a warp

struct Tile {
  int rows, cols;
};

// The strip's output width, 128 - 2K rounded down to 8 columns so that every
// strip's stores start on a 32-byte sector.
__host__ __device__ constexpr int strip_cols(int K) { return (kStrip - 2 * K) / 8 * 8; }

Tile tile_for(int K) {
  if (K == 1) return {sweep2d::seg_rows<float>(), sweep2d::strip_cols<float>()};
  return {K <= 4 ? 64 : K <= 8 ? 256 : 512, strip_cols(K)};
}

// 16-byte chunks a ring row holds: the strip plus its alignment offset.
template <typename T>
__host__ __device__ constexpr int ring_chunks() {
  return (kStrip + 2 * (16 / static_cast<int>(sizeof(T)) - 1)) /
         (16 / static_cast<int>(sizeof(T)));
}

// Shared memory of a block: the warps' rings and store rows.
template <typename T>
constexpr int block_bytes() {
  return kWarps * (kStages * ring_chunks<T>() * 16 + kStrip * static_cast<int>(sizeof(float)));
}

using sweep2d::point;
using sweep2d::store;
using sweep2d::to_float;

// A block of kWarps warps takes kWarps neighbouring strips of one segment of
// TM output rows; blockIdx.x = segment * groups + strip group.
template <int K, typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kWarps, 1)
chain2d_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, int H, int W,
               int TM, int strips, int groups, float c0, float cx, float cy) {
  constexpr int S = strip_cols(K);
  constexpr int kChunks = ring_chunks<Tin>();
  __shared__ __align__(16) unsigned char buf[kWarps][kStages][kChunks * 16];
  __shared__ __align__(16) float obuf[kWarps][kStrip];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = static_cast<int>(blockIdx.x % groups) * kWarps + warp;
  if (strip >= strips) return;
  const int o0 = static_cast<int>(blockIdx.x / groups) * TM;
  const int c = strip * S;                       // first input and output column
  const int64_t Wp = static_cast<int64_t>(W) + 2 * K;
  const int64_t n = (static_cast<int64_t>(H) + 2 * K) * Wp;
  const int steps = min(TM, H - o0) + 2 * K;     // input rows the warp reads
  const int valid = Wp - c < kStrip ? static_cast<int>(Wp - c) : kStrip;
  const Tin* row0 = x + static_cast<int64_t>(o0) * Wp + c;
  unsigned char(*slots)[kChunks * 16] = buf[warp];
  float* ob = obuf[warp];

  auto stage = [&](int t) {
    if (t < steps) {
      const Tin* p = row0 + t * Wp;
      for (int k = lane; k < kChunks; k += 32)
        ring::stage_chunk(slots[t % kStages], p, valid, k, x, n);
    }
    ring::commit();
  };
  for (int t = 0; t < kStages - 1; ++t) stage(t);

  // R[s]: the two previous rows of u_s that sweep s+1 holds, in three
  // register sets whose roles turn with the step, so that no row is ever
  // copied: at phase P the older row is set P, the newer P+1, and the
  // incoming row goes to P+2 (mod 3).
  float R[K][3][kV];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int v = 0; v < kV; ++v) R[s][q][v] = 0.0f;

  auto step = [&](auto phase, int t) {
    constexpr int a = decltype(phase)::value, b = (a + 1) % 3, d = (a + 2) % 3;
    ring::wait<kStages - 2>();
    __syncwarp();
    stage(t + kStages - 1);     // into the row read at step t-1
    const Tin* e = reinterpret_cast<const Tin*>(slots[t % kStages]) +
                   ring::align_offset(row0 + t * Wp) + kV * lane;
    float u[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v)
      u[v] = kV * lane + v < valid ? to_float(e[v]) : 0.0f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float lf = __shfl_up_sync(0xffffffffu, R[s][b][kV - 1], 1);
      const float rt = __shfl_down_sync(0xffffffffu, R[s][b][0], 1);
      float r[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v)
        r[v] = point(c0, cx, cy, R[s][b][v], R[s][a][v], u[v],
                     v == 0 ? lf : R[s][b][v - 1], v == kV - 1 ? rt : R[s][b][v + 1]);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        R[s][d][v] = u[v];
        u[v] = r[v];
      }
    }
    // u is row t-K of u_K in the window, output row o0 + t - 2K.  It goes
    // through the warp's row of obuf so that each store is 32 neighbouring
    // columns from a sector boundary.
    if (t >= 2 * K) {
      static_assert(kV == 4, "a lane's part of the row is one float4");
      *reinterpret_cast<float4*>(ob + kV * lane) = make_float4(u[0], u[1], u[2], u[3]);
      __syncwarp();
      Tout* o = out + (static_cast<int64_t>(o0) + t - 2 * K) * W + c;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int j = 32 * v + lane;   // output column in the strip
        if (j < S && c + j < W) store(o + j, ob[j + K]);
      }
    }
  };
  for (int t = 0; t < steps; t += 3) {
    step(std::integral_constant<int, 0>{}, t);
    if (t + 1 == steps) break;
    step(std::integral_constant<int, 1>{}, t + 1);
    if (t + 2 == steps) break;
    step(std::integral_constant<int, 2>{}, t + 2);
  }
}

template <int K, typename Tin, typename Tout>
int launch_k(const void* x, void* out, int H, int W, float c0, float cx,
             float cy, cudaStream_t stream) {
  const Tile t = tile_for(K);
  const int64_t strips = (static_cast<int64_t>(W) + t.cols - 1) / t.cols;
  const int64_t groups = (strips + kWarps - 1) / kWarps;
  const int64_t blocks = groups * ((static_cast<int64_t>(H) + t.rows - 1) / t.rows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  chain2d_kernel<K, Tin, Tout><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), H, W, t.rows,
      static_cast<int>(strips), static_cast<int>(groups), c0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// One launch of K <= kMaxSteps sweeps: x is (H+2K, W+2K) of Tin, out (H, W)
// of Tout.  Returns the CUDA error of the launch.
template <typename Tin, typename Tout, int... Ks>
int launch(const void* x, void* out, int H, int W, int K, float c0, float cx,
           float cy, void* stream, std::integer_sequence<int, Ks...>) {
  if (K < 1 || K > kMaxSteps || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 1) return sweep2d::launch<Tin, Tout>(x, out, H, W, c0, cx, cy, s);
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((K == Ks + 2 ? (err = launch_k<Ks + 2, Tin, Tout>(x, out, H, W, c0, cx, cy, s))
                : 0),
   ...);
  return err;
}

template <typename Tin, typename Tout>
int launch(const void* x, void* out, int H, int W, int K, float c0, float cx,
           float cy, void* stream) {
  return launch<Tin, Tout>(x, out, H, W, K, c0, cx, cy, stream,
                           std::make_integer_sequence<int, kMaxSteps - 1>{});
}

}  // namespace

// The most sweeps one launch runs; the wrapper splits deeper chains.
extern "C" int chain2d_max_steps() { return kMaxSteps; }

// The tiling one launch of ``steps`` sweeps uses: the output rows and cols a
// warp owns (a segment of its strip), threads per block, and shared memory
// per block in bytes (for an fp32 input).
extern "C" int chain2d_tile(int steps, int* rows, int* cols, int* threads,
                            int* smem_bytes) {
  if (steps < 1 || steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = tile_for(steps);
  *rows = t.rows;
  *cols = t.cols;
  *threads = 32 * (steps == 1 ? sweep2d::kWarps : kWarps);
  *smem_bytes = steps == 1 ? sweep2d::block_bytes<float>() : block_bytes<float>();
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
