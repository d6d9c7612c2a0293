// 2-D 5-point star stencil sweep for Hopper (sm_90a), as a vectorised row
// march with its rows in flight.
//
// Replaces the TPU kernel src/repro/kernels/stencil2d.py::stencil2d_pallas
// (body _kernel, wrapper ops.py::stencil2d, oracle ref.py::stencil2d_ref):
//
//   out[i,j] = c0*u[i+1,j+1] + cx*(u[i,j+1] + u[i+2,j+1]) + cy*(u[i+1,j] + u[i+1,j+2])
//
// on a (H+2, W+2) padded input, fp32 accumulation, result cast once to the
// input type (fp32 or bf16).  The kernel is in stencil2d.cuh, which
// chain2d.cu shares for its one-sweep launches.
//
// Bound on an H100 SXM: 7 flops a point against 8 bytes a point in fp32 (4
// in bf16), far below the card's ~20 flop/byte balance, so device memory
// bounds it.  Each input byte read once and each output byte written once:
// at the main path's 16384^2 interior (16386^2 + 16384^2) * 4 B = 2.15 GB,
// 0.641 ms at 3.35 TB/s in fp32, 0.321 ms in bf16.
//
// Tiling.  A warp owns a strip of S = 32 V output columns, V the elements
// of a 16-byte chunk (4 fp32 or 8 bf16, so 128 or 256 columns a warp), and
// marches down a segment of kPoints / S output rows, kPoints = 2,048: 16
// rows in fp32, 8 in bf16.  A block is kWarps = 4 neighbouring strips of
// one segment, and consecutive blocks walk along a band of rows, then down
// to the next band: 32,768 blocks at 16384^2 in either type.  The warp
// stages the segment's input rows (18 in fp32, 10 in bf16), S + 2 columns
// each, into shared memory all at once by cp.async (cp_async.cuh: 16-byte
// chunks from the row's aligned-down start; the chunks at the tensor's two
// ends go element by element, so nothing outside the tensor is read), one
// commit group a row, and sweeps each row as soon as its group has landed:
// 10 KB (5 KB in bf16) a warp in flight without holding registers for it,
// about 200 KB an SM, where 3.35 TB/s at a microsecond of latency asks for
// some 25 KB.  Each input byte comes from device memory about once: the
// halo columns and the two halo rows of a segment are read again, but by
// the neighbouring strips and segments, which run at the same time, so
// mostly from L2.  From L2 a warp reads 34 16-byte chunks a row for S
// outputs, 1.06 times the strip, times 18/16 rows in fp32 and 10/8 in bf16:
// 1.20 x 4 B and 1.33 x 2 B a point.
//
// Why short segments.  Measured on the H100 (PERF.md), the time fell as the
// segment shrank from 256 rows to 16 or 8, at any depth of staging, and
// rose again at 2, where the halo rows double the reads from L2; 16 rows
// timed a little faster than 8 in fp32, and 8 than 16 in bf16 (the shorter
// segment halves its shared memory, so twice the warps fit an SM).  With long segments the warps resident on the card read and write
// thousands of rows far apart at once; with short ones a few hundred
// neighbouring rows, as a 2-D window kernel does.  A segment that short is
// staged whole, so no ring of rows is needed.
//
// The sweep.  Lane l owns the strip's columns l, l + 32, ..., l + 32 (V-1).
// It keeps its V values of each row in registers for three rows: the row is
// the lower neighbour, then the centre, then the upper neighbour.  The left
// and right neighbours it reads from the staged centre row.  Every shared
// load covers 32 neighbouring elements, free of bank conflicts whatever the
// row's alignment: 3 V loads a lane a row.
//
// Stores.  Each of a lane's V results goes out as one scalar store, 32
// neighbouring columns an instruction (128 B in fp32, 64 B in bf16), so the
// stores are coalesced at any width and any alignment of the output; the
// ragged end of the last strip is masked.  The other layout, V consecutive
// columns a lane and one 16-byte store, timed the same on the H100 where W
// is a multiple of V and the output aligned, but clearly slower elsewhere,
// where it falls back to V scalar stores 16 bytes apart, and it needs a
// case for each.
//
// Why not TMA.  A tensor map needs global strides that are multiples of 16
// bytes, and cp.async.bulk 16-byte-aligned addresses and sizes.  The input's
// row pitch is (W+2) elements: 65,544 B at the main path's 16384^2 fp32,
// not a multiple of 16, so alternate rows start 8 bytes off (bf16 rows only
// 4-byte aligned), and a caller may hand over a slice at any element
// offset.  Repacking the input to an aligned pitch would cost a whole extra
// pass over its bytes.  So rows go through cp.async in 16-byte chunks from
// their aligned-down start, and readers add the row's offset; no row is
// ever read with a wider load than its alignment allows.
//
// Why the arithmetic order is fixed.  Every sum uses __fadd_rn/__fmul_rn in
// the order of the elementwise PyTorch formula (ref.py::stencil2d_ref), with
// nothing contracted into an FMA.  So the fp32 result is bit-identical to
// the plain version, the bf16 result too (the same fp32 operations, then one
// round-to-nearest), and chain2d stays bit-identical to K launches of this
// kernel.
//
// The earlier kernel (one thread a point, five scalar loads through L1/L2
// and one scalar store) reached about half the bound in fp32 and 30% in
// bf16: load instructions and loads in flight bounded it, not bytes.
// Tried here and no faster: the left and right neighbours by shuffles,
// streaming stores, cp.async without the per-chunk bounds checks inside the
// tensor, 2 or 8 warps a block, and a 4- to 16-row ring of rows under
// segments of 16 to 256 rows.
#include "stencil2d.cuh"

extern "C" int stencil2d_f32(const void* x, void* out, int H, int W, float c0,
                             float cx, float cy, void* stream) {
  return sweep2d::launch<float, float>(x, out, H, W, c0, cx, cy,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int stencil2d_bf16(const void* x, void* out, int H, int W, float c0,
                              float cx, float cy, void* stream) {
  return sweep2d::launch<__nv_bfloat16, __nv_bfloat16>(
      x, out, H, W, c0, cx, cy, static_cast<cudaStream_t>(stream));
}

// The tiling of one launch for an input of ``elem_bytes`` (4: fp32, 2:
// bf16): the output rows and columns a warp owns, threads per block, and
// shared memory per block in bytes.
extern "C" int stencil2d_tile(int elem_bytes, int* rows, int* cols, int* threads,
                              int* smem_bytes) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  *rows = elem_bytes == 4 ? sweep2d::seg_rows<float>() : sweep2d::seg_rows<__nv_bfloat16>();
  *cols = elem_bytes == 4 ? sweep2d::strip_cols<float>() : sweep2d::strip_cols<__nv_bfloat16>();
  *threads = 32 * sweep2d::kWarps;
  *smem_bytes = elem_bytes == 4 ? sweep2d::block_bytes<float>()
                                : sweep2d::block_bytes<__nv_bfloat16>();
  return 0;
}
