// 2-D 5-point star stencil sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/stencil2d.py::stencil2d_pallas
// (body _kernel, wrapper ops.py::stencil2d, oracle ref.py::stencil2d_ref):
//
//   out[i,j] = c0*u[i+1,j+1] + cx*(u[i,j+1] + u[i+2,j+1]) + cy*(u[i+1,j] + u[i+1,j+2])
//
// on a (H+2, W+2) padded input, fp32 accumulation, result cast to the input
// type (fp32 or bf16).
//
// Bound on an H100 SXM: the sweep does 7 flops per point against at least
// 8 bytes moved per fp32 point, far below the card's ~20 flop/byte balance,
// so it is memory bound.  Counting each input byte read once and each output
// byte written once, at the main path's 16384^2 fp32 interior that is
// (16386^2 + 16384^2) * 4 B = 2.15 GB, or 0.64 ms at 3.35 TB/s.
//
// Design against that bound: one thread per output point, threads of a warp
// on neighbouring columns so every load and the store are coalesced along W;
// the four neighbours of a point are the neighbours' centres, so the rows
// above and below and the left/right columns are re-read from L1/L2 rather
// than from device memory.  The ragged right and bottom edges are masked.
// Coefficients arrive as float arguments (no device tensor, no host sync).
// The sums use __fadd_rn/__fmul_rn so that nothing is contracted into an
// FMA: the result is bit-identical to the same formula evaluated one
// elementwise PyTorch op at a time.  Shared-memory blocking, TMA and
// register reuse along rows are left for later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void stencil2d_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int H, int W, float c0, float cx, float cy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int64_t wp = static_cast<int64_t>(W) + 2;
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < H;
       i += gridDim.y * blockDim.y) {
    const T* c = x + (static_cast<int64_t>(i) + 1) * wp + (j + 1);
    const float core = load(c);
    const float up = load(c - wp);
    const float dn = load(c + wp);
    const float lf = load(c - 1);
    const float rt = load(c + 1);
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(c0, core), __fmul_rn(cx, __fadd_rn(up, dn))),
        __fmul_rn(cy, __fadd_rn(lf, rt)));
    store(out + static_cast<int64_t>(i) * W + j, v);
  }
}

template <typename T>
int launch(const void* x, void* out, int H, int W, float c0, float cx,
           float cy, void* stream) {
  const dim3 block(128, 4);
  const unsigned rows = (static_cast<unsigned>(H) + block.y - 1) / block.y;
  const dim3 grid((static_cast<unsigned>(W) + block.x - 1) / block.x,
                  rows < 65535u ? rows : 65535u);
  stencil2d_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, c0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil2d_f32(const void* x, void* out, int H, int W, float c0,
                             float cx, float cy, void* stream) {
  return launch<float>(x, out, H, W, c0, cx, cy, stream);
}

extern "C" int stencil2d_bf16(const void* x, void* out, int H, int W, float c0,
                              float cx, float cy, void* stream) {
  return launch<__nv_bfloat16>(x, out, H, W, c0, cx, cy, stream);
}
