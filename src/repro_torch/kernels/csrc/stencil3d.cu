// 3-D 7-point star stencil sweep for Hopper (sm_90a).
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
// is (514^3 + 512^3) * 4 B = 1.08 GB, or 0.32 ms at 3.35 TB/s.
//
// Design against that bound: one thread per output point, a block covering
// a (4 x 128) patch of one z-plane so that warps read and write contiguous
// runs along W (coalesced); the six neighbours are other threads' centres,
// re-read from L1/L2 — the z-neighbours come from planes that the blocks of
// the adjacent z-slices stream through L2 at about the same time.  Ragged
// edges are masked.  Coefficients arrive as float arguments.  __fadd_rn and
// __fmul_rn keep the arithmetic free of FMA contraction, so the result is
// bit-identical to the elementwise PyTorch formula.  A z-marching register
// queue with shared-memory planes is left for later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void stencil3d_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int D, int H, int W, float c0, float cz,
                                 float cx, float cy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= W || i >= H) return;
  const int64_t wp = static_cast<int64_t>(W) + 2;
  const int64_t plane = (static_cast<int64_t>(H) + 2) * wp;
  for (int k = blockIdx.z; k < D; k += gridDim.z) {
    const T* c = x + (static_cast<int64_t>(k) + 1) * plane +
                 (static_cast<int64_t>(i) + 1) * wp + (j + 1);
    const float core = load(c);
    const float zm = load(c - plane);
    const float zp = load(c + plane);
    const float xm = load(c - wp);
    const float xp = load(c + wp);
    const float ym = load(c - 1);
    const float yp = load(c + 1);
    const float v = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(c0, core), __fmul_rn(cz, __fadd_rn(zm, zp))),
                  __fmul_rn(cx, __fadd_rn(xm, xp))),
        __fmul_rn(cy, __fadd_rn(ym, yp)));
    store(out + (static_cast<int64_t>(k) * H + i) * W + j, v);
  }
}

template <typename T>
int launch(const void* x, void* out, int D, int H, int W, float c0, float cz,
           float cx, float cy, void* stream) {
  const dim3 block(128, 4, 1);
  const unsigned planes = static_cast<unsigned>(D);
  const dim3 grid((static_cast<unsigned>(W) + block.x - 1) / block.x,
                  (static_cast<unsigned>(H) + block.y - 1) / block.y,
                  planes < 65535u ? planes : 65535u);
  stencil3d_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), D, H, W, c0, cz, cx, cy);
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
