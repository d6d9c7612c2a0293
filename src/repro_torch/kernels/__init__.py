"""Hand-written CUDA kernels for Hopper, replacing the reference's Pallas TPU
kernels one by one.

Each kernel has: its CUDA C++ source (``csrc/<name>.cu``, built by
:mod:`repro_torch.kernels.build`), a checked wrapper with a launch count in
:mod:`repro_torch.kernels.ops`, and a plain PyTorch version in
:mod:`repro_torch.kernels.ref`.  Every Pallas kernel of the reference is
ported: ``stencil2d``, ``stencil3d`` and the fused K-sweep ``chain2d``.
"""
from .ops import chain2d, star2d_kernel, star3d_kernel, stencil2d, stencil3d

__all__ = ["stencil2d", "stencil3d", "chain2d", "star2d_kernel", "star3d_kernel"]
