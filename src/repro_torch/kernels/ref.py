"""Plain PyTorch versions of every kernel — the port of ``src/repro/kernels/ref.py``.

The wrappers in :mod:`repro_torch.kernels.ops` run these for CPU tensors;
tests and ``chip_smoke.py`` hold the CUDA kernels against them on the card.
They run on any device.  Accumulation is fp32 and the result is cast back to
the input type, as in the reference oracles.
"""
from __future__ import annotations

from typing import Sequence

import torch


def stencil2d_ref(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """5-point star on (H+2, W+2) padded input -> (H, W)."""
    u = x.float()
    c0, cx, cy = (float(c) for c in coeffs)
    out = (
        c0 * u[1:-1, 1:-1]
        + cx * (u[:-2, 1:-1] + u[2:, 1:-1])
        + cy * (u[1:-1, :-2] + u[1:-1, 2:])
    )
    return out.to(x.dtype)


def stencil3d_ref(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """7-point star on (D+2, H+2, W+2) padded input -> (D, H, W)."""
    u = x.float()
    c0, cz, cx, cy = (float(c) for c in coeffs)
    out = (
        c0 * u[1:-1, 1:-1, 1:-1]
        + cz * (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1])
        + cx * (u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1])
        + cy * (u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])
    )
    return out.to(x.dtype)


def chain2d_ref(x: torch.Tensor, coeffs: Sequence[float], steps: int) -> torch.Tensor:
    """K sequential full-grid 5-point sweeps on (H+2K, W+2K) input -> (H, W).

    Float32 accumulation throughout (matching the kernel), cast at the end.
    """
    u = x.float()
    c0, cx, cy = (float(c) for c in coeffs)
    for _ in range(steps):
        u = (
            c0 * u[1:-1, 1:-1]
            + cx * (u[:-2, 1:-1] + u[2:, 1:-1])
            + cy * (u[1:-1, :-2] + u[1:-1, 2:])
        )
    return u.to(x.dtype)
