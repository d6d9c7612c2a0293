"""Shared building blocks: norms, rotary embeddings, MLPs, initialisers.

Ported from ``src/repro/models/layers.py``.  The initialisers draw from an
explicit ``torch.Generator``; the reference's ``KeyGen`` has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in fp32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotate-half: the first and second halves of ``head_dim`` are the pair
    (the reference's ``jnp.split(x, 2, axis=-1)``), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                        # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb, dtype=torch.float32)


# -- initialisers --------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights scaled by ``1/sqrt(fan_in)`` (or ``scale``), drawn in
    fp32 on the generator's device and cast to ``dtype`` (scaled in place:
    one fp32 copy of the weight at a time)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(s).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(0.02).to(dtype)
