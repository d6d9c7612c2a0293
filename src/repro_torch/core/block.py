"""Structured-mesh blocks — the coordinate frames datasets live on.

Mirrors ``ops_block`` from the OPS DSL: a block is an n-dimensional
Cartesian index space.  Datasets (:mod:`repro_torch.core.dataset`) are defined on a
block; parallel loops iterate over sub-boxes of a block.

Copied from ``src/repro/core/block.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class Block:
    """An n-dimensional structured grid index space.

    Attributes:
      name: unique identifier.
      size: grid points per dimension (interior, excluding halos).
    """

    name: str
    size: Tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.size or any(s <= 0 for s in self.size):
            raise ValueError(f"block {self.name!r}: bad size {self.size}")

    @property
    def ndim(self) -> int:
        return len(self.size)

    def full_range(self) -> Tuple[Tuple[int, int], ...]:
        """Iteration range covering the whole interior: ((0, n0), (0, n1), ...)."""
        return tuple((0, s) for s in self.size)

    def points(self) -> int:
        n = 1
        for s in self.size:
            n *= s
        return n
