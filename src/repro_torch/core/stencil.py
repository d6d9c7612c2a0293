"""Stencils — the access patterns parallel loops use to read/write datasets.

Mirrors ``ops_stencil``: a set of relative offsets.  The *extent* of a stencil
per dimension drives both the skewed-tiling slopes (:mod:`repro_torch.core.tiling`)
and footprint computation for out-of-core transfers.

Copied from ``src/repro/core/stencil.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Stencil:
    """A named set of relative index offsets.

    Attributes:
      name: identifier (for diagnostics).
      points: tuple of offset tuples, e.g. ``((0, 0), (1, 0), (-1, 0))``.
    """

    name: str
    points: Tuple[Tuple[int, ...], ...]

    def __post_init__(self) -> None:
        if not self.points:
            raise ValueError(f"stencil {self.name!r}: empty")
        nd = len(self.points[0])
        if any(len(p) != nd for p in self.points):
            raise ValueError(f"stencil {self.name!r}: inconsistent arity")

    @property
    def ndim(self) -> int:
        return len(self.points[0])

    def extent(self, dim: int) -> Tuple[int, int]:
        """(min_offset, max_offset) along ``dim``."""
        offs = [p[dim] for p in self.points]
        return min(offs), max(offs)

    def max_abs_extent(self, dim: int) -> int:
        lo, hi = self.extent(dim)
        return max(abs(lo), abs(hi))

    def is_zero(self) -> bool:
        return all(all(o == 0 for o in p) for p in self.points)


def point_stencil(ndim: int) -> Stencil:
    """The 0-offset stencil (the only one legal for WRITE/RW/INC access)."""
    return Stencil(f"S{ndim}D_000", (tuple(0 for _ in range(ndim)),))


def star_stencil(ndim: int, radius: int = 1) -> Stencil:
    """Von-Neumann (star) stencil: centre plus ±r along each axis."""
    pts = [tuple(0 for _ in range(ndim))]
    for d in range(ndim):
        for r in range(1, radius + 1):
            for sgn in (-1, 1):
                p = [0] * ndim
                p[d] = sgn * r
                pts.append(tuple(p))
    return Stencil(f"S{ndim}D_star{radius}", tuple(pts))


def box_stencil(ndim: int, radius: int = 1) -> Stencil:
    """Moore (box) stencil: all offsets with |o_d| <= radius."""
    import itertools

    rng = range(-radius, radius + 1)
    pts = tuple(itertools.product(rng, repeat=ndim))
    return Stencil(f"S{ndim}D_box{radius}", pts)


def offset_stencil(*offsets: Tuple[int, ...]) -> Stencil:
    """Ad-hoc stencil from explicit offsets."""
    name = "S_" + "_".join("m".join(str(o).replace("-", "n") for o in p) for p in offsets)
    return Stencil(name[:64], tuple(tuple(p) for p in offsets))
