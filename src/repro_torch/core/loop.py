"""Parallel loops — the unit of computation the runtime schedules (``ops_par_loop``).

A loop owns: an iteration box over a block, a list of dataset arguments
(dataset + stencil + access mode), optional global reductions, and a
*vectorised* kernel.  The kernel receives an :class:`Accessor` and returns a
dict mapping written-dataset names to value arrays over the iteration box
(plus reduction contributions).  Point-order independence — the core OPS
contract that legitimises re-scheduling — is preserved by construction:
kernels are pure array functions of their stencil reads.

Write/RW/INC arguments must use the zero stencil (same restriction as OPS);
READ arguments may use any stencil.

Ported from ``src/repro/core/loop.py``: kernels see and return
``torch.Tensor``s, and :meth:`ReductionSpec.combine` uses
``torch.minimum``/``torch.maximum``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

from .block import Block
from .dataset import Dataset
from .stencil import Stencil


class AccessMode(enum.Enum):
    READ = "read"
    WRITE = "write"
    RW = "rw"
    INC = "inc"

    @property
    def reads(self) -> bool:
        return self in (AccessMode.READ, AccessMode.RW, AccessMode.INC)

    @property
    def writes(self) -> bool:
        return self in (AccessMode.WRITE, AccessMode.RW, AccessMode.INC)


# Short aliases, OPS-style.
READ = AccessMode.READ
WRITE = AccessMode.WRITE
RW = AccessMode.RW
INC = AccessMode.INC


@dataclass(frozen=True)
class Arg:
    """One dataset argument of a parallel loop."""

    dat: Dataset
    stencil: Stencil
    mode: AccessMode

    def __post_init__(self) -> None:
        if self.stencil.ndim != self.dat.ndim:
            raise ValueError(
                f"arg {self.dat.name!r}: stencil ndim {self.stencil.ndim} != "
                f"dat ndim {self.dat.ndim}"
            )
        if self.mode.writes and not self.stencil.is_zero():
            raise ValueError(
                f"arg {self.dat.name!r}: {self.mode.value} access requires the "
                f"zero stencil (got {self.stencil.name!r})"
            )


class Accessor:
    """What kernels see: ``acc(name, offset)`` -> array over the iteration box.

    Concrete accessors are provided by the execution engines (in-core, tiled,
    out-of-core, kernel backend); kernels never touch raw storage.  ``acc.shape`` is
    the (static) iteration-box shape; ``acc.coords()`` returns per-dimension
    global grid coordinates over the box (OPS's ``ops_arg_idx``) — kernels
    that need spatial position MUST use it so they stay correct under tiling.
    ``acc.device`` is the ``torch.device`` the accessor's tensors live on: a
    kernel that makes a fresh tensor (``torch.ones(acc.shape, ...)``) makes
    it there, or the engine would copy it from the host on every tile.
    """

    shape: Tuple[int, ...] = ()
    device = None   # torch.device, set by every concrete accessor

    def __call__(self, name: str, offset: Tuple[int, ...] = None):  # pragma: no cover
        raise NotImplementedError

    def coords(self):  # pragma: no cover
        raise NotImplementedError


Kernel = Callable[[Accessor], Dict[str, "torch.Tensor"]]  # noqa: F821


@dataclass
class ReductionSpec:
    """A global reduction produced by a loop (forces a chain boundary)."""

    name: str
    op: str = "sum"  # sum | min | max

    def combine(self, a, b):
        """Fold two partial results (tensors, NumPy arrays or scalars) into
        one tensor on ``a``'s device."""
        import torch

        a = torch.as_tensor(a)
        b = torch.as_tensor(b, device=a.device)
        if self.op == "sum":
            return a + b
        if self.op == "min":
            return torch.minimum(a, b)
        if self.op == "max":
            return torch.maximum(a, b)
        raise ValueError(self.op)

    def identity(self):
        import numpy as np

        return {"sum": 0.0, "min": np.inf, "max": -np.inf}[self.op]


@dataclass
class ParallelLoop:
    """A recorded (lazy) loop over ``range_`` applying ``kernel``."""

    name: str
    block: Block
    range_: Tuple[Tuple[int, int], ...]
    args: Tuple[Arg, ...]
    kernel: Kernel
    reductions: Tuple[ReductionSpec, ...] = ()

    def __post_init__(self) -> None:
        if len(self.range_) != self.block.ndim:
            raise ValueError(f"loop {self.name!r}: range arity mismatch")
        for a, b in self.range_:
            if b < a:
                raise ValueError(f"loop {self.name!r}: empty/negative range {self.range_}")
        seen_writes = set()
        for arg in self.args:
            if arg.dat.block is not self.block:
                raise ValueError(
                    f"loop {self.name!r}: dat {arg.dat.name!r} on a different block"
                )
            if arg.mode.writes:
                if arg.dat.name in seen_writes:
                    raise ValueError(
                        f"loop {self.name!r}: dat {arg.dat.name!r} written twice"
                    )
                seen_writes.add(arg.dat.name)
        # A dat written by this loop may only be READ at zero offset within the
        # same loop — UNLESS the read and write regions are provably disjoint
        # (halo-update loops: write halo rows, mirror-read the interior).
        # Offset reads of self-written data otherwise race under any parallel
        # schedule AND break skewed tiling (intra-loop WAR across tiles); OPS
        # imposes the same restriction; real codes split such loops in two.
        for arg in self.args:
            if (arg.mode is AccessMode.READ and arg.dat.name in seen_writes
                    and not arg.stencil.is_zero()):
                disjoint = False
                for d in range(self.block.ndim):
                    lo, hi = self.range_[d]
                    mn, mx = arg.stencil.extent(d)
                    # read interval [lo+mn, hi+mx) vs write interval [lo, hi)
                    if hi + mx <= lo or lo + mn >= hi:
                        disjoint = True
                        break
                if not disjoint:
                    raise ValueError(
                        f"loop {self.name!r}: {arg.dat.name!r} is written by this "
                        f"loop but read with non-zero stencil {arg.stencil.name!r} "
                        "over an overlapping region — split the loop"
                    )
        # Validate that loop range (extended by read stencils) stays within
        # dataset bounds — catches missing halo allocation at record time,
        # the moral equivalent of OPS's runtime bounds checks.
        for arg in self.args:
            for d in range(self.block.ndim):
                lo_off, hi_off = arg.stencil.extent(d)
                lo, hi = self.range_[d]
                blo, bhi = arg.dat.bounds(d)
                if arg.mode.reads and (lo + lo_off < blo or hi + hi_off > bhi):
                    raise ValueError(
                        f"loop {self.name!r}: read of {arg.dat.name!r} out of bounds "
                        f"in dim {d}: range [{lo},{hi}) + stencil [{lo_off},{hi_off}] "
                        f"vs dat bounds [{blo},{bhi})"
                    )
                if arg.mode.writes and (lo < blo or hi > bhi):
                    raise ValueError(
                        f"loop {self.name!r}: write of {arg.dat.name!r} out of bounds"
                    )

    # -- classification helpers used by dependency analysis ------------------
    def reads_of(self, dat_name: str) -> Sequence[Arg]:
        return [a for a in self.args if a.dat.name == dat_name and a.mode.reads]

    def writes_of(self, dat_name: str) -> Sequence[Arg]:
        return [a for a in self.args if a.dat.name == dat_name and a.mode.writes]

    @property
    def dat_names(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(a.dat.name for a in self.args))

    def bytes_moved(self) -> int:
        """The paper's bandwidth accounting: 1x for R or W, 2x for RW/INC,
        over the iteration box (useful-byte convention, §5.1)."""
        box = 1
        for a, b in self.range_:
            box *= b - a
        total = 0
        for arg in self.args:
            mult = 2 if (arg.mode.reads and arg.mode.writes) else 1
            total += mult * box * arg.dat.dtype.itemsize
        return total

    def flops(self, flops_per_point: Optional[int] = None) -> int:
        fpp = flops_per_point if flops_per_point is not None else 8 * len(self.args)
        box = 1
        for a, b in self.range_:
            box *= b - a
        return fpp * box
