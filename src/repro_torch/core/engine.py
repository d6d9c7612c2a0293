"""Tile execution engine: runs a chain's loops over slot-resident tensors.

Ported from ``src/repro/core/engine.py``.  The reference compiles one
``jax.jit`` function per tile signature and slices with
``lax.dynamic_slice``; PyTorch runs eagerly, so the port has no compile
cache and slices with plain indexing.  Two differences matter:

* ``lax.dynamic_slice`` silently clamps an out-of-range start, so a wrong
  origin would read the wrong rows without a word.  The port checks every
  slice it takes against the slot's bounds and raises
  :class:`SliceBoundsError` instead.
* The reference updates slots functionally (``dynamic_update_slice``).  The
  port writes in place with slice assignment, and clones a kernel output
  that is a view of a slot tensor (a pure copy loop) before writing
  anything, so one write cannot change a value another write still needs.

Kernels address global grid coordinates; the engine rebases them into
slot-local offsets — Algorithm 1 line 8 ("adjust base pointers of datasets
for virtual position").
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .dataset import torch_dtype
from .dependency import ChainInfo
from .loop import AccessMode, Accessor, ParallelLoop
from .tiling import TilePlan


class SliceBoundsError(IndexError):
    """A tile slice fell outside its slot tensor (the reference would have
    clamped it silently)."""


def _box(arr: torch.Tensor, starts: List[int], sizes: Tuple[int, ...],
         what: str) -> Tuple[slice, ...]:
    idx = []
    for d, (s, n) in enumerate(zip(starts, sizes)):
        if s < 0 or s + n > arr.shape[d]:
            raise SliceBoundsError(
                f"{what}: slice [{s}, {s + n}) of dim {d} outside the slot "
                f"extent [0, {arr.shape[d]})")
        idx.append(slice(s, s + n))
    return tuple(idx)


class _SliceAccessor(Accessor):
    """Accessor over slot tensors for one loop's iteration box."""

    def __init__(self, loop: ParallelLoop, box_sizes, td: int, start_td: int,
                 origins: Dict[str, int], slots: Dict[str, torch.Tensor],
                 halos: Dict[str, Tuple[int, ...]], device: torch.device):
        self._loop = loop
        self._sizes = tuple(box_sizes)
        self.shape = tuple(box_sizes)
        self._td = td
        self._start_td = start_td          # box start in grid coords
        self._origins = origins            # per-dat slot origin
        self._slots = slots
        self._halos = halos                # per-dat halo_lo tuple
        self.device = device

    def coords(self):
        """Global grid coordinates over the box, broadcast to full box shape."""
        lp = self._loop
        nd = lp.block.ndim
        device = self.device
        out = []
        for d in range(nd):
            start = self._start_td if d == self._td else lp.range_[d][0]
            ar = torch.arange(start, start + self._sizes[d], dtype=torch.int32,
                              device=device)
            shape = [1] * nd
            shape[d] = self._sizes[d]
            out.append(ar.reshape(shape).expand(self.shape))
        return tuple(out)

    def __call__(self, name: str, offset: Tuple[int, ...] = None):
        lp = self._loop
        nd = lp.block.ndim
        if offset is None:
            offset = (0,) * nd
        arr = self._slots[name]
        halo_lo = self._halos[name]
        starts = []
        for d in range(nd):
            if d == self._td:
                starts.append(self._start_td + offset[d] - self._origins[name])
            else:
                starts.append(lp.range_[d][0] + offset[d] + halo_lo[d])
        return arr[_box(arr, starts, self._sizes,
                        f"loop {lp.name!r} read of {name!r} at {offset}")]


class TileEngine:
    """Runs one chain's loops tile by tile over slot tensors."""

    def __init__(self, chain: ChainInfo):
        self.chain = chain
        self.td = chain.tiled_dim
        self.halos = {
            name: tuple(h[0] for h in dat.halo) for name, dat in chain.datasets.items()
        }

    def run_tile(
        self,
        tile: TilePlan,
        slots: Dict[str, torch.Tensor],
        origins: Dict[str, int],
    ) -> Dict[str, torch.Tensor]:
        """Run every active loop of ``tile`` in place on ``slots``; returns
        the tile's reduction contributions (tensors on the slots' device)."""
        chain, td, halos = self.chain, self.td, self.halos
        reds: Dict[str, torch.Tensor] = {}
        storages = {a.untyped_storage().data_ptr() for a in slots.values()}
        device = next(iter(slots.values())).device
        for k, lp in enumerate(chain.loops):
            box = tile.loop_ranges[k]
            if box is None:
                continue
            sizes = tuple(b - a for a, b in box)
            start = box[td][0]
            acc = _SliceAccessor(lp, sizes, td, start, origins, slots, halos,
                                device)
            out = lp.kernel(acc)
            if not isinstance(out, dict):
                raise TypeError(f"kernel of {lp.name!r} must return a dict")
            writes = []
            for arg in lp.args:
                if not arg.mode.writes:
                    continue
                name = arg.dat.name
                if name not in out:
                    raise KeyError(f"kernel of {lp.name!r} did not produce {name!r}")
                dst = slots[name]
                vals = torch.as_tensor(out[name], dtype=torch_dtype(arg.dat.dtype),
                                       device=dst.device)
                if tuple(vals.shape) != sizes:
                    raise ValueError(
                        f"kernel of {lp.name!r}: {name!r} shape {tuple(vals.shape)} "
                        f"!= box {sizes}"
                    )
                if vals.untyped_storage().data_ptr() in storages:
                    vals = vals.clone()   # a view of a slot: copy before writing
                starts = [start - origins[name] if d == td
                          else lp.range_[d][0] + halos[name][d]
                          for d in range(lp.block.ndim)]
                writes.append((arg, dst[_box(dst, starts, sizes,
                                             f"loop {lp.name!r} write of {name!r}")],
                               vals))
            for arg, view, vals in writes:
                if arg.mode is AccessMode.INC:
                    view.add_(vals)
                else:
                    view.copy_(vals)
            for rspec in lp.reductions:
                if rspec.name not in out:
                    raise KeyError(
                        f"kernel of {lp.name!r} did not produce reduction "
                        f"{rspec.name!r}"
                    )
                contrib = out[rspec.name]
                if rspec.name in reds:
                    reds[rspec.name] = rspec.combine(reds[rspec.name], contrib)
                else:
                    reds[rspec.name] = torch.as_tensor(contrib)
        return reds
