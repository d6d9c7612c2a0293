"""Tile execution engine: runs a chain's loops over slot-resident tensors.

Ported from ``src/repro/core/engine.py``.  The reference compiles one
``jax.jit`` function per tile signature and slices with
``lax.dynamic_slice``, the tile's starts and slot origins entering as traced
``int32`` scalars.  The port's tile function is eager torch ops; on a CUDA
device :class:`~repro_torch.core.tile_graph.TileGraphs` captures it as CUDA
graphs, the counterpart of that ``jax.jit``.  The function is split the same
way as the reference's:

* the host side — :meth:`TileEngine.signature` (the reference's compile-cache
  key), :meth:`TileEngine.graph_key` (the signature plus every slot-local
  offset and the identity of every tensor the tile runs on), the bounds
  checks and the clone-of-a-view decisions;
* the device part, :meth:`TileEngine.tile_fn`, which is what a graph
  captures: slices at slot-local offsets (fixed by the key), and the tiled
  dim's start, which ``coords()`` reads, as a 0-d ``int32`` device tensor
  (the reference's traced scalar).  Nothing in it copies to the host.

The bounds checks and clone decisions are host Python inside
``tile_fn``: they run on every eager call and at a capture, and read nothing
the graph key does not hold, so a replay is always a tile whose checks
passed.  :meth:`TileEngine.run_tile` is the eager tile function.

Two differences from the reference matter:

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

from typing import Callable, Dict, List, Tuple

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


# The tiled dim's start of loop ``k`` as a 0-d int32 tensor on the device:
# ``start_t(k, start)``.
StartTensor = Callable[[int, int], torch.Tensor]


class _SliceAccessor(Accessor):
    """Accessor over slot tensors for one loop's iteration box."""

    def __init__(self, loop: ParallelLoop, box_sizes, td: int, start_td: int,
                 origins: Dict[str, int], slots: Dict[str, torch.Tensor],
                 halos: Dict[str, Tuple[int, ...]], device: torch.device,
                 start_t: Callable[[], torch.Tensor]):
        self._loop = loop
        self._sizes = tuple(box_sizes)
        self.shape = tuple(box_sizes)
        self._td = td
        self._start_td = start_td          # box start in grid coords
        self._start_t = start_t            # the same start, a 0-d device tensor
        self._origins = origins            # per-dat slot origin
        self._slots = slots
        self._halos = halos                # per-dat halo_lo tuple
        self.device = device

    def coords(self):
        """Global grid coordinates over the box, broadcast to full box shape.
        The tiled dim's start comes from the 0-d start tensor, so a captured
        graph reads each replay's own start."""
        lp = self._loop
        nd = lp.block.ndim
        device = self.device
        out = []
        for d in range(nd):
            if d == self._td:
                ar = torch.arange(self._sizes[d], dtype=torch.int32,
                                  device=device) + self._start_t()
            else:
                start = lp.range_[d][0]
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


def _fresh_start(device: torch.device) -> StartTensor:
    """Start tensors for an eager call: a new one per ``coords()`` (a fill
    launch, no host copy)."""
    return lambda k, start: torch.full((), start, dtype=torch.int32, device=device)


class TileEngine:
    """Runs one chain's loops tile by tile over slot tensors."""

    def __init__(self, chain: ChainInfo):
        self.chain = chain
        self.td = chain.tiled_dim
        self.halos = {
            name: tuple(h[0] for h in dat.halo) for name, dat in chain.datasets.items()
        }

    # -- the host side ---------------------------------------------------------
    @staticmethod
    def signature(tile: TilePlan) -> Tuple:
        """The pattern of active loops and their box sizes: the reference's
        compile-cache key (``TileEngine._signature`` there)."""
        return tuple(None if box is None else tuple(b - a for a, b in box)
                     for box in tile.loop_ranges)

    def graph_key(self, tile: TilePlan, slots: Dict[str, torch.Tensor],
                  origins: Dict[str, int]) -> Tuple:
        """What a captured tile function is valid for: the signature, every
        active loop's slot-local offsets and the identity of every tensor
        passed in.  Loop ``k`` reads dataset ``n`` at ``start_k - origin_n``;
        the starts relative to the first active loop's and that loop's start
        relative to every origin fix all of them.  These, the signature, the
        chain's ranges and halos and the tensors' shapes are everything the
        bounds checks and the clone decisions read."""
        starts = [box[self.td][0] for box in tile.loop_ranges if box is not None]
        s0 = starts[0] if starts else 0
        return (self.signature(tile),
                tuple(s - s0 for s in starts),
                tuple(sorted((n, s0 - o) for n, o in origins.items())),
                tuple(sorted((n, id(t), t.data_ptr(), tuple(t.shape))
                             for n, t in slots.items())))

    # -- the tile function -----------------------------------------------------
    def run_tile(
        self,
        tile: TilePlan,
        slots: Dict[str, torch.Tensor],
        origins: Dict[str, int],
    ) -> Dict[str, torch.Tensor]:
        """Run every active loop of ``tile`` in place on ``slots`` eagerly;
        returns the tile's reduction contributions (tensors on the slots'
        device)."""
        device = next(iter(slots.values())).device
        return self.tile_fn(tile, slots, origins, _fresh_start(device))

    def tile_fn(
        self,
        tile: TilePlan,
        slots: Dict[str, torch.Tensor],
        origins: Dict[str, int],
        start_t: StartTensor,
    ) -> Dict[str, torch.Tensor]:
        """The device part: :meth:`run_tile` with loop ``k``'s tiled-dim
        start, where ``coords()`` reads it, from ``start_t(k, start)``."""
        chain, td, halos = self.chain, self.td, self.halos
        reds: Dict[str, torch.Tensor] = {}
        # Storage identity, not ``data_ptr``: every ``meta`` tensor's is 0
        # (the workspace trace, ``core/workspace.py``, runs this on meta).
        storages = {a.untyped_storage()._cdata for a in slots.values()}
        device = next(iter(slots.values())).device
        for k, lp in enumerate(chain.loops):
            box = tile.loop_ranges[k]
            if box is None:
                continue
            sizes = tuple(b - a for a, b in box)
            start = box[td][0]
            acc = _SliceAccessor(lp, sizes, td, start, origins, slots, halos,
                                 device, lambda k=k, start=start: start_t(k, start))
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
                if vals.untyped_storage()._cdata in storages:
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
