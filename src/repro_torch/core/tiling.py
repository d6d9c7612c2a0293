r"""Skewed tile schedule construction (the paper's §3/§4 core).

Tiles are slabs along one dimension (``tiled_dim``, default 0 — the
outermost/contiguous dimension, so host<->device transfers are contiguous).
Tiles execute left-to-right; within a tile the chain's loops execute in
program order over *shifted* sub-ranges.

Correctness of the uniform skew (σ = chain max read-stencil extent along the
tiled dim, ``shift_k = (n-1-k)·σ`` for loop index k of n):

* RAW — loop j reads data produced by loop i<j at positions up to
  ``end_j + σ = E + (n-1-j)σ + σ ≤ E + (n-1-i)σ = end_i``: already computed
  by loop i *in this tile*.
* WAR — loop j>i overwrites a dat loop i reads.  In tile t+1 loop i reads
  *old* values at positions ≥ ``start_i − σ = E + (n-1-i)σ − σ ≥
  E + (n-1-j)σ = end_j(t)``: loop j in tile t stopped exactly below every
  position tile t+1's loop i still needs (half-open ranges meet exactly at
  j = i+1).

Footprint algebra for out-of-core staging (paper Fig. 2):
  full footprint  F(d,t) = ∪ over accesses of [start+min_off, end+max_off)
  right footprint = F(d,t) \ F(d,t-1)   (new data → upload)
  left  footprint = F(d,t) \ F(d,t+1)   (retired data → download)
  right edge      = F(d,t) ∩ F(d,t+1)   (overlap → device-side copy to next slot)

Copied from ``src/repro/core/tiling.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .dependency import ChainInfo


@dataclass(frozen=True)
class Interval:
    lo: int
    hi: int  # half-open

    @property
    def empty(self) -> bool:
        return self.hi <= self.lo

    @property
    def length(self) -> int:
        return max(0, self.hi - self.lo)

    def clamp(self, lo: int, hi: int) -> "Interval":
        return Interval(max(self.lo, lo), min(self.hi, hi))

    def union(self, other: "Interval") -> "Interval":
        if self.empty:
            return other
        if other.empty:
            return self
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def intersect(self, other: "Interval") -> "Interval":
        return Interval(max(self.lo, other.lo), min(self.hi, other.hi))

    def difference(self, other: "Interval") -> Tuple["Interval", ...]:
        """self \\ other as up to two pieces.  Skewed schedules can produce
        NON-monotone footprints (an early loop runs to the grid end inside
        tile t while tile t+1 only runs late loops that stop short), so both
        the left piece [lo, other.lo) and the right piece [other.hi, hi) can
        be non-empty — dropping the right piece loses written data."""
        if self.empty:
            return ()
        if other.empty or other.hi <= self.lo or other.lo >= self.hi:
            return (self,)
        pieces = []
        if other.lo > self.lo:
            pieces.append(Interval(self.lo, other.lo))
        if other.hi < self.hi:
            pieces.append(Interval(other.hi, self.hi))
        return tuple(pieces)


EMPTY = Interval(0, 0)


@dataclass
class TilePlan:
    """Everything needed to stage and execute one tile."""

    index: int
    # Per loop: the full iteration box for this tile (tiled dim sub-range
    # substituted), or None if the loop's sub-range is empty in this tile.
    loop_ranges: List[Optional[Tuple[Tuple[int, int], ...]]]
    footprint: Dict[str, Interval]            # full footprint per dat (tiled dim)
    upload: Dict[str, Tuple[Interval, ...]]   # right footprint F \ F_prev (new data)
    download: Dict[str, Tuple[Interval, ...]] # left footprint F \ F_next (retired)
    edge_to_next: Dict[str, Interval]         # right edge F ∩ F_next (overlap)

    def work_points(self) -> int:
        total = 0
        for box in self.loop_ranges:
            if box is None:
                continue
            n = 1
            for a, b in box:
                n *= b - a
            total += n
        return total


@dataclass
class TileSchedule:
    chain: ChainInfo
    tiles: List[TilePlan]
    boundaries: List[int]
    # Slot sizing: max footprint length per dat over all tiles (uniform slot
    # arrays keep the jit cache small: interior tiles share one signature).
    max_fp_len: Dict[str, int]

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def slot_bytes(self, exclude: frozenset = frozenset()) -> int:
        """Fast-memory bytes one slot occupies (slab: full extent in the
        non-tiled dims, max footprint in the tiled dim).  ``exclude`` names
        datasets staged outside the slot pool (pinned: whole-array resident,
        accounted separately by the residency manager)."""
        total = 0
        td = self.chain.tiled_dim
        for name, ln in self.max_fp_len.items():
            if name in exclude:
                continue
            dat = self.chain.datasets[name]
            other = 1
            for d, s in enumerate(dat.padded_shape):
                if d != td:
                    other *= s
            total += ln * other * dat.dtype.itemsize
        return total


def _loop_tiled_range(lp, td: int) -> Tuple[int, int]:
    return lp.range_[td]


def make_tile_schedule(chain: ChainInfo, num_tiles: int,
                       skew: str = "perloop") -> TileSchedule:
    """Build the skewed schedule with ``num_tiles`` slabs along the tiled dim.

    ``skew``: "perloop" (default) accumulates per-loop read extents backwards
    — shift_k = shift_{k+1} + max(e_k, e_{k+1}) — which satisfies both RAW
    (increment_{j-1} >= e_j) and WAR (increment_i >= e_i) for every pair,
    and adds ZERO skew across runs of loops with no tiled-dim reads (y/z
    sweeps in 3-D chains).  "uniform" is the conservative (n-1-k)*sigma slope
    (kept for the EXPERIMENTS.md §Perf comparison).
    """
    td = chain.tiled_dim
    n = chain.num_loops
    sigma = chain.skew_slope

    g_lo = min(_loop_tiled_range(lp, td)[0] for lp in chain.loops)
    g_hi = max(_loop_tiled_range(lp, td)[1] for lp in chain.loops)
    span = g_hi - g_lo
    num_tiles = max(1, min(num_tiles, span))
    # Nominal boundaries (uniform; remainder spread over the first tiles).
    base = span // num_tiles
    rem = span % num_tiles
    boundaries = [g_lo]
    for t in range(num_tiles):
        boundaries.append(boundaries[-1] + base + (1 if t < rem else 0))

    # Per-loop sub-range ends per tile: end_k^t = min(hi_k, E_{t+1} + shift_k).
    if skew == "uniform" or not chain.loop_extents:
        shifts = [(n - 1 - k) * sigma for k in range(n)]
    else:
        e = chain.loop_extents
        shifts = [0] * n
        for k in range(n - 2, -1, -1):
            shifts[k] = shifts[k + 1] + max(e[k], e[k + 1])
    ends: List[List[int]] = []  # [tile][loop]
    for t in range(num_tiles):
        row = []
        for k, lp in enumerate(chain.loops):
            lo_k, hi_k = _loop_tiled_range(lp, td)
            if t == num_tiles - 1:
                row.append(hi_k)
            else:
                row.append(max(lo_k, min(hi_k, boundaries[t + 1] + shifts[k])))
        ends.append(row)

    # Assemble tiles with footprints.
    raw_fps: List[Dict[str, Interval]] = []
    tiles: List[TilePlan] = []
    for t in range(num_tiles):
        loop_ranges: List[Optional[Tuple[Tuple[int, int], ...]]] = []
        fp: Dict[str, Interval] = {}
        for k, lp in enumerate(chain.loops):
            lo_k, _ = _loop_tiled_range(lp, td)
            start = lo_k if t == 0 else ends[t - 1][k]
            end = ends[t][k]
            if end <= start:
                loop_ranges.append(None)
                continue
            box = list(lp.range_)
            box[td] = (start, end)
            loop_ranges.append(tuple(box))
            for arg in lp.args:
                blo, bhi = arg.dat.bounds(td)
                if arg.mode.reads:
                    mn, mx = arg.stencil.extent(td)
                    iv = Interval(start + mn, end + mx).clamp(blo, bhi)
                else:
                    iv = Interval(start, end).clamp(blo, bhi)
                cur = fp.get(arg.dat.name, EMPTY)
                fp[arg.dat.name] = cur.union(iv)
        raw_fps.append(fp)
        tiles.append(
            TilePlan(
                index=t,
                loop_ranges=loop_ranges,
                footprint=fp,
                upload={},
                download={},
                edge_to_next={},
            )
        )

    # Pass-through closure: a row written in tile t1 and read again in tile
    # t2 > t1 must stay slot-resident through every intermediate tile (edge
    # copies are the only transport for write-first data).  Close each dat's
    # footprint sequence so f'(t) ⊇ f(t) ∪ (hull_past(t) ∩ hull_future(t));
    # this restores interval-monotone coverage even when early loops finish
    # the grid inside one tile (non-monotone raw footprints).
    all_names = sorted({n for fp in raw_fps for n in fp})
    for name in all_names:
        seq = [fp.get(name, EMPTY) for fp in raw_fps]
        # prefix hulls
        pre: List[Interval] = []
        cur = EMPTY
        for f in seq:
            cur = cur.union(f)
            pre.append(cur)
        suf: List[Interval] = [EMPTY] * len(seq)
        cur = EMPTY
        for i in range(len(seq) - 1, -1, -1):
            cur = cur.union(seq[i])
            suf[i] = cur
        for t, f in enumerate(seq):
            passthrough = pre[t].intersect(suf[t + 1]) if t + 1 < len(seq) else EMPTY
            closed = f.union(passthrough) if not passthrough.empty else f
            if not closed.empty:
                raw_fps[t][name] = closed
                tiles[t].footprint[name] = closed

    # Footprint set algebra → upload / download / edge regions.
    for t, tile in enumerate(tiles):
        prev_fp = raw_fps[t - 1] if t > 0 else {}
        next_fp = raw_fps[t + 1] if t + 1 < num_tiles else {}
        for name, f in tile.footprint.items():
            if f.empty:
                continue
            pf = prev_fp.get(name, EMPTY)
            nf = next_fp.get(name, EMPTY)
            # upload: F \ F_prev — the overlap arrives via the edge copy.
            tile.upload[name] = f.difference(pf)
            # download: F \ F_next, clipped to rows the chain actually writes
            # (beyond-paper precision: never ship unwritten rows home — and
            # never clobber home with slot rows the chain only read).
            written = chain.written.get(name, [])
            pieces = []
            for piece in f.difference(nf):
                for wlo, whi in written:
                    clipped = piece.clamp(wlo, whi)
                    if not clipped.empty:
                        pieces.append(clipped)
            tile.download[name] = tuple(pieces)
            # right edge: overlap with next tile (device-side copy).
            tile.edge_to_next[name] = f.intersect(nf) if not nf.empty else EMPTY

    max_fp_len = {}
    for fp in raw_fps:
        for name, iv in fp.items():
            max_fp_len[name] = max(max_fp_len.get(name, 0), iv.length)

    return TileSchedule(chain=chain, tiles=tiles, boundaries=boundaries, max_fp_len=max_fp_len)


def choose_num_tiles(
    chain: ChainInfo,
    capacity_bytes: int,
    num_slots: int = 3,
    max_tiles: int = 4096,
) -> int:
    """Smallest tile count whose slots fit ``capacity_bytes`` of fast memory.

    Mirrors the paper's 'tile sizes set according to the size of the stacked
    memory'.  Returns 1 if the whole problem fits (no out-of-core needed).
    """
    if num_slots * make_tile_schedule(chain, 1).slot_bytes() <= capacity_bytes:
        return 1
    lo, hi = 1, max_tiles
    # slot_bytes is monotonically non-increasing in num_tiles; binary search.
    while lo < hi:
        mid = (lo + hi) // 2
        sched = make_tile_schedule(chain, mid)
        if num_slots * sched.slot_bytes() <= capacity_bytes:
            hi = mid
        else:
            lo = mid + 1
    sched = make_tile_schedule(chain, lo)
    if num_slots * sched.slot_bytes() > capacity_bytes:
        raise MemoryError(
            f"chain cannot fit: even {lo} tiles need "
            f"{num_slots * sched.slot_bytes()} bytes > capacity {capacity_bytes} "
            f"(skew span too large or non-tiled extent too big)"
        )
    return lo
