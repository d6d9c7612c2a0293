"""Cache-mode / unified-memory execution model (paper §5.2, §5.4).

There is no MCDRAM-as-cache or CUDA page migration on this container, so the
paper's *implicit* memory-management configurations are reproduced with an
explicit page-granular LRU model driven by the exact access streams the
runtime schedules (untiled loop-by-loop, or the skewed tile schedule).

Modes:
  * ``flat_fast``  — everything in fast memory (errors if it can't fit).
  * ``flat_slow``  — everything in slow memory (DDR4-only configuration).
  * ``cache``      — fast memory is an LRU page cache over slow memory (KNL
    cache mode; miss service at slow_bw, hardware-prefetch-friendly).
  * ``um``         — GPU unified memory: page faults serviced one-by-one at
    ``page_fault_latency`` + page/upload-bw (latency-bound, matching §5.4's
    observation that UM throughput is the same on PCIe and NVLink).
  * ``um_prefetch``— UM + bulk ``cudaMemPrefetchAsync``-style moves: misses
    of a loop are batched and moved at link bandwidth with one latency.

Because regions are slabs (dim-0 intervals × full rows), page ranges are
contiguous and the model is exact, not sampled.

Copied from ``src/repro/core/cachesim.py``; its imports are the port's
``dependency``, ``loop``, ``memory`` and ``tiling``.  The times it returns
are a model of ``hw``'s figures, not measurements of a card.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .dependency import ChainInfo, analyze_chain
from .loop import ParallelLoop
from .memory import HardwareModel
from .tiling import make_tile_schedule


@dataclass
class CacheStats:
    mode: str
    time_s: float = 0.0
    useful_bytes: int = 0
    hit_bytes: int = 0
    miss_bytes: int = 0
    writeback_bytes: int = 0
    faults: int = 0

    @property
    def achieved_bw(self) -> float:
        return self.useful_bytes / self.time_s if self.time_s else 0.0

    @property
    def hit_rate(self) -> float:
        tot = self.hit_bytes + self.miss_bytes
        return self.hit_bytes / tot if tot else 1.0


class _LRU:
    """Page cache: key -> dirty flag."""

    def __init__(self, capacity_pages: int):
        self.cap = capacity_pages
        self.pages: "OrderedDict[Tuple[str,int], bool]" = OrderedDict()

    def touch(self, key, dirty: bool) -> Tuple[bool, int]:
        """Returns (hit, evicted_dirty_count_from_insert)."""
        if key in self.pages:
            self.pages[key] = self.pages[key] or dirty
            self.pages.move_to_end(key)
            return True, 0
        evict_dirty = 0
        while len(self.pages) >= self.cap:
            _, was_dirty = self.pages.popitem(last=False)
            evict_dirty += int(was_dirty)
        self.pages[key] = dirty
        return False, evict_dirty


def _access_items(
    loops: Sequence[ParallelLoop], tiled: bool, num_tiles: int, tiled_dim: int = 0
) -> Iterable[Tuple[ParallelLoop, Tuple[Tuple[int, int], ...]]]:
    if not tiled:
        for lp in loops:
            yield lp, lp.range_
        return
    info = analyze_chain(loops, tiled_dim=tiled_dim)
    sched = make_tile_schedule(info, num_tiles)
    for tile in sched.tiles:
        for k, box in enumerate(tile.loop_ranges):
            if box is not None:
                yield info.loops[k], box


def simulate_chain(
    loops: Sequence[ParallelLoop],
    hw: HardwareModel,
    mode: str = "cache",
    tiled: bool = False,
    num_tiles: int = 1,
    tiled_dim: int = 0,
    warmup: bool = True,
) -> CacheStats:
    """Model one chain's steady-state execution time under the given mode.

    ``warmup=True`` (default) replays the access stream once before
    measuring, so cold-start compulsory misses don't pollute the steady-state
    bandwidth (the paper measures many timesteps of a warm working set)."""
    stats = CacheStats(mode=mode)
    total_bytes = sum(d.nbytes for d in analyze_chain(loops).datasets.values())

    if mode == "flat_fast":
        if total_bytes > hw.fast_capacity:
            raise MemoryError(
                f"flat_fast: {total_bytes}B > {hw.fast_capacity}B fast memory "
                "(the paper's segfault)"
            )
        for lp, box in _access_items(loops, tiled, num_tiles, tiled_dim):
            nb = _box_bytes(lp, box)
            stats.useful_bytes += nb
            stats.time_s += nb / hw.dd_bw  # flat MCDRAM/HBM bandwidth
        return stats
    if mode == "flat_slow":
        for lp, box in _access_items(loops, tiled, num_tiles, tiled_dim):
            nb = _box_bytes(lp, box)
            stats.useful_bytes += nb
            stats.time_s += nb / hw.slow_bw
        return stats

    lru = _LRU(max(1, int(hw.fast_capacity // hw.page_bytes)))
    if warmup and mode in ("cache", "um", "um_prefetch"):
        for lp, box in _access_items(loops, tiled, num_tiles, tiled_dim):
            for arg in lp.args:
                lo, hi = _slab_interval(lp, box, arg)
                dat = arg.dat
                row_bytes = dat.nbytes // dat.padded_shape[0]
                b0 = (lo + dat.halo[0][0]) * row_bytes
                b1 = (hi + dat.halo[0][0]) * row_bytes
                p0, p1 = b0 // hw.page_bytes, (max(b1 - 1, b0)) // hw.page_bytes
                for p in range(p0, p1 + 1):
                    lru.touch((dat.name, p), arg.mode.writes)
    for lp, box in _access_items(loops, tiled, num_tiles, tiled_dim):
        nb = _box_bytes(lp, box)
        stats.useful_bytes += nb
        miss_pages = 0
        hit_pages = 0
        wb_pages = 0
        for arg in lp.args:
            lo, hi = _slab_interval(lp, box, arg)
            dat = arg.dat
            row_bytes = dat.nbytes // dat.padded_shape[0]
            b0 = (lo + dat.halo[0][0]) * row_bytes
            b1 = (hi + dat.halo[0][0]) * row_bytes
            p0, p1 = b0 // hw.page_bytes, (max(b1 - 1, b0)) // hw.page_bytes
            for p in range(p0, p1 + 1):
                hit, evicted = lru.touch((dat.name, p), arg.mode.writes)
                wb_pages += evicted
                if hit:
                    hit_pages += 1
                else:
                    miss_pages += 1
        hit_b = hit_pages * hw.page_bytes
        miss_b = miss_pages * hw.page_bytes
        wb_b = wb_pages * hw.page_bytes
        stats.hit_bytes += hit_b
        stats.miss_bytes += miss_b
        stats.writeback_bytes += wb_b
        stats.faults += miss_pages
        if mode == "cache":
            t = nb / hw.fast_bw + (miss_b + wb_b) / hw.slow_bw
        elif mode == "um":
            t = nb / hw.fast_bw + miss_pages * hw.page_fault_latency \
                + (miss_b + wb_b) / hw.up_bw
        elif mode == "um_prefetch":
            # one bulk prefetch per loop; driver CPU overhead per call, and
            # (paper §5.4) prefetch throughput degrades when oversubscribed.
            oversub = total_bytes > hw.fast_capacity
            eff_bw = hw.up_bw * (0.6 if oversub else 1.0)
            t = nb / hw.fast_bw + (hw.page_fault_latency if miss_pages else 0.0) \
                + (miss_b + wb_b) / eff_bw
        else:
            raise ValueError(f"unknown mode {mode!r}")
        stats.time_s += t
    return stats


def _box_bytes(lp: ParallelLoop, box) -> int:
    npts = 1
    for a, b in box:
        npts *= b - a
    full = 1
    for a, b in lp.range_:
        full *= b - a
    return int(lp.bytes_moved() * (npts / full)) if full else 0


def _slab_interval(lp: ParallelLoop, box, arg) -> Tuple[int, int]:
    lo, hi = box[0]
    if arg.mode.reads:
        mn, mx = arg.stencil.extent(0)
        lo, hi = lo + mn, hi + mx
    blo, bhi = arg.dat.bounds(0)
    return max(lo, blo), min(hi, bhi)
