"""Fast-memory residency management for the out-of-core executor.

Replaces the executor's ad-hoc ``t % num_slots`` arithmetic with an explicit,
checkable model of what occupies fast memory:

* **LRU slot pool** — ``acquire()`` hands out the least-recently-used slot;
  with tiles arriving in order this degenerates to the paper's round-robin,
  but the invariant is now *enforced*: a slot may not be reused while it
  still holds dirty rows that were neither written back, carried to the next
  slot by an edge copy, nor elided (§4.1 Cyclic).
* **Dirty-range tracking** — per-slot, per-dataset merged row intervals
  written on device but not yet home.  Edge copies ``carry`` responsibility
  forward; downloads ``writeback``; Cyclic ``elide``s.  ``end_chain``
  asserts nothing dirty survives — the executor bug-detector the inline
  code never had.
* **Pinned datasets** — small/hot datasets kept device-resident *across*
  chains (keyed by dataset identity + version), skipping per-tile staging
  entirely; written pinned data flushes home once per chain.
* **Capacity accounting** — ``check_fit`` is the single place fast-memory
  budget is enforced; both the real execution path and the executor's
  MemoryError chain-splitting logic consult it.

The manager works in grid-row intervals along the tiled dimension (byte
accounting stays in the executor, which knows row byte-widths).

Copied from ``src/repro/core/transfer/residency.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.  One addition:
``check_fit`` also charges the tile function's workspace
(:mod:`repro_torch.core.workspace`), which the reference's one XLA program
per tile does not need.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# One interval algebra for the whole runtime: the dependency analyser owns
# the merged-half-open-list helpers; only intersection is new here.
from ..dependency import _merge, _subtract

Intervals = List[Tuple[int, int]]  # merged, half-open


def _intersect(a: Intervals, b: Intervals) -> Intervals:
    out: Intervals = []
    for lo, hi in a:
        for blo, bhi in b:
            ilo, ihi = max(lo, blo), min(hi, bhi)
            if ihi > ilo:
                out.append((ilo, ihi))
    return _merge(out)


@dataclass
class Slot:
    """One fast-memory staging slot (arrays are executor-owned)."""

    index: int
    arrays: Dict[str, Any] = field(default_factory=dict)
    origins: Dict[str, int] = field(default_factory=dict)
    # Guards functional read-modify-write of ``arrays`` entries: the upload
    # worker and the main thread's edge copy touch disjoint *regions* but the
    # same dict slot, so the compose step must be atomic per entry.
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    dirty: Dict[str, Intervals] = field(default_factory=dict)
    used: bool = False   # handed out at least once (reuse == eviction)

    def dirty_rows(self) -> int:
        return sum(hi - lo for ivs in self.dirty.values() for lo, hi in ivs)


class ResidencyError(RuntimeError):
    """A residency invariant was violated (an executor bug, not user error)."""


class ResidencyManager:
    """LRU slot pool + dirty tracking + pinned cache + capacity accounting."""

    def __init__(self, capacity_bytes: float, num_slots: int,
                 pinned: frozenset = frozenset()):
        self.capacity_bytes = float(capacity_bytes)
        self.num_slots = int(num_slots)
        self.pinned = frozenset(pinned)
        self._lru: "OrderedDict[int, Slot]" = OrderedDict()
        # name -> (dataset id, dataset version, device array, origin row)
        self._pinned_cache: Dict[str, Tuple[int, int, Any, int]] = {}
        # Pending home accesses this chain: name -> [(lo, hi, handle)].
        # Uploads *read* home rows, downloads *write* them; either side must
        # wait on earlier-submitted overlapping accesses of the other kind.
        self._home_writes: Dict[str, List[Tuple[int, int, Any]]] = {}
        self._home_reads: Dict[str, List[Tuple[int, int, Any]]] = {}
        self.stats: Dict[str, float] = {
            "acquires": 0, "evictions": 0, "writeback_rows": 0,
            "carried_rows": 0, "elided_rows": 0, "pinned_hits": 0,
            "pinned_uploads": 0, "peak_required_bytes": 0,
            "peak_home_bytes": 0, "host_overflow_bytes": 0,
        }

    # -- capacity accounting (the oracle for BOTH memory tiers) --------------
    # Fast tier: overflow is a hard MemoryError the executor answers by
    # splitting the chain.  Host tier: overflow is *plannable* — the planner
    # answers it with FetchHome/SpillHome ops against the disk-backed store —
    # so ``host_overflow`` returns a verdict instead of raising.
    def required_bytes(self, slot_bytes: int, pinned_bytes: int = 0,
                       workspace_bytes: int = 0) -> int:
        return (self.num_slots * int(slot_bytes) + int(pinned_bytes)
                + int(workspace_bytes))

    def check_fit(self, slot_bytes: int, pinned_bytes: int = 0,
                  workspace_bytes: int = 0) -> int:
        """Raise ``MemoryError`` when the plan cannot be fast-memory resident
        (the fast-tier half of the oracle; :meth:`host_overflow` is the host
        tier's)."""
        req = self.required_bytes(slot_bytes, pinned_bytes, workspace_bytes)
        self.stats["peak_required_bytes"] = max(
            self.stats["peak_required_bytes"], req)
        if req > self.capacity_bytes:
            raise MemoryError(
                f"{self.num_slots} slots x {int(slot_bytes)}B"
                + (f" + {int(pinned_bytes)}B pinned" if pinned_bytes else "")
                + (f" + {int(workspace_bytes)}B tile workspace"
                   if workspace_bytes else "")
                + f" exceed fast capacity {int(self.capacity_bytes)}B; "
                f"increase num_tiles")
        return req

    def host_overflow(self, home_bytes: int,
                      host_capacity: Optional[float] = None) -> bool:
        """Host-tier verdict: ``True`` when the chain's dataset home copies
        exceed host RAM, so the planner must emit ``FetchHome``/``SpillHome``
        ops and route the overflow through the disk-backed store."""
        cap = float("inf") if host_capacity is None else float(host_capacity)
        home_bytes = int(home_bytes)
        self.stats["peak_home_bytes"] = max(
            self.stats["peak_home_bytes"], home_bytes)
        over = home_bytes > cap
        if over:
            self.stats["host_overflow_bytes"] = max(
                self.stats["host_overflow_bytes"], int(home_bytes - cap))
        return over

    # -- chain lifecycle ------------------------------------------------------
    def begin_chain(self, num_slots: Optional[int] = None) -> List[Slot]:
        """(Re)build the slot pool for one chain; returns the slots."""
        n = self.num_slots if num_slots is None else int(num_slots)
        self._lru = OrderedDict((i, Slot(index=i)) for i in range(n))
        self._home_writes = {}
        self._home_reads = {}
        return list(self._lru.values())

    def acquire(self) -> Slot:
        """Hand out the least-recently-used slot for the next tile.

        Reuse of a previously-used slot is an *eviction*: its dirty rows must
        already have been written back, carried forward, or elided — enforcing
        Algorithm 1's download-before-reuse ordering.
        """
        if not self._lru:
            raise ResidencyError("acquire() before begin_chain()")
        idx, slot = next(iter(self._lru.items()))
        # A pool of one never *evicts* — the single slot's contents continue
        # into the next tile (edge copies are slot-internal), so carried
        # dirty rows are legitimate there.
        if len(self._lru) > 1 and slot.dirty_rows():  # refuse before touching LRU state
            raise ResidencyError(
                f"slot {slot.index} reused while rows are still dirty "
                f"(no writeback/carry/elide): "
                f"{ {n: ivs for n, ivs in slot.dirty.items() if ivs} }")
        self._lru.move_to_end(idx)
        self.stats["acquires"] += 1
        if slot.used:   # a reuse discards the previous tile's residency
            self.stats["evictions"] += 1
        slot.used = True
        return slot

    def end_chain(self) -> None:
        """Assert the chain retired every dirty row it produced."""
        leaked = {
            (s.index, n): ivs
            for s in self._lru.values() for n, ivs in s.dirty.items() if ivs
        }
        if leaked:
            raise ResidencyError(
                f"chain finished with dirty rows never written back: {leaked}")
        self._lru = OrderedDict()
        self._home_writes = {}
        self._home_reads = {}

    # -- dirty-range tracking -------------------------------------------------
    def mark_dirty(self, slot: Slot, name: str, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        slot.dirty[name] = _merge(slot.dirty.get(name, []) + [(lo, hi)])

    def carry(self, src: Slot, dst: Slot, name: str, lo: int, hi: int) -> None:
        """An edge copy moved rows [lo, hi) of ``name`` to the next slot:
        responsibility for their eventual writeback moves with them."""
        if hi <= lo:
            return
        moved = _intersect(src.dirty.get(name, []), [(lo, hi)])
        if not moved:
            return
        src.dirty[name] = _subtract(src.dirty.get(name, []), moved)
        dst.dirty[name] = _merge(dst.dirty.get(name, []) + moved)
        self.stats["carried_rows"] += sum(b - a for a, b in moved)

    def writeback(self, slot: Slot, name: str, lo: int, hi: int,
                  handle: Any = None) -> None:
        """A download of rows [lo, hi) was submitted: they are no longer the
        slot's responsibility.  ``handle`` (if any) is recorded so a later
        upload reading the same home rows can wait for the write to land."""
        if hi <= lo:
            return
        cleared = _intersect(slot.dirty.get(name, []), [(lo, hi)])
        slot.dirty[name] = _subtract(slot.dirty.get(name, []), [(lo, hi)])
        self.stats["writeback_rows"] += sum(b - a for a, b in cleared)
        if handle is not None:
            self._home_writes.setdefault(name, []).append((lo, hi, handle))

    def elide(self, slot: Slot, name: str, lo: int, hi: int) -> None:
        """§4.1 Cyclic: rows [lo, hi) are a dead temporary — clean without
        traffic (the elision is the optimisation; the bookkeeping stays)."""
        if hi <= lo:
            return
        cleared = _intersect(slot.dirty.get(name, []), [(lo, hi)])
        slot.dirty[name] = _subtract(slot.dirty.get(name, []), [(lo, hi)])
        self.stats["elided_rows"] += sum(b - a for a, b in cleared)

    def home_conflicts(self, name: str, lo: int, hi: int) -> List[Any]:
        """Handles of pending home writes overlapping rows [lo, hi)."""
        return [h for (wlo, whi, h) in self._home_writes.get(name, ())
                if wlo < hi and lo < whi and h is not None]

    def note_home_read(self, name: str, lo: int, hi: int, handle: Any) -> None:
        """An upload was submitted that reads home rows [lo, hi)."""
        if hi > lo and handle is not None:
            self._home_reads.setdefault(name, []).append((lo, hi, handle))

    def home_read_conflicts(self, name: str, lo: int, hi: int) -> List[Any]:
        """Handles of pending home reads overlapping rows [lo, hi).

        The submission order is upload(t+1) *before* download(t), so a
        download writing rows an earlier-queued upload still has to read must
        wait for that staging read — the mirror of :meth:`home_conflicts`."""
        return [h for (rlo, rhi, h) in self._home_reads.get(name, ())
                if rlo < hi and lo < rhi and h is not None]

    # -- pinned datasets ------------------------------------------------------
    def pinned_lookup(self, dat) -> Optional[Tuple[Any, int]]:
        """Device-resident (array, origin) for ``dat`` if still valid."""
        ent = self._pinned_cache.get(dat.name)
        if ent is None:
            return None
        dat_id, version, array, origin = ent
        if dat_id != id(dat) or version != getattr(dat, "version", 0):
            return None
        self.stats["pinned_hits"] += 1
        return array, origin

    def pinned_store(self, dat, array: Any, origin: int) -> None:
        self._pinned_cache[dat.name] = (
            id(dat), getattr(dat, "version", 0), array, origin)
        self.stats["pinned_uploads"] += 1

    def pinned_update(self, dat, array: Any) -> None:
        """Refresh the cached device array after tiles modified it."""
        ent = self._pinned_cache.get(dat.name)
        if ent is not None:
            self._pinned_cache[dat.name] = (ent[0], ent[1], array, ent[3])

    def pinned_mark_flushed(self, dat) -> None:
        """Home copy now matches the device copy (post chain-end download)."""
        ent = self._pinned_cache.get(dat.name)
        if ent is not None:
            self._pinned_cache[dat.name] = (
                ent[0], getattr(dat, "version", 0), ent[2], ent[3])

    def pinned_bytes(self) -> int:
        return sum(getattr(e[2], "nbytes", 0) for e in self._pinned_cache.values())
