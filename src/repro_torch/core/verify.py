"""Static verification of Plan IR instruction streams.

The paper's correctness rests on bookkeeping that is easy to get subtly
wrong: §4.1 transfer elision, skewed skirt extents, dirty-row retirement,
and (since the mesh redesign) halo-exchange gating.  The mesh redesign
proved the point with two silent data-corruption hazards — a warm-upload clobber (a
segmented chain's full-width download overwriting home halo columns with
zero-initialised slot rows) and a stale cross-segment cyclic elision (a
dead-temporary elision applied to a dataset the next chain still reads).
Both are *plan-level* defects: they are visible in the instruction stream
before a single byte moves.

:func:`verify_plan` abstract-interprets one plan's op stream with no data
plane, tracking per-dataset, per-row-interval state across four locations:

* **slots** — which rows of which dataset are *valid* (staged, written or
  carried in) and which are *dirty* (written, writeback still owed) in each
  slot of the pool, mirroring the runtime
  :class:`~repro_torch.core.transfer.ResidencyManager` invariants;
* **home** — which home rows are *stale* (their authoritative copy lives in
  a slot) and which were retired by elision (never written back);
* **the disk tier** — which rows a ``spill_home`` plan fetched into host
  RAM ahead of their staging read;
* **the mesh** — how deep into the halo skirt the stream actually reaches,
  checked against the declared exchange depth.

On top of the state machine it rebuilds the transfer-lane dependency graph
the interpreters would wire (upload FIFO, per-slot reuse fences,
download-after-compute, spill-after-download, fetch-before-upload,
pack → exchange → unpack → first staging upload) and reports ordering
violations — a download submitted before its tile's compute, a spill whose
download handle does not exist, a halo exchange that no longer gates the
chain's first upload — as race/missing-dependency diagnostics, plus cycle
detection over the assembled graph.

Diagnostics are typed (:class:`Diagnostic`: severity, category, op index,
dataset, interval) and collected into a :class:`VerifyResult`.
``error``-severity findings mean executing the plan can corrupt data or
deadlock; ``warn`` findings are suspicious but survivable (e.g. a
``spill_home`` staging read with no disk prefetch ahead of it).

:func:`verify_plans` verifies a whole chain set (what ``Session.plan()``
returns) and additionally cross-checks sharded per-device plans for
exchange consistency: uniform depth, per-device message counts matching
the device's neighbour count.

Copied from ``src/repro/core/verify.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .plan import (
    CarryEdge,
    Compute,
    Download,
    Elide,
    Evict,
    FetchHome,
    HaloExchange,
    HaloPack,
    HaloUnpack,
    PinUpload,
    Plan,
    PlanOp,
    Prefetch,
    SpillHome,
    Upload,
    WritebackPinned,
)

Ivs = Tuple[Tuple[int, int], ...]   # merged half-open row intervals

ERROR = "error"
WARN = "warn"

#: Every category the verifier can emit, for documentation and tests.
CATEGORIES: Tuple[str, ...] = (
    "stale-read",          # upload/prefetch reads home rows owned by a slot
    "uninit-download",     # download of rows never staged nor written
    "uninit-read",         # carry of rows never staged nor written
    "dirty-loss",          # dirty rows dropped (slot reuse / chain end / clobber)
    "illegal-elide",       # elision outside the §4.1 Cyclic contract
    "slot-conflict",       # op's slot disagrees with the pool's FIFO order
    "missing-op",          # a tile lost its upload or compute
    "duplicate-op",        # a tile acquired/computed twice
    "missing-dep",         # lane ordering violated (race at execution time)
    "unreachable-handle",  # an op's dependency handle never exists
    "halo-order",          # pack/exchange/unpack misordered vs staging
    "halo-depth",          # exchange depth < consumed skirt
    "halo-missing",        # skirt consumed but no exchange in the stream
    "exchange-mismatch",   # per-device exchange annotations disagree
    "pinned-conflict",     # dataset both pinned and staged/tiled
    "disk-unfetched",      # spill_home staging read with no FetchHome ahead
    "disk-unspilled",      # spill_home download never retired to disk
    "unknown-dataset",     # op names a dataset absent from plan.row_bytes
    "cycle",               # dependency graph has a cycle (deadlock)
)


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, anchored to an op in the stream.

    ``op_index`` is the index into ``plan.ops`` (-1 for plan-level findings
    such as end-of-chain dirty rows); ``plan_index`` identifies the plan
    within a multi-chain/multi-device verification."""

    severity: str                   # ERROR | WARN
    category: str                   # one of CATEGORIES
    op_index: int
    message: str
    dataset: Optional[str] = None
    interval: Optional[Tuple[int, int]] = None
    plan_index: int = 0

    def __str__(self) -> str:
        where = f"op {self.op_index}" if self.op_index >= 0 else "plan"
        tgt = ""
        if self.dataset is not None:
            tgt = f" {self.dataset}"
            if self.interval is not None:
                tgt += f"[{self.interval[0]}:{self.interval[1]})"
        return (f"{self.severity}[{self.category}] plan {self.plan_index} "
                f"{where}:{tgt} {self.message}")


class PlanVerificationError(RuntimeError):
    """A plan failed verification with error-severity diagnostics."""

    def __init__(self, result: "VerifyResult", context: str = "plan"):
        self.result = result
        errs = result.errors
        lines = [f"{context} failed verification "
                 f"({len(errs)} error(s), {len(result.warnings)} warning(s)):"]
        lines += [f"  {d}" for d in errs[:8]]
        if len(errs) > 8:
            lines.append(f"  ... and {len(errs) - 8} more")
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class VerifyResult:
    """All diagnostics from verifying one plan (or a whole chain set)."""

    diagnostics: Tuple[Diagnostic, ...]
    plans: int = 1
    ops: int = 0

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == WARN)

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings allowed)."""
        return not self.errors

    def summary(self) -> str:
        head = (f"verify: {self.plans} plan(s), {self.ops} ops, "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
        if not self.diagnostics:
            return head + " — clean"
        return "\n".join([head] + [f"  {d}" for d in self.diagnostics])

    def raise_for_errors(self, context: str = "plan") -> None:
        if self.errors:
            raise PlanVerificationError(self, context)


def merge_results(results: Sequence[VerifyResult]) -> VerifyResult:
    """Fold several results into one (diagnostics concatenated in order)."""
    diags: List[Diagnostic] = []
    ops = 0
    for r in results:
        diags.extend(r.diagnostics)
        ops += r.ops
    return VerifyResult(diagnostics=tuple(diags),
                        plans=sum(r.plans for r in results), ops=ops)


# -- merged-interval algebra --------------------------------------------------------


def _merge(ivs: Sequence[Tuple[int, int]]) -> Ivs:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted((lo, hi) for lo, hi in ivs if hi > lo):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _add(a: Ivs, lo: int, hi: int) -> Ivs:
    return _merge(list(a) + [(lo, hi)])


def _sub(a: Ivs, lo: int, hi: int) -> Ivs:
    out: List[Tuple[int, int]] = []
    for alo, ahi in a:
        if ahi <= lo or alo >= hi:
            out.append((alo, ahi))
            continue
        if alo < lo:
            out.append((alo, lo))
        if ahi > hi:
            out.append((hi, ahi))
    return tuple(out)


def _inter(a: Ivs, lo: int, hi: int) -> Ivs:
    return tuple((max(alo, lo), min(ahi, hi)) for alo, ahi in a
                 if max(alo, lo) < min(ahi, hi))


def _uncovered(a: Ivs, lo: int, hi: int) -> Ivs:
    """The parts of ``[lo, hi)`` NOT covered by ``a``."""
    gaps: List[Tuple[int, int]] = []
    cur = lo
    for alo, ahi in a:
        if ahi <= lo or alo >= hi:
            continue
        if alo > cur:
            gaps.append((cur, min(alo, hi)))
        cur = max(cur, ahi)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return tuple(gaps)


# -- the dependency graph -----------------------------------------------------------


def find_cycle(num_nodes: int,
               edges: Sequence[Tuple[int, int]]) -> Optional[List[int]]:
    """Return one cycle (as a node list) in the directed graph, or None.

    Used on the rebuilt transfer-lane dependency graph: a cycle means the
    engine's workers would deadlock waiting on each other's handles.
    """
    succ: Dict[int, List[int]] = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    state = [0] * num_nodes          # 0 unvisited / 1 on stack / 2 done
    stack: List[int] = []

    def visit(n: int) -> Optional[List[int]]:
        state[n] = 1
        stack.append(n)
        for m in succ.get(n, ()):
            if state[m] == 1:
                return stack[stack.index(m):] + [m]
            if state[m] == 0:
                cyc = visit(m)
                if cyc is not None:
                    return cyc
        stack.pop()
        state[n] = 2
        return None

    for n in range(num_nodes):
        if state[n] == 0:
            cyc = visit(n)
            if cyc is not None:
                return cyc
    return None


# -- per-slot abstract state --------------------------------------------------------


@dataclass
class _SlotState:
    tile: Optional[int] = None
    valid: Dict[str, Ivs] = field(default_factory=dict)
    dirty: Dict[str, Ivs] = field(default_factory=dict)
    carried: Dict[str, Ivs] = field(default_factory=dict)  # 1-slot in-place


class _Verifier:
    """One pass over ``plan.ops``; collects diagnostics."""

    def __init__(self, plan: Plan, plan_index: int = 0):
        self.plan = plan
        self.plan_index = plan_index
        self.diags: List[Diagnostic] = []
        self.row_bytes = dict(plan.row_bytes)
        ns = max(1, plan.num_slots)
        self.num_slots = ns
        self.slots = [_SlotState() for _ in range(ns)]
        self.home_stale: Dict[str, Ivs] = {}
        self.elided: Dict[str, Ivs] = {}
        self.pinned: Set[str] = set()
        self.fetched: Dict[int, Dict[str, Ivs]] = {}
        self.acquires = 0
        self.tile_upload: Dict[int, int] = {}     # tile -> op index
        self.tile_compute: Dict[int, int] = {}
        self.tile_download: Dict[int, int] = {}
        self.tile_spill: Dict[int, int] = {}
        self.pack_idx: Optional[int] = None
        self.exchange_idx: Optional[int] = None
        self.exchange_depth: Optional[int] = None
        self.unpack_idx: Optional[int] = None
        self.first_upload_idx: Optional[int] = None
        self.min_row = 0                          # deepest skirt row touched
        self.unknown: Set[str] = set()
        self.edges: List[Tuple[int, int]] = []    # dep graph over op indices

    # -- reporting ------------------------------------------------------------
    def diag(self, severity: str, category: str, idx: int, msg: str,
             dataset: Optional[str] = None,
             interval: Optional[Tuple[int, int]] = None) -> None:
        self.diags.append(Diagnostic(
            severity=severity, category=category, op_index=idx, message=msg,
            dataset=dataset, interval=interval, plan_index=self.plan_index))

    def _known(self, idx: int, name: str) -> bool:
        if name in self.row_bytes:
            return True
        if name not in self.unknown:
            self.unknown.add(name)
            self.diag(ERROR, "unknown-dataset", idx,
                      "op references a dataset absent from plan.row_bytes",
                      dataset=name)
        return False

    def _slot_check(self, idx: int, op: PlanOp, tile: int, slot: int) -> None:
        want = tile % self.num_slots
        if slot != want:
            self.diag(ERROR, "slot-conflict", idx,
                      f"{op.kind} of tile {tile} targets slot {slot}; the "
                      f"round-robin pool puts tile {tile} in slot {want}")

    # -- the abstract interpretation ------------------------------------------
    def run(self) -> VerifyResult:
        handlers = {
            Upload.kind: self.op_upload, Compute.kind: self.op_compute,
            CarryEdge.kind: self.op_carry, Elide.kind: self.op_elide,
            Download.kind: self.op_download, Evict.kind: self.op_evict,
            Prefetch.kind: self.op_prefetch,
            PinUpload.kind: self.op_pin_upload,
            WritebackPinned.kind: self.op_pin_flush,
            FetchHome.kind: self.op_fetch_home,
            SpillHome.kind: self.op_spill_home,
            HaloPack.kind: self.op_halo_pack,
            HaloExchange.kind: self.op_halo_exchange,
            HaloUnpack.kind: self.op_halo_unpack,
        }
        for idx, op in enumerate(self.plan.ops):
            handlers[op.kind](idx, op)
        self.finish()
        return VerifyResult(diagnostics=tuple(self.diags), plans=1,
                            ops=len(self.plan.ops))

    # -- the network stream ---------------------------------------------------
    def op_halo_pack(self, idx: int, op: HaloPack) -> None:
        if self.plan.mesh_devices <= 1:
            self.diag(WARN, "halo-order", idx,
                      "halo-pack in an unsharded plan")
        self.pack_idx = idx

    def op_halo_exchange(self, idx: int, op: HaloExchange) -> None:
        if self.pack_idx is None:
            self.diag(ERROR, "halo-order", idx,
                      "halo-exchange with no halo-pack before it: send "
                      "buffers are not staged")
        else:
            self.edges.append((self.pack_idx, idx))
        if self.first_upload_idx is not None:
            self.diag(ERROR, "halo-order", idx,
                      "halo-exchange after staging began: the chain's first "
                      f"upload (op {self.first_upload_idx}) read skirt rows "
                      "the exchange had not refreshed")
        self.exchange_idx = idx
        self.exchange_depth = op.depth

    def op_halo_unpack(self, idx: int, op: HaloUnpack) -> None:
        if self.exchange_idx is None:
            self.diag(ERROR, "halo-order", idx,
                      "halo-unpack with no halo-exchange before it")
        else:
            self.edges.append((self.exchange_idx, idx))
        if self.first_upload_idx is not None:
            self.diag(ERROR, "halo-order", idx,
                      "halo-unpack after staging began: it no longer gates "
                      "the chain's first upload")
        self.unpack_idx = idx

    # -- pinned residency -----------------------------------------------------
    def op_pin_upload(self, idx: int, op: PinUpload) -> None:
        for name, _nb in op.entries:
            if self._known(idx, name):
                self.pinned.add(name)

    def op_pin_flush(self, idx: int, op: WritebackPinned) -> None:
        for name, _rows, _nb, _w in op.entries:
            if name not in self.pinned:
                self.diag(WARN, "pinned-conflict", idx,
                          "writeback-pinned flushes a dataset no pin-upload "
                          "made resident", dataset=name)

    # -- the disk tier --------------------------------------------------------
    def op_fetch_home(self, idx: int, op: FetchHome) -> None:
        if not self.plan.spill_home:
            self.diag(WARN, "disk-unfetched", idx,
                      f"fetch-home for tile {op.tile} in a plan without "
                      "spill_home: no disk tier is planned")
        if op.tile in self.tile_upload:
            self.diag(ERROR, "missing-dep", idx,
                      f"fetch-home for tile {op.tile} appears after its "
                      f"upload (op {self.tile_upload[op.tile]}): the staging "
                      "read is not gated on the disk prefetch")
        per = self.fetched.setdefault(op.tile, {})
        for name, lo, hi in op.items:
            if self._known(idx, name):
                per[name] = _add(per.get(name, ()), lo, hi)

    def op_spill_home(self, idx: int, op: SpillHome) -> None:
        dl = self.tile_download.get(op.tile)
        if dl is None:
            self.diag(ERROR, "missing-dep", idx,
                      f"spill-home for tile {op.tile} has no download before "
                      "it: the disk lane would retire rows that never landed "
                      "home (its dependency handle does not exist)")
        else:
            self.edges.append((dl, idx))
        self.tile_spill[op.tile] = idx

    # -- staging --------------------------------------------------------------
    def op_upload(self, idx: int, op: Upload) -> None:
        t = op.tile
        self._slot_check(idx, op, t, op.slot)
        if t in self.tile_upload:
            self.diag(ERROR, "duplicate-op", idx,
                      f"tile {t} acquired twice (first at op "
                      f"{self.tile_upload[t]})")
            return
        want = self.acquires % self.num_slots
        if op.slot % self.num_slots != want:
            self.diag(ERROR, "slot-conflict", idx,
                      f"upload of tile {t} is acquisition #{self.acquires}: "
                      f"the FIFO pool returns slot {want}, plan says slot "
                      f"{op.slot} — staged rows would land in the wrong slot")
        self.acquires += 1
        self.tile_upload[t] = idx
        slot = self.slots[op.slot % self.num_slots]
        # Slot reuse: the residency manager refuses to evict dirty rows
        # (except the 1-slot pool, which continues in place after a carry).
        if self.num_slots > 1:
            for name, ivs in slot.dirty.items():
                for lo, hi in ivs:
                    self.diag(ERROR, "dirty-loss", idx,
                              f"tile {t} reuses slot {op.slot} while tile "
                              f"{slot.tile} still owes writeback — dirty "
                              "rows are dropped", dataset=name,
                              interval=(lo, hi))
            slot.valid = {}
            slot.dirty = {}
        else:
            # In-place continuation: only carried rows survive the origin
            # rebase; dirty rows that were not carried are lost.
            new_dirty: Dict[str, Ivs] = {}
            for name, ivs in slot.dirty.items():
                carried = slot.carried.get(name, ())
                kept: List[Tuple[int, int]] = []
                for lo, hi in ivs:
                    for glo, ghi in _uncovered(carried, lo, hi):
                        self.diag(ERROR, "dirty-loss", idx,
                                  f"tile {t} rebases the 1-slot pool but "
                                  "dirty rows were not carried across the "
                                  "origin shift", dataset=name,
                                  interval=(glo, ghi))
                for clo, chi in carried:
                    kept.extend(_inter(ivs, clo, chi))
                if kept:
                    new_dirty[name] = _merge(kept)
            slot.valid = {n: ivs for n, ivs in slot.carried.items()}
            slot.dirty = new_dirty
        slot.carried = {}
        slot.tile = t
        for name, lo, hi in op.items:
            if not self._known(idx, name):
                continue
            self.min_row = min(self.min_row, lo)
            if name in self.pinned:
                self.diag(ERROR, "pinned-conflict", idx,
                          "staged upload of a pinned (whole-array resident) "
                          "dataset", dataset=name, interval=(lo, hi))
            # Stale home read: rows whose authoritative copy is in a slot
            # (written, not yet downloaded) or was discarded by an elision.
            for slo, shi in _inter(self.home_stale.get(name, ()), lo, hi):
                via = ("retired by an earlier elision"
                       if _inter(self.elided.get(name, ()), slo, shi)
                       else "still dirty in a slot")
                self.diag(ERROR, "stale-read", idx,
                          f"upload for tile {t} reads home rows that are "
                          f"stale ({via}) — the upload lane races the "
                          "download lane for these rows", dataset=name,
                          interval=(slo, shi))
            for dlo, dhi in _inter(slot.dirty.get(name, ()), lo, hi):
                self.diag(ERROR, "dirty-loss", idx,
                          "upload overwrites unretired dirty rows in its "
                          "own slot with home data", dataset=name,
                          interval=(dlo, dhi))
            if self.plan.spill_home and name not in self.pinned:
                have = self.fetched.get(t, {}).get(name, ())
                for glo, ghi in _uncovered(have, lo, hi):
                    self.diag(WARN, "disk-unfetched", idx,
                              f"staging read of tile {t} has no fetch-home "
                              "covering it: the upload worker will fault the "
                              "rows in synchronously", dataset=name,
                              interval=(glo, ghi))
            slot.valid[name] = _add(slot.valid.get(name, ()), lo, hi)
        if self.first_upload_idx is None:
            self.first_upload_idx = idx
            if self.unpack_idx is not None:
                self.edges.append((self.unpack_idx, idx))

    # -- compute --------------------------------------------------------------
    def op_compute(self, idx: int, op: Compute) -> None:
        t = op.tile
        self._slot_check(idx, op, t, op.slot)
        if t in self.tile_compute:
            self.diag(ERROR, "duplicate-op", idx,
                      f"tile {t} computed twice (first at op "
                      f"{self.tile_compute[t]})")
            return
        up = self.tile_upload.get(t)
        if up is None:
            self.diag(ERROR, "missing-op", idx,
                      f"compute of tile {t} with no upload before it: the "
                      "tile's slot was never acquired, its staged rows never "
                      "requested")
        else:
            self.edges.append((up, idx))
        self.tile_compute[t] = idx
        slot = self.slots[op.slot % self.num_slots]
        for name, rows in op.writes:
            if not self._known(idx, name):
                continue
            if name in self.pinned:
                self.diag(ERROR, "pinned-conflict", idx,
                          "compute marks slot-dirty rows on a pinned "
                          "dataset (pinned writes are tracked separately)",
                          dataset=name)
                continue
            for lo, hi in rows:
                self.min_row = min(self.min_row, lo)
                slot.dirty[name] = _add(slot.dirty.get(name, ()), lo, hi)
                slot.valid[name] = _add(slot.valid.get(name, ()), lo, hi)
                self.home_stale[name] = _add(
                    self.home_stale.get(name, ()), lo, hi)
                self.elided[name] = _sub(self.elided.get(name, ()), lo, hi)

    # -- edge carry -----------------------------------------------------------
    def op_carry(self, idx: int, op: CarryEdge) -> None:
        t = op.tile
        self._slot_check(idx, op, t, op.slot)
        want_dst = (t + 1) % self.num_slots
        if op.dst_slot != want_dst:
            self.diag(ERROR, "slot-conflict", idx,
                      f"carry of tile {t} targets slot {op.dst_slot}; tile "
                      f"{t + 1} lives in slot {want_dst}")
        cm = self.tile_compute.get(t)
        if cm is None:
            self.diag(ERROR, "missing-dep", idx,
                      f"carry of tile {t} before its compute: the edge rows "
                      "do not exist yet")
        else:
            self.edges.append((cm, idx))
        if self.num_slots > 1 and (t + 1) not in self.tile_upload:
            self.diag(ERROR, "missing-dep", idx,
                      f"carry of tile {t} before tile {t + 1}'s upload "
                      "acquired the destination slot: the copy lands in a "
                      "slot still owned by a previous tile")
        src = self.slots[op.slot % self.num_slots]
        dst = self.slots[op.dst_slot % self.num_slots]
        for name, lo, hi in op.items:
            if not self._known(idx, name):
                continue
            for glo, ghi in _uncovered(src.valid.get(name, ()), lo, hi):
                self.diag(ERROR, "uninit-read", idx,
                          f"carry of tile {t} copies rows that were never "
                          "staged nor written in its slot", dataset=name,
                          interval=(glo, ghi))
            moved = _inter(src.dirty.get(name, ()), lo, hi)
            src.dirty[name] = _sub(src.dirty.get(name, ()), lo, hi)
            if dst is src:
                src.carried[name] = _add(src.carried.get(name, ()), lo, hi)
                for mlo, mhi in moved:
                    src.dirty[name] = _add(src.dirty[name], mlo, mhi)
            else:
                for mlo, mhi in moved:
                    dst.dirty[name] = _add(dst.dirty.get(name, ()), mlo, mhi)
                dst.valid[name] = _add(dst.valid.get(name, ()), lo, hi)

    # -- retire ---------------------------------------------------------------
    def op_elide(self, idx: int, op: Elide) -> None:
        t = op.tile
        self._slot_check(idx, op, t, op.slot)
        slot = self.slots[op.slot % self.num_slots]
        if not self.plan.cyclic:
            self.diag(ERROR, "illegal-elide", idx,
                      "elision in a non-cyclic plan: §4.1 Cyclic was not "
                      "enabled, so every dirty row owes a writeback")
        for name, lo, hi in op.items:
            if not self._known(idx, name):
                continue
            if name in self.plan.keep_live:
                self.diag(ERROR, "illegal-elide", idx,
                          "elision of a keep_live dataset: the chain's "
                          "remainder (or the next segment) still reads it — "
                          "its home copy goes stale exactly like the "
                          "cross-segment cyclic elision hazard",
                          dataset=name, interval=(lo, hi))
            live = _inter(slot.dirty.get(name, ()), lo, hi)
            for glo, ghi in _uncovered(live, lo, hi):
                self.diag(WARN, "illegal-elide", idx,
                          "elision of rows that are not dirty in the slot",
                          dataset=name, interval=(glo, ghi))
            slot.dirty[name] = _sub(slot.dirty.get(name, ()), lo, hi)
            self.elided[name] = _add(self.elided.get(name, ()), lo, hi)
            # home_stale keeps these rows: their home copy was never
            # refreshed, and a later read of it would be stale.

    def op_download(self, idx: int, op: Download) -> None:
        t = op.tile
        self._slot_check(idx, op, t, op.slot)
        cm = self.tile_compute.get(t)
        if cm is None:
            self.diag(ERROR, "missing-dep", idx,
                      f"download of tile {t} before its compute: the "
                      "download lane would ship rows the compute stream has "
                      "not produced (write-read race between streams 0/2)")
        else:
            self.edges.append((cm, idx))
        slot = self.slots[op.slot % self.num_slots]
        self.tile_download[t] = idx
        for name, lo, hi in op.items:
            if not self._known(idx, name):
                continue
            if name in self.pinned:
                self.diag(ERROR, "pinned-conflict", idx,
                          "download of a pinned dataset (pinned rows flush "
                          "once at chain end)", dataset=name,
                          interval=(lo, hi))
            for glo, ghi in _uncovered(slot.valid.get(name, ()), lo, hi):
                self.diag(ERROR, "uninit-download", idx,
                          f"download of tile {t} ships rows that were never "
                          "staged nor written — home rows are clobbered "
                          "with uninitialised slot content (the warm-upload "
                          "hazard)", dataset=name, interval=(glo, ghi))
            slot.dirty[name] = _sub(slot.dirty.get(name, ()), lo, hi)
            self.home_stale[name] = _sub(
                self.home_stale.get(name, ()), lo, hi)

    def op_evict(self, idx: int, op: Evict) -> None:
        self._slot_check(idx, op, op.tile, op.slot)
        if op.tile < self.num_slots:
            self.diag(WARN, "slot-conflict", idx,
                      f"evict for tile {op.tile}, which is the slot pool's "
                      "first pass — nothing to displace")

    # -- speculative prefetch -------------------------------------------------
    def op_prefetch(self, idx: int, op: Prefetch) -> None:
        for name, rows in op.items:
            if not self._known(idx, name):
                continue
            for lo, hi in rows:
                for slo, shi in _inter(self.home_stale.get(name, ()), lo, hi):
                    self.diag(ERROR, "stale-read", idx,
                              "speculative prefetch captures home rows that "
                              "are stale (dirty in a slot or elided)",
                              dataset=name, interval=(slo, shi))

    # -- end of stream --------------------------------------------------------
    def finish(self) -> None:
        plan = self.plan
        # Dirty rows surviving the chain: the exact residency invariant
        # ``ResidencyManager.end_chain`` asserts at runtime.
        for slot in self.slots:
            for name, ivs in slot.dirty.items():
                for lo, hi in ivs:
                    self.diag(ERROR, "dirty-loss", -1,
                              f"chain ends with dirty rows in slot (tile "
                              f"{slot.tile}): written data is never "
                              "downloaded, carried or legally elided",
                              dataset=name, interval=(lo, hi))
        # Per-tile completeness: every tile must acquire and compute.
        for t in range(plan.num_tiles):
            if t not in self.tile_upload:
                self.diag(ERROR, "missing-op", -1,
                          f"tile {t} has no upload op: its slot is never "
                          "acquired")
            if t not in self.tile_compute:
                self.diag(ERROR, "missing-op", -1,
                          f"tile {t} has no compute op")
        # Unreachable handles: deps that never exist anywhere in the stream.
        for t in self.fetched:
            if t not in self.tile_upload:
                self.diag(WARN, "unreachable-handle", -1,
                          f"fetch-home for tile {t} but no upload consumes "
                          "it")
        if self.pack_idx is not None and self.exchange_idx is None:
            self.diag(WARN, "unreachable-handle", -1,
                      "halo-pack staged send buffers but no halo-exchange "
                      "consumes them")
        if self.exchange_idx is not None and self.unpack_idx is None:
            self.diag(WARN, "unreachable-handle", -1,
                      "halo-exchange with no halo-unpack: received rows "
                      "never land in the home skirt")
        # Disk-tier retirement: every download in a spill plan should be
        # pushed out so the host working set stays inside the budget.
        if plan.spill_home:
            for t, dl in self.tile_download.items():
                if t not in self.tile_spill:
                    self.diag(WARN, "disk-unspilled", dl,
                              f"tile {t}'s download is never spilled to the "
                              "disk tier: its rows stay in host RAM")
        # Halo depth vs the consumed skirt.  Rows below 0 on a device with a
        # low neighbour must have been refreshed by the exchange.
        if plan.mesh_devices > 1 and plan.device > 0:
            reach = -self.min_row
            if reach > 0:
                if self.exchange_idx is None:
                    self.diag(ERROR, "halo-missing", -1,
                              f"device {plan.device} consumes {reach} skirt "
                              "row(s) below its shard but the stream has no "
                              "halo-exchange")
                elif self.exchange_depth is not None \
                        and self.exchange_depth < reach:
                    self.diag(ERROR, "halo-depth", self.exchange_idx,
                              f"halo-exchange depth {self.exchange_depth} < "
                              f"consumed skirt {reach}: the deepest staged/"
                              "computed rows were never refreshed")
        # Deadlock check over the rebuilt transfer-lane dependency graph.
        cyc = find_cycle(len(plan.ops), self.edges)
        if cyc is not None:
            self.diag(ERROR, "cycle", cyc[0],
                      "transfer dependency graph has a cycle through ops "
                      f"{cyc}: the lanes would deadlock")


# -- public API ---------------------------------------------------------------------


def verify_plan(plan: Plan, *, plan_index: int = 0) -> VerifyResult:
    """Statically verify one plan's instruction stream.

    Abstract-interprets the op stream with no data plane, checking the
    residency/dirty-row/staleness invariants the runtime enforces (or
    silently relies on), the transfer-lane ordering the interpreters would
    wire, and the halo-exchange depth against the consumed skirt.  Returns
    a :class:`VerifyResult`; ``result.ok`` means no error-severity
    diagnostics."""
    return _Verifier(plan, plan_index).run()


def _exchange_consistency(group: List[Tuple[int, Plan]]) -> List[Diagnostic]:
    """Cross-device checks over one segment's per-device plans."""
    diags: List[Diagnostic] = []
    info: List[Tuple[int, int, Plan, HaloExchange, Optional[HaloPack]]] = []
    for pi, p in group:
        ex = next((op for op in p.ops if isinstance(op, HaloExchange)), None)
        pk = next((op for op in p.ops if isinstance(op, HaloPack)), None)
        if ex is not None:
            info.append((pi, p.device, p, ex, pk))
    if len(info) < 2:
        return diags
    depths = {ex.depth for _, _, _, ex, _ in info}
    if len(depths) > 1:
        for pi, dev, _p, ex, _pk in info:
            diags.append(Diagnostic(
                severity=ERROR, category="exchange-mismatch", op_index=-1,
                message=(f"device {dev} exchanges at depth {ex.depth} but "
                         f"the segment's devices disagree ({sorted(depths)})"
                         " — neighbours would send/receive different row "
                         "counts"), plan_index=pi))
    for pi, dev, p, ex, pk in info:
        if pk is None:
            continue
        sides = (1 if dev > 0 else 0) + (1 if dev < p.mesh_devices - 1 else 0)
        want = len(pk.names) * sides
        if ex.messages != want:
            diags.append(Diagnostic(
                severity=ERROR, category="exchange-mismatch", op_index=-1,
                message=(f"device {dev}/{p.mesh_devices} declares "
                         f"{ex.messages} exchange message(s); "
                         f"{len(pk.names)} dataset(s) x {sides} "
                         f"neighbour(s) = {want}"), plan_index=pi))
    return diags


def verify_plans(plans: Sequence[Plan]) -> VerifyResult:
    """Verify a chain set (``Session.plan()`` output): every plan
    individually, plus exchange consistency across each sharded segment's
    per-device plans."""
    diags: List[Diagnostic] = []
    ops = 0
    for i, p in enumerate(plans):
        r = verify_plan(p, plan_index=i)
        diags.extend(r.diagnostics)
        ops += r.ops
    # Group consecutive mesh plans into segments (device ids restart).
    group: List[Tuple[int, Plan]] = []
    prev_dev = -1
    for i, p in enumerate(plans):
        if p.mesh_devices > 1:
            if group and p.device <= prev_dev:
                diags.extend(_exchange_consistency(group))
                group = []
            group.append((i, p))
            prev_dev = p.device
        else:
            if group:
                diags.extend(_exchange_consistency(group))
                group = []
            prev_dev = -1
    if group:
        diags.extend(_exchange_consistency(group))
    return VerifyResult(diagnostics=tuple(diags), plans=len(plans), ops=ops)
