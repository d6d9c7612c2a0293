"""Plan interpreters: one op stream, two execution modes.

:class:`LedgerInterpreter` walks a :class:`~repro_torch.core.plan.Plan` and
produces the modelled timeline — ledger events with the exact three-stream
dependency wiring Algorithm 1 implies (upload FIFO, per-slot reuse fences,
compute chaining, download-after-compute), plus residency bookkeeping so the
dirty-row invariants are enforced even in pure simulation.  This is the
``sim`` backend's whole execution path, and what :meth:`Session.explain`
and the autotuner cost plans with.

:class:`DataPlaneInterpreter` subclasses it and additionally moves real
bytes: slot arrays, staging tasks on the
:class:`~repro_torch.core.transfer.TransferEngine` (coalesced per tile/direction),
codec round-trips with achieved wire bytes patched into the ledger after
drain, edge copies, pinned-array residency, speculative-prefetch capture and
restore, and the :class:`~repro_torch.core.engine.TileEngine` tiles (on
CUDA as CUDA graphs, one set per run: :mod:`repro_torch.core.tile_graph`).

Both interpreters execute the *same* instruction stream — the executor's
old inline ``sim``/real branches are now one code path with data hooks.

Ported from ``src/repro/core/interp.py``: :class:`LedgerInterpreter` is
copied as it is; :class:`DataPlaneInterpreter` is rewritten for torch
tensors on ``device`` and, on CUDA, for the upload and download lanes on
their own CUDA streams beside the compute stream.  The hazards that port
brings are named where they are handled (search for "Hazard").
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .memory import HardwareModel, TransferLedger
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
    Prefetch,
    SpillHome,
    Upload,
    WritebackPinned,
)
from .dataset import torch_dtype
from .store import RamStore
from .tile_graph import TileGraphs, allocating_to, device_lock, drop_pool
from .workspace import one_block
from .tiling import Interval
from .transfer import ResidencyManager, Slot
from .transfer.engine import DISK, DOWN, UP
from ..obs.audit import STREAM_NAMES
from ..obs.tracer import AnyTracer, NULL_TRACER


class _SimArray:
    """Placeholder device array for simulated pinned caching."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)


@dataclass
class SpecState:
    """Cross-chain speculative-prefetch state (owned by the executor).

    ``uploaded``: what the last chain prefetched ({name: (Interval, ...)});
    ``data``: on real data-plane runs, the captured device arrays backing
    those intervals; ``sig``: the plan signature hash the guess came from.
    A hit restores captured data instead of re-staging from home; any
    identity/version mismatch degrades to a miss, never to stale data."""

    uploaded: Dict[str, Tuple[Interval, ...]] = field(default_factory=dict)
    data: Dict[str, list] = field(default_factory=dict)
    sig: Optional[str] = None
    # On CUDA, the memory pool the captured tensors live in, dropped once
    # they are restored (``DataPlaneInterpreter.begin``).
    pool: Any = None


@dataclass
class InterpResult:
    """What one interpreted chain produced (metrics + reductions)."""

    reductions: Dict[str, np.ndarray]
    makespan: float
    uploaded: int
    downloaded: int
    uploaded_wire: int
    downloaded_wire: int
    edge_bytes: int
    prefetch_hits: int
    ledger: TransferLedger
    # Disk tier (FetchHome/SpillHome): modelled raw bytes in sim mode; the
    # executor replaces them with the stores' achieved counters on real runs.
    disk_read: int = 0
    disk_written: int = 0
    # Device mesh (HaloExchange): messages/bytes this device's exchange
    # received, straight from the plan annotations — the sharded executor
    # checks these against the runtime's achieved HaloExchangeStats.
    halo_messages: int = 0
    halo_bytes: int = 0


class LedgerInterpreter:
    """Cost a plan: ledger events + residency bookkeeping, no data plane.

    ``rm``/``spec`` default to throwaway instances (offline plan analysis);
    the executor passes its own so pinned caching and prefetch guessing work
    across chains exactly as on the data plane.  ``datasets`` (optional)
    enables pinned cache lookups keyed by dataset identity/version."""

    def __init__(self, plan: Plan, hw: HardwareModel,
                 rm: Optional[ResidencyManager] = None,
                 spec: Optional[SpecState] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 tracer: Optional[AnyTracer] = None,
                 trace_tag: str = "",
                 chain_index: int = 0):
        self.plan = plan
        self.hw = hw
        self.tracer: AnyTracer = tracer if tracer is not None else NULL_TRACER
        self.trace_tag = trace_tag
        self.chain_index = chain_index
        self.eid_op: Dict[int, int] = {}   # ledger eid -> plan op index (#N)
        self.rm = rm if rm is not None else ResidencyManager(
            capacity_bytes=float("inf"), num_slots=plan.num_slots)
        self.spec = spec if spec is not None else SpecState()
        self.datasets = datasets or {}
        self.ledger = TransferLedger(hw)
        self.row_bytes = dict(plan.row_bytes)
        self.ratios = dict(plan.codec_ratios)
        self.origins: List[Dict[str, int]] = [dict(o) for o in plan.tile_origins]
        # metrics
        self.uploaded = self.downloaded = 0
        self.uploaded_wire = self.downloaded_wire = 0
        self.edge_bytes = 0
        self.prefetch_hits = 0
        self.disk_read = self.disk_written = 0
        self.halo_messages = self.halo_bytes = 0
        self.reductions: Dict[str, np.ndarray] = {}
        # event-id cursors (the four-stream dependency wiring)
        self.last_upload_eid: Optional[int] = None
        self.last_compute_eid: Optional[int] = None
        self.last_download_eid: Dict[int, Optional[int]] = {}
        self.tile_up_eid: Dict[int, int] = {}
        self.compute_eids: Dict[int, int] = {}
        self.tile_slot: Dict[int, Any] = {}
        self.fetch_eids: Dict[int, int] = {}       # tile -> FetchHome event
        self.tile_down_eid: Dict[int, int] = {}    # tile -> Download event
        self._halo_pack_eid: Optional[int] = None
        self._halo_exchange_eid: Optional[int] = None

    # -- byte math over plan annotations --------------------------------------
    def _nbytes(self, name: str, lo: int, hi: int) -> int:
        return max(0, hi - lo) * self.row_bytes[name]

    def _wire(self, name: str, nb: int) -> int:
        return max(1, int(nb / self.ratios[name])) if nb else 0

    # -- dispatch loop --------------------------------------------------------
    _DISPATCH = {
        PinUpload.kind: "op_pin_upload",
        Upload.kind: "op_upload",
        Compute.kind: "op_compute",
        CarryEdge.kind: "op_carry",
        Elide.kind: "op_elide",
        Download.kind: "op_download",
        Evict.kind: "op_evict",
        Prefetch.kind: "op_prefetch",
        WritebackPinned.kind: "op_pin_flush",
        FetchHome.kind: "op_fetch_home",
        SpillHome.kind: "op_spill_home",
        HaloPack.kind: "op_halo_pack",
        HaloExchange.kind: "op_halo_exchange",
        HaloUnpack.kind: "op_halo_unpack",
    }

    # Ops whose ledger events are serviced by staged TransferHandles — their
    # achieved timing is the handle's, emitted as lane spans after drain, so
    # the dispatch span must NOT claim their eids.  Everything else executes
    # inline on the issue thread and the dispatch span is the achieved record.
    _HANDLE_KINDS = frozenset(
        (Upload.kind, Download.kind, FetchHome.kind, SpillHome.kind))

    # Sim mode replays the modelled timeline as spans (the drift-audit oracle
    # case); the data plane emits wall-clock spans instead.
    _trace_modelled = True
    # A traced CUDA data plane times the compute-stream work of an op with a
    # pair of events: the start is recorded once the op's host waits are
    # over (``_device_span_start``), the end after its dispatch.  None here.
    device_spans: Optional[List[Tuple]] = None
    _pending_start: Any = None
    # Extra span args an op's data hook leaves for its spans (the tile's
    # graph mode and host enqueue seconds, traced data-plane runs).
    _span_note: Optional[Dict[str, Any]] = None

    def run(self) -> InterpResult:
        plan = self.plan
        self.spec_valid = (
            plan.prefetch
            and self.spec.sig is not None
            and self.spec.sig == plan.sig_hash
            and bool(self.spec.uploaded)
        )
        self.slots = self.rm.begin_chain(plan.num_slots)
        self.begin()
        if self.tracer.enabled:
            self._run_ops_traced(plan)
        else:
            for op in plan.ops:
                getattr(self, self._DISPATCH[op.kind])(op)
        self.finish()
        self.rm.end_chain()
        res = InterpResult(
            reductions=self.reductions,
            makespan=self.ledger.simulate(),
            uploaded=self.uploaded, downloaded=self.downloaded,
            uploaded_wire=self.uploaded_wire,
            downloaded_wire=self.downloaded_wire,
            edge_bytes=self.edge_bytes, prefetch_hits=self.prefetch_hits,
            ledger=self.ledger,
            disk_read=self.disk_read, disk_written=self.disk_written,
            halo_messages=self.halo_messages, halo_bytes=self.halo_bytes,
        )
        if self.tracer.enabled and self._trace_modelled:
            self._emit_modelled_spans()
        return res

    def _run_ops_traced(self, plan: Plan) -> None:
        """The dispatch loop with span emission: identical op semantics
        (bit-identity with the untraced loop), plus the eid -> op-index map
        both audit rows and modelled spans cite as ``#N``."""
        tr = self.tracer
        tag = self.trace_tag
        ci = self.chain_index
        wall = not self._trace_modelled
        events = self.ledger.events
        cur_tile: Optional[int] = None
        tile_t0 = 0.0
        for i, op in enumerate(plan.ops):
            tile = getattr(op, "tile", None)
            if wall and tile is not None and tile != cur_tile:
                now = tr.clock()
                if cur_tile is not None:
                    tr.emit(f"tile {cur_tile}", cat="tile",
                            track=tag + "tiles", t_start=tile_t0, t_end=now,
                            args={"chain": ci, "tile": cur_tile})
                cur_tile, tile_t0 = tile, now
            n0 = len(events)
            t0 = tr.clock()
            getattr(self, self._DISPATCH[op.kind])(op)
            t1 = tr.clock()
            n1 = len(events)
            for eid in range(n0, n1):
                self.eid_op[eid] = i
            if not wall:
                continue
            args: Dict[str, Any] = {"chain": ci, "op": i}
            if tile is not None:
                args["tile"] = tile
            note, self._span_note = self._span_note, None
            if note:
                args.update(note)
            start, self._pending_start = self._pending_start, None
            if start is not None:
                # Device-timed op: its span on the stream's track comes from
                # the events (``finish``); the host side is dispatch only.
                self.device_spans.append(
                    (op.kind, dict(args, eids=list(range(n0, n1))),
                     events[n0].stream if n1 > n0 else 0,
                     start, self._record(timing=True)))
                track = tag + "dispatch"
            elif op.kind in self._HANDLE_KINDS or n1 == n0:
                track = tag + "dispatch"
            else:
                # Inline op: its dispatch IS the achieved timing for the
                # events it issued — land it on the stream's own track.
                args["eids"] = list(range(n0, n1))
                track = tag + STREAM_NAMES.get(
                    events[n0].stream, f"stream{events[n0].stream}")
            tr.emit(op.kind, cat="op", track=track,
                    t_start=t0, t_end=t1, args=args)
        if wall and cur_tile is not None:
            tr.emit(f"tile {cur_tile}", cat="tile", track=tag + "tiles",
                    t_start=tile_t0, t_end=tr.clock(),
                    args={"chain": ci, "tile": cur_tile})

    def _emit_modelled_spans(self) -> None:
        """Sim mode: replay the simulated ledger timeline as spans — one per
        event at its modelled ``t_start``/``t_end``.  Auditing these against
        the very same ledger must report per-stream drift of exactly 1.0."""
        tr = self.tracer
        tag = self.trace_tag
        ci = self.chain_index
        for ev in self.ledger.events:
            tr.emit(ev.kind, cat="model",
                    track=tag + STREAM_NAMES.get(ev.stream,
                                                 f"stream{ev.stream}"),
                    t_start=ev.t_start, t_end=ev.t_end,
                    args={"chain": ci, "eid": ev.eid,
                          "op": self.eid_op.get(ev.eid, -1),
                          "stream": ev.stream, "bytes": ev.nbytes})

    # -- lifecycle hooks (data plane overrides) -------------------------------
    def begin(self) -> None:
        pass

    def finish(self) -> None:
        pass

    # -- pinned residency -----------------------------------------------------
    def op_pin_upload(self, op: PinUpload) -> None:
        raw = wire = 0
        for name, nb in op.entries:
            r, w = self.pin_ensure(name, nb)
            raw += r
            wire += w
        self.uploaded += raw
        self.uploaded_wire += wire
        if wire:
            deps = ((self.last_upload_eid,)
                    if self.last_upload_eid is not None else ())
            self.last_upload_eid = self.ledger.add(
                1, "upload", wire, self.ledger.t_up(wire), deps)

    def pin_ensure(self, name: str, nb: int) -> Tuple[int, int]:
        """Make ``name`` device-resident; returns (raw, wire) actually moved
        (0, 0 on a cross-chain pinned-cache hit)."""
        dat = self.datasets.get(name)
        if dat is None:   # offline analysis: assume cold
            return nb, self._wire(name, nb)
        hit = self.rm.pinned_lookup(dat)
        if hit is not None:
            return 0, 0
        origin = -dat.halo[self.plan.tiled_dim][0]
        self.rm.pinned_store(dat, _SimArray(dat.nbytes), origin)
        return nb, self._wire(name, nb)

    # -- the disk tier (tiered host storage) ----------------------------------
    def op_fetch_home(self, op: FetchHome) -> None:
        """Disk -> host fetch of tile ``op.tile``'s staging rows: stream-3
        FIFO (positional), no cross-stream deps — the upload that *reads*
        these rows carries the dependency instead."""
        self.disk_read += op.raw
        eid = self.stage_fetch_home(op)
        if eid is not None:
            self.fetch_eids[op.tile] = eid

    def stage_fetch_home(self, op: FetchHome) -> Optional[int]:
        return self.ledger.add(3, "fetch_home", op.raw,
                               self.ledger.t_disk(op.raw), ())

    def op_spill_home(self, op: SpillHome) -> None:
        """Host -> disk retirement: waits for tile ``op.tile``'s download to
        land the rows home, then pushes them out on stream 3."""
        deps = ()
        if self.tile_down_eid.get(op.tile) is not None:
            deps = (self.tile_down_eid[op.tile],)
        self.disk_written += op.raw
        self.stage_spill_home(op, deps)

    def stage_spill_home(self, op: SpillHome,
                         deps: Tuple[int, ...]) -> Optional[int]:
        return self.ledger.add(3, "spill_home", op.raw,
                               self.ledger.t_disk(op.raw), deps)

    # -- the network stream (device-mesh halo exchange) -----------------------
    def op_halo_pack(self, op: HaloPack) -> None:
        """Host-side copy of boundary rows into send buffers: stream 4,
        costed at slow-memory bandwidth."""
        self._halo_pack_eid = self.ledger.add(
            4, "halo_pack", op.nbytes,
            op.nbytes / self.hw.slow_bw if op.nbytes else 0.0, ())

    def op_halo_exchange(self, op: HaloExchange) -> None:
        """The §5.2 once-per-chain accumulated-depth exchange: network event
        after the pack; the data plane additionally runs the real collective
        via :meth:`exec_halo_exchange`."""
        deps = ((self._halo_pack_eid,)
                if self._halo_pack_eid is not None else ())
        self.halo_messages += op.messages
        self.halo_bytes += op.nbytes
        self.exec_halo_exchange(op)
        self._halo_exchange_eid = self.ledger.add(
            4, "halo_exchange", op.nbytes,
            self.ledger.t_net(op.nbytes, op.messages), deps)

    def exec_halo_exchange(self, op: HaloExchange) -> None:
        pass

    def op_halo_unpack(self, op: HaloUnpack) -> None:
        """Received rows land in the home skirt.  The unpack event becomes
        the upload stream's FIFO head (``last_upload_eid``), so the chain's
        first staged upload — which reads those home rows — waits for it."""
        deps = ((self._halo_exchange_eid,)
                if self._halo_exchange_eid is not None else ())
        eid = self.ledger.add(
            4, "halo_unpack", op.nbytes,
            op.nbytes / self.hw.slow_bw if op.nbytes else 0.0, deps)
        self.last_upload_eid = eid

    # -- staging --------------------------------------------------------------
    def spec_lookup(self, name: str,
                    iv: Interval) -> Tuple[Interval, Optional[Any]]:
        """Resolve a speculative-prefetch hit for upload piece ``iv``:
        returns ``(miss_part, restore)`` — the sub-interval still needing a
        home upload, and the restore token (always None without a data
        plane: a modelled hit simply skips the traffic)."""
        for piv in self.spec.uploaded.get(name, ()):
            hit = iv.intersect(piv)
            if hit.empty or hit.lo != iv.lo:
                continue
            self.prefetch_hits += 1
            return Interval(hit.hi, iv.hi), None
        return iv, None

    def op_upload(self, op: Upload) -> None:
        slot = self.rm.acquire()
        org = self.origins[op.tile]
        slot.origins = org
        self.tile_slot[op.tile] = slot
        items: List[Tuple[str, Interval]] = []
        restores: List[Tuple] = []
        raw = 0
        for name, lo, hi in op.items:
            iv = Interval(lo, hi)
            if self.spec_valid and op.tile == 0:
                iv, restore = self.spec_lookup(name, iv)
                if restore is not None:
                    restores.append(restore)
            if iv.empty:
                continue
            raw += self._nbytes(name, iv.lo, iv.hi)
            items.append((name, iv))
        if not raw and not restores:
            return
        up_deps: List[int] = []
        if self.last_download_eid.get(slot.index) is not None:
            up_deps.append(self.last_download_eid[slot.index])  # reuse fence
        if self.last_upload_eid is not None:
            up_deps.append(self.last_upload_eid)                # stream-1 FIFO
        if self.fetch_eids.get(op.tile) is not None:
            up_deps.append(self.fetch_eids[op.tile])  # rows must be in RAM
        eid = self.stage_upload(op, slot, org, items, restores, raw,
                                tuple(up_deps))
        if eid is not None:
            self.tile_up_eid[op.tile] = eid
            self.last_upload_eid = eid

    def stage_upload(self, op: Upload, slot: Slot, org: Dict[str, int],
                     items: List[Tuple[str, Interval]],
                     restores: List[Tuple],
                     raw: int, deps: Tuple[int, ...]) -> Optional[int]:
        self.uploaded += raw
        wire = sum(self._wire(name, self._nbytes(name, iv.lo, iv.hi))
                   for name, iv in items)
        self.uploaded_wire += wire
        return self.ledger.add(1, "upload", wire, self.ledger.t_up(wire), deps)

    # -- compute --------------------------------------------------------------
    def op_compute(self, op: Compute) -> None:
        slot = self.tile_slot[op.tile]
        deps: List[int] = []
        if self.tile_up_eid.get(op.tile) is not None:
            deps.append(self.tile_up_eid[op.tile])
        if self.last_compute_eid is not None:
            deps.append(self.last_compute_eid)
        self.execute_tile(op, slot)
        eid = self.ledger.add(
            0, "compute", op.nbytes,
            self.ledger.t_compute(op.nbytes, op.flops), tuple(deps))
        self.last_compute_eid = eid
        self.compute_eids[op.tile] = eid
        # Residency bookkeeping: rows this tile wrote stay dirty until a
        # download, an edge carry, or a §4.1 elision retires them.
        for name, rows in op.writes:
            for lo, hi in rows:
                self.rm.mark_dirty(slot, name, lo, hi)

    def execute_tile(self, op: Compute, slot: Slot) -> None:
        pass

    # -- edge carry -----------------------------------------------------------
    def op_carry(self, op: CarryEdge) -> None:
        slot = self.tile_slot[op.tile]
        dst = self.tile_slot.get(op.tile + 1)
        if dst is None:     # 1-slot pool: the next tile continues in-place
            dst = slot
        next_org = self.origins[op.tile + 1]
        deps: List[int] = [self.last_compute_eid]
        if self.last_download_eid.get(dst.index) is not None:
            deps.append(self.last_download_eid[dst.index])
        self.copy_edges(op, slot, dst, next_org)
        for name, lo, hi in op.items:
            self.rm.carry(slot, dst, name, lo, hi)
        self.edge_bytes += op.nbytes
        self.last_compute_eid = self.ledger.add(
            0, "edge", op.nbytes, self.ledger.t_dd(2 * op.nbytes), tuple(deps))

    def copy_edges(self, op: CarryEdge, slot: Slot, dst: Slot,
                   next_org: Dict[str, int]) -> None:
        pass

    # -- retire ---------------------------------------------------------------
    def op_elide(self, op: Elide) -> None:
        slot = self.tile_slot[op.tile]
        for name, lo, hi in op.items:
            self.rm.elide(slot, name, lo, hi)

    def op_download(self, op: Download) -> None:
        slot = self.tile_slot[op.tile]
        deps = (self.compute_eids[op.tile],)
        self.downloaded += op.raw
        eid = self.stage_download(op, slot, deps)
        self.last_download_eid[slot.index] = eid
        self.tile_down_eid[op.tile] = eid

    def stage_download(self, op: Download, slot: Slot,
                       deps: Tuple[int, ...]) -> int:
        wire = sum(self._wire(name, self._nbytes(name, lo, hi))
                   for name, lo, hi in op.items)
        self.downloaded_wire += wire
        eid = self.ledger.add(2, "download", wire, self.ledger.t_down(wire),
                              deps)
        for name, lo, hi in op.items:
            self.rm.writeback(slot, name, lo, hi)
        return eid

    def op_evict(self, op: Evict) -> None:
        # The acquire in op_upload performs (and counts) the eviction; the op
        # exists so plan-level counts match residency statistics.
        pass

    # -- speculative prefetch -------------------------------------------------
    def op_prefetch(self, op: Prefetch) -> None:
        self.spec.uploaded = {
            name: tuple(Interval(lo, hi) for lo, hi in rows)
            for name, rows in op.items
        }
        self.spec.data = {}
        if op.wire:
            deps = ((self.last_upload_eid,)
                    if self.last_upload_eid is not None else ())
            self.ledger.add(1, "prefetch", op.wire,
                            self.ledger.t_up(op.wire), deps)
        self.spec.sig = self.plan.sig_hash
        self._prefetch_armed = True

    # -- pinned flush ---------------------------------------------------------
    def op_pin_flush(self, op: WritebackPinned) -> None:
        raw = wire = 0
        for name, rows, nb, w in op.entries:
            r2, w2 = self.flush_pinned(name, rows, nb, w)
            raw += r2
            wire += w2
            dat = self.datasets.get(name)
            if dat is not None:
                self.rm.pinned_mark_flushed(dat)
        if wire:
            self.downloaded += raw
            self.downloaded_wire += wire
            deps = ((self.last_compute_eid,)
                    if self.last_compute_eid is not None else ())
            self.ledger.add(2, "download", wire, self.ledger.t_down(wire), deps)

    def flush_pinned(self, name: str, rows: Tuple[Tuple[int, int], ...],
                     nb: int, wire: int) -> Tuple[int, int]:
        return nb, wire


def simulate_plan(plan: Plan, hw: HardwareModel) -> InterpResult:
    """Cost one plan on ``hw`` with cold caches (fresh residency/prefetch
    state) — what :meth:`Session.explain` and the autotuner report."""
    return LedgerInterpreter(plan, hw).run()


def predict_plans(plans: Sequence[Plan], hw: HardwareModel,
                  workspace: Sequence[int] = ()) -> Tuple[float, int]:
    """Admission-oracle prediction over one chain's (possibly split) plans:
    the summed cold-cache modelled makespan and the peak fast-memory
    footprint — slot pool plus pinned residency plus what the executor
    charged beside them (``workspace``, one entry per plan: the tile
    function's workspace and the allocator's rounding,
    :mod:`repro_torch.core.workspace`) — any single plan claims while it
    runs.  Plans in a split chain execute back-to-back on one device, so
    footprints max (never sum) across them."""
    makespan = 0.0
    peak = 0
    extra = list(workspace) + [0] * (len(plans) - len(workspace))
    for p, ws in zip(plans, extra):
        makespan += simulate_plan(p, hw).makespan
        peak = max(peak, p.slot_bytes * p.num_slots + p.pinned_bytes + ws)
    return makespan, peak


# -- the real data plane -----------------------------------------------------------


def _rows(arr: torch.Tensor, lo: int, hi: int, td: int) -> Tuple[slice, ...]:
    idx = [slice(None)] * arr.dim()
    idx[td] = slice(lo, hi)
    return tuple(idx)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of a host tensor."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _async_ok(t: torch.Tensor) -> bool:
    """A copy may be asynchronous only between device memory and pinned host
    memory, on contiguous views."""
    return t.is_contiguous() and (t.is_cuda or t.is_pinned())


class DataPlaneInterpreter(LedgerInterpreter):
    """Execute a plan for real: slot tensors on ``device``, transfer-engine
    staging tasks, codec round-trips, tile compute, pinned tensors and
    prefetch capture.

    ``cp`` is the executor's memoised :class:`~repro_torch.core.executor.ChainPlan`
    (analysis, schedule, engine); ``tx`` the transfer engine; ``codecs`` the
    resolved per-dataset codec map; ``streams`` the ``{UP: stream, DOWN:
    stream}`` CUDA streams of the two copy lanes (``None`` on the CPU).
    Compute runs on the caller's current stream.  Ledger transfer events are
    recorded with raw sizes at submission and patched with achieved
    post-codec wire bytes after the engine drains.

    Hazard — functional slot updates become in-place writes.  The reference
    writes slots with ``.at[].set`` and lets a pending download keep reading
    the arrays it snapshotted while later uploads *replace* dict entries; the
    residency manager hands out a reused slot without waiting for its
    download.  Here every write lands in the one slot tensor, so anything
    that writes a slot — an upload into it, the tile compute on it, an edge
    carry into it — first waits for that slot's last download handle
    (``slot_down``).
    """

    # Wall-clock spans (dispatch + lane); the ledger keeps the model.
    _trace_modelled = False

    def __init__(self, plan: Plan, hw: HardwareModel, *,
                 rm: ResidencyManager, spec: SpecState, cp: Any,
                 tx: Any, codecs: Dict[str, Any],
                 device: torch.device,
                 streams: Optional[Dict[str, Any]] = None,
                 halo_runtime: Optional[Callable[[HaloExchange], None]] = None,
                 tracer: Optional[AnyTracer] = None,
                 trace_tag: str = "",
                 chain_index: int = 0):
        super().__init__(plan, hw, rm=rm, spec=spec,
                         datasets=cp.info.datasets,
                         tracer=tracer, trace_tag=trace_tag,
                         chain_index=chain_index)
        self.cp = cp
        self.info = cp.info
        self.sched = cp.sched
        self.engine = cp.engine
        self.tx = tx
        self.codecs = codecs
        self.td = plan.tiled_dim
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and streams is None:
            raise ValueError("a CUDA data plane needs its upload/download streams")
        self.streams = streams
        self.halo_runtime = halo_runtime
        self.compute_stream: Any = None
        self.alloc_event: Any = None
        self.patches: List[Tuple[int, Any, str]] = []
        self.up_handles: Dict[int, Any] = {}
        self.fetch_handles: Dict[int, Any] = {}   # tile -> disk-fetch handle
        self.down_handles: Dict[int, Any] = {}    # tile -> download handle
        self.slot_down: Dict[int, Any] = {}       # slot -> its last download
        self.slot_event: Dict[int, Any] = {}      # slot -> last compute-stream op on it
        self.tile_event: Dict[int, Any] = {}      # tile -> event after its compute
        self.pinned_arrays: Dict[str, torch.Tensor] = {}
        self.pinned_origins: Dict[str, int] = {}
        self.red_specs = {r.name: r for lp in cp.info.loops
                          for r in lp.reductions}
        self.tile_reductions: Dict[str, torch.Tensor] = {}
        # Seconds the lanes' copies took on the device, by CUDA events.
        self.copy_s: Dict[str, float] = {UP: 0.0, DOWN: 0.0}
        self._prefetch_armed = False
        # The tile function as CUDA graphs for this run (CUDA only; made in
        # ``begin``, released in ``finish``) and what they recorded.
        self.graphs: Optional[TileGraphs] = None
        self.graph_stats: Dict[str, float] = {}
        # On CUDA, the run's memory pool: its slots, and the tile graphs'
        # warm-ups and captures; dropped at the run's end, which gives its
        # memory back to the card (``_release_device``).
        self.pool: Any = None
        self._capture_pool: Any = None
        # Tile 0's upload rows ``begin`` restored from the prefetch captures,
        # and the slot they went into.
        self._restored: Dict[Tuple[str, int, int], Interval] = {}
        self._restored_slot: Optional[Slot] = None

    # -- streams and events ---------------------------------------------------
    def _record(self, timing: bool = False) -> Any:
        """An event after everything enqueued so far on the compute stream
        (None on the CPU, where compute is synchronous); ``timing`` makes it
        a timing event, for the device-timed spans of a traced run."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(self.compute_stream)
        return ev

    def _device_span_start(self) -> None:
        """Mark where the current op's compute-stream work begins (traced
        CUDA runs only; the dispatch loop records the end)."""
        if self.device_spans is not None:
            self._pending_start = self._record(timing=True)

    def _emit_device_spans(self) -> None:
        """After the compute stream has synchronised: one span per timed op
        on ``<tag><stream>`` at the anchor's host time plus the events'
        elapsed time, with ``device_s`` and the op's ledger ``eids`` (so the
        drift audit reads device time for them)."""
        tr = self.tracer
        anchor, t_anchor = self.anchor
        for kind, args, stream, start, end in self.device_spans:
            t0 = t_anchor + anchor.elapsed_time(start) / 1e3
            t1 = t_anchor + anchor.elapsed_time(end) / 1e3
            tr.emit(kind, cat="op",
                    track=self.trace_tag + STREAM_NAMES.get(stream, f"stream{stream}"),
                    t_start=t0, t_end=t1,
                    args=dict(args, device_s=start.elapsed_time(end) / 1e3))

    def _lane_copy(self, direction: str,
                   pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                   waits: Sequence[Any]) -> None:
        """Copy each ``(dst, src)`` pair on the lane's stream and return only
        once the copies have landed.

        Hazard — CUDA streams order nothing across lanes by themselves: the
        lane stream first waits on the compute-stream events in ``waits``.
        Synchronising the lane stream before returning makes the task's
        TransferHandle complete when the bytes are there, so its timestamps
        measure the copy, not the enqueue, and a handle dependency orders
        real data."""
        if not self.cuda:
            for dst, src in pairs:
                dst.copy_(src)
            return
        stream = self.streams[direction]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        with torch.cuda.stream(stream):
            for ev in waits:
                if ev is not None:
                    stream.wait_event(ev)
            start.record(stream)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=_async_ok(dst) and _async_ok(src))
            end.record(stream)
        stream.synchronize()
        # Device time of the copies alone (the handle's span also covers the
        # wait for compute); only this lane's worker updates its key.
        self.copy_s[direction] += start.elapsed_time(end) / 1e3

    # -- lifecycle ------------------------------------------------------------
    def begin(self) -> None:
        td = self.td
        if self.cuda:
            self.compute_stream = torch.cuda.current_stream(self.device)
        if self.tracer.enabled:
            # The anchor pairs an event with the host clock read just after
            # it, so device-timed spans land on the tracer's timeline.
            ev = self._record(timing=True)
            if ev is not None:
                self.anchor = (ev, self.tracer.clock())
                self.device_spans = []
        pinned = {n for n, _ in
                  (e for op in self.plan.ops if isinstance(op, PinUpload)
                   for e in op.entries)}
        # Hazard — prefetch captures beside the slots: the last chain's
        # device copies of this chain's first upload would sit beside every
        # slot until tile 0's upload read them, a fourth buffer the plan
        # does not charge.  They are copied into the first slot as soon as
        # it exists (tile 0's: the slot pool's least recently used) and dropped
        # before the other slots are made.
        captures, self.spec.data = self.spec.data, {}
        self._capture_pool, self.spec.pool = self.spec.pool, None
        if not self.spec_valid:
            captures = {}
            drop_pool(self.device, self, "_capture_pool")
        # Hazard — device memory beyond the plan's: the slots, the warm-ups
        # and the captures of this run share one pool, dropped at its end,
        # so nothing of one run stays reserved into the next.
        if self.cuda:
            self.pool = torch.cuda.MemPool()
        # Hazard — slot allocation on ``config.device``: the zero-filled
        # slots are made on the compute stream, so the lanes wait on
        # ``alloc_event`` before their first copy into them.
        specs = {}
        for name, ln in self.sched.max_fp_len.items():
            if name in pinned:
                continue
            dat = self.info.datasets[name]
            shape = list(dat.padded_shape)
            shape[td] = ln
            specs[name] = (tuple(shape), torch_dtype(dat.dtype))
        for i, slot in enumerate(self.slots):
            with allocating_to(self.pool, self.device):
                blocks = one_block(list(specs.values()), self.device)
            slot.arrays = dict(zip(specs, blocks))
            if i == 0:
                if captures:
                    self._restore_prefetch(slot, captures)
                del captures
                drop_pool(self.device, self, "_capture_pool")
        self.alloc_event = self._record()
        if self.cuda:
            self.graphs = TileGraphs(self.engine, self.device,
                                     [a for slot in self.slots
                                      for a in slot.arrays.values()], self.pool)

    def _release_device(self) -> None:
        """Drop the tile graphs, the slot tensors and the run's pool under
        the card's lock; the caller has synchronised the compute stream."""
        with device_lock(self.device):
            if self.graphs is not None:
                self.graphs.release()
            for slot in getattr(self, "slots", ()):
                slot.arrays = {}
            self.pool = None

    def run(self) -> InterpResult:
        try:
            return super().run()
        finally:
            if self.pool is not None:
                # A run that failed: its replays end before the pool is freed.
                with contextlib.suppress(Exception):
                    self.compute_stream.synchronize()
                self._release_device()

    def finish(self) -> None:
        self.tx.drain()
        if self.cuda:
            # Compute-stream work (the last tiles, carries, reductions) must
            # land before reductions are read and slots are released.
            self.compute_stream.synchronize()
            self.graph_stats = self.graphs.stats()
            self._release_device()
        if self.device_spans:
            self._emit_device_spans()
        # Patch transfer events with the achieved wire bytes (codec output is
        # data-dependent, so threaded tasks only report it after the fact).
        # ``ledger.totals`` accumulated the raw estimate at submission and
        # must shift by the same delta to stay consistent with the events.
        ledger = self.ledger
        for eid, handle, direction in self.patches:
            _, wire = handle.result
            ev = ledger.events[eid]
            ledger.totals[ev.kind] = (
                ledger.totals.get(ev.kind, 0) + wire - ev.nbytes)
            ev.nbytes = wire
            if direction == UP:
                ev.duration = ledger.t_up(wire)
                self.uploaded_wire += wire
            elif direction == DOWN:
                ev.duration = ledger.t_down(wire)
                self.downloaded_wire += wire
            else:   # DISK: achieved payload bytes
                ev.duration = ledger.t_disk(wire)
        tr = self.tracer
        if tr.enabled and self.patches:
            # Lane spans: the handles' own worker timestamps, one span per
            # staged ledger event — the achieved side of the drift audit.
            lane_track = {UP: "upload", DOWN: "download", DISK: "disk"}
            tag = self.trace_tag
            ci = self.chain_index
            for eid, handle, direction in self.patches:
                ev = ledger.events[eid]
                tr.emit(ev.kind, cat="lane",
                        track=tag + lane_track[direction],
                        t_start=handle.t_start, t_end=handle.t_end,
                        args={"chain": ci, "eid": eid,
                              "op": self.eid_op.get(eid, -1),
                              "queue_wait_s": handle.queue_wait_s,
                              "bytes": ev.nbytes})
        # Hazard — host-side NumPy on device tensors: the reference's
        # ``np.asarray(val)`` becomes an explicit ``.cpu()`` copy, once per
        # chain, after the compute stream has finished.
        self.reductions = {name: val.cpu().numpy()
                           for name, val in self.tile_reductions.items()}
        # Speculative-prefetch data capture: home is stable now that
        # downloads have drained, so snapshot the regions the next chain's
        # first tile is assumed to upload.  Hazard — prefetch capture: the
        # capture is a copy on the device, never a view of home rows (a later
        # chain overwrites them) nor of a slot.
        if self._prefetch_armed:
            # The slots are done with: their memory goes before the
            # captures are made.
            for slot in self.slots:
                slot.arrays = {}
            self.spec.data = {}
            rows = [(name, iv, self.info.datasets[name].rows_tensor(self.td, iv.lo, iv.hi))
                    for name, ivs in self.spec.uploaded.items()
                    if name in self.info.datasets for iv in ivs]
            pool = torch.cuda.MemPool() if self.cuda else None
            with allocating_to(pool, self.device):
                captured = one_block([(tuple(t.shape), t.dtype) for _, _, t in rows],
                                      self.device)
            self.spec.pool = pool
            for (name, iv, src), dst in zip(rows, captured):
                dst.copy_(src)
                dat = self.info.datasets[name]
                self.spec.data.setdefault(name, []).append(
                    (iv, dst, id(dat), dat.version))

    # -- pinned residency -----------------------------------------------------
    def pin_ensure(self, name: str, nb: int) -> Tuple[int, int]:
        dat = self.info.datasets[name]
        origin = -dat.halo[self.td][0]
        hit = self.rm.pinned_lookup(dat)
        if hit is not None:
            arr, origin = hit
            if self.graphs is not None:
                self.graphs.hold(arr)
            self.pinned_arrays[name] = arr
            self.pinned_origins[name] = origin
            return 0, 0
        codec = self.codecs[name]
        # Hazard — slot allocation: the pinned dataset's device copy is made
        # on ``device``, as a copy (never a view of the home).
        if codec.name == "identity":
            home = dat.region_tensor(tuple(slice(None) for _ in range(dat.ndim)))
            arr = home.to(self.device, copy=True)
            raw = wire = _nbytes(home)
        else:
            # Hazard — codecs: a compressing codec round-trips through NumPy
            # on the host, as in the reference.
            dec, raw, wire = codec.roundtrip(dat.materialize())
            arr = torch.from_numpy(np.asarray(dec, dtype=dat.dtype)).to(
                self.device, copy=True)
        self.rm.pinned_store(dat, arr, origin)
        if self.graphs is not None:
            self.graphs.hold(arr)
        self.pinned_arrays[name] = arr
        self.pinned_origins[name] = origin
        return raw, wire

    # -- the network stream ---------------------------------------------------
    def exec_halo_exchange(self, op: HaloExchange) -> None:
        if self.halo_runtime is not None:
            self.halo_runtime(op)

    # -- the disk tier (real store traffic on the third worker lane) ----------
    def stage_fetch_home(self, op: FetchHome) -> Optional[int]:
        """Disk -> host fetch of tile ``op.tile``'s rows on the DISK lane:
        decompresses the backing store's chunks into its cache (a no-op for
        RAM-resident and ``mmap`` stores) so the upload worker's staging read
        is a pure RAM hit.  The upload waits on this handle, not the other
        way round."""
        td = self.td
        datasets = self.info.datasets
        items = [(datasets[name], Interval(lo, hi))
                 for name, lo, hi in op.items]

        def task() -> Tuple[int, int]:
            read = 0
            for dat, iv in items:
                read += dat.prefetch_rows(td, iv.lo, iv.hi)
            return op.raw, read

        handle = self.tx.submit(DISK, task)
        self.fetch_handles[op.tile] = handle
        eid = self.ledger.add(3, "fetch_home", op.raw,
                              self.ledger.t_disk(op.raw), ())
        self.patches.append((eid, handle, DISK))
        return eid

    def stage_spill_home(self, op: SpillHome,
                         deps: Tuple[int, ...]) -> Optional[int]:
        """Host -> disk retirement on the DISK lane, gated on the download
        task that lands the rows home (handle dep, mirroring the ledger
        event's dep on the download event)."""
        td = self.td
        datasets = self.info.datasets
        items = [(datasets[name], Interval(lo, hi))
                 for name, lo, hi in op.items]
        dh = self.down_handles.get(op.tile)

        def task() -> Tuple[int, int]:
            written = 0
            for dat, iv in items:
                written += dat.spill_rows(td, iv.lo, iv.hi)
            return op.raw, written

        handle = self.tx.submit(DISK, task, deps=[dh] if dh is not None else [])
        eid = self.ledger.add(3, "spill_home", op.raw,
                              self.ledger.t_disk(op.raw), deps)
        self.patches.append((eid, handle, DISK))
        return eid

    # -- staging --------------------------------------------------------------
    def _restore_prefetch(self, slot: Slot, captures: Dict[str, list]) -> None:
        """Copy the captured rows of tile 0's upload into ``slot`` (on the
        compute stream, before ``alloc_event``).  A hit must be backed by a
        captured device tensor whose dataset identity/version still matches
        home — otherwise it degrades to a full miss, never to stale data.
        :meth:`spec_lookup` then reports the hits."""
        self._restored_slot = slot
        up = next((op for op in self.plan.ops
                   if isinstance(op, Upload) and op.tile == 0), None)
        if up is None:
            return
        org = self.origins[0]
        td = self.td
        for name, lo, hi in up.items:
            iv = Interval(lo, hi)
            for j, piv in enumerate(self.spec.uploaded.get(name, ())):
                hit = iv.intersect(piv)
                if hit.empty or hit.lo != iv.lo:
                    continue
                ents = captures.get(name, ())
                ent = ents[j] if j < len(ents) else None
                dat = self.info.datasets[name]
                if (ent is not None and ent[0] == piv and ent[2] == id(dat)
                        and ent[3] == dat.version):
                    dst, src = slot.arrays[name], ent[1]
                    dst[_rows(dst, hit.lo - org[name], hit.hi - org[name], td)].copy_(
                        src[_rows(src, hit.lo - piv.lo, hit.hi - piv.lo, td)])
                    self._restored[(name, lo, hi)] = hit
                break   # the first piece that starts the upload decides

    def spec_lookup(self, name: str,
                    iv: Interval) -> Tuple[Interval, Optional[Any]]:
        """Data-plane prefetch resolution: the rows :meth:`begin` restored
        into tile 0's slot (:meth:`_restore_prefetch`) are a hit and need no
        upload; anything else stages from home."""
        hit = self._restored.get((name, iv.lo, iv.hi))
        if hit is None:
            return iv, None
        if self.tile_slot[0] is not self._restored_slot:
            raise RuntimeError("tile 0 did not get the slot its prefetched rows "
                               "were restored into")
        self.prefetch_hits += 1
        return Interval(hit.hi, iv.hi), None

    def _make_upload_task(self, slot: Slot, org: Dict[str, int],
                          items: List[Tuple[str, Interval]],
                          waits: Sequence[Any]
                          ) -> Callable[[], Tuple[int, int]]:
        td = self.td
        info = self.info
        codecs = self.codecs
        arrays = slot.arrays
        cuda = self.cuda

        def task() -> Tuple[int, int]:
            raw = wire = 0
            pairs = []
            for name, use in items:
                dat = info.datasets[name]
                codec = codecs[name]
                if codec.name == "identity":
                    # Hazard — codecs: the identity codec copies the pinned
                    # home rows straight into the slot.
                    src = dat.rows_tensor(td, use.lo, use.hi)
                    if cuda and not src.is_pinned():
                        # Hazard — disk-backed homes are never pinned: their
                        # rows (a memmap view, or a copy read through the
                        # chunk cache) go through a pinned staging buffer,
                        # so the DMA to the slot stays asynchronous.
                        src = _pinned_copy(src)
                    r = w = _nbytes(src)
                else:
                    # Any other codec round-trips through NumPy on the host,
                    # as in the reference, then copies the decoded rows.
                    dec, r, w = codec.roundtrip(dat.read_rows(td, use.lo, use.hi))
                    src = torch.from_numpy(np.asarray(dec, dtype=dat.dtype))
                raw += r
                wire += w
                dst = arrays[name]
                pairs.append((
                    dst[_rows(dst, use.lo - org[name], use.hi - org[name], td)],
                    src))
            self._lane_copy(UP, pairs, waits)
            return raw, wire

        return task

    def stage_upload(self, op: Upload, slot: Slot, org: Dict[str, int],
                     items: List[Tuple[str, Interval]],
                     restores: List[Tuple],
                     raw: int, deps: Tuple[int, ...]) -> Optional[int]:
        # Home rows a still-pending download is writing back must land
        # before this staging read (cross-tile safety net; the footprint
        # algebra keeps these disjoint in practice).
        conflicts = [
            h for name, iv in items
            for h in self.rm.home_conflicts(name, iv.lo, iv.hi)]
        dh = self.slot_down.get(slot.index)
        if dh is not None:
            # Hazard — in-place slot writes: a reused slot's download must
            # have read it before this upload overwrites it.
            conflicts.append(dh)
        fh = self.fetch_handles.get(op.tile)
        if fh is not None:      # disk tier: rows must be host-resident first
            conflicts.append(fh)
        # Hazard — streams: the upload lane waits for the slot allocation and
        # for the last compute-stream op that read or wrote this slot.
        waits = (self.alloc_event, self.slot_event.get(slot.index))
        handle = self.tx.submit(
            UP, self._make_upload_task(slot, org, items, waits),
            deps=conflicts)
        self.up_handles[op.tile] = handle
        for name, iv in items:
            self.rm.note_home_read(name, iv.lo, iv.hi, handle)
        self.uploaded += raw
        eid = self.ledger.add(1, "upload", raw, self.ledger.t_up(raw), deps)
        self.patches.append((eid, handle, UP))
        return eid

    # -- compute --------------------------------------------------------------
    def execute_tile(self, op: Compute, slot: Slot) -> None:
        handle = self.up_handles.get(op.tile)
        if handle is not None:
            handle.wait()   # tile's staging must have landed
        dh = self.slot_down.get(slot.index)
        if dh is not None:
            # Hazard — in-place slot writes: a tile with nothing to upload
            # still writes its slot, so the slot's last download must be done.
            dh.wait()
        self._device_span_start()
        tile = self.sched.tiles[op.tile]
        run_arrays = {**slot.arrays, **self.pinned_arrays}
        run_origins = {**self.origins[op.tile], **self.pinned_origins}
        # Compute is enqueued asynchronously on the compute stream (on CUDA
        # as a graph warm-up, capture or replay); the event after it is what
        # this tile's download and the slot's next upload wait on.
        graphs = self.graphs
        t0 = time.perf_counter()
        tile_reds = (graphs if graphs is not None else self.engine.run_tile)(
            tile, run_arrays, run_origins)
        if self.tracer.enabled:
            self._span_note = {
                "graph": graphs.last_mode if graphs is not None else "eager",
                "enqueue_s": time.perf_counter() - t0}
        ev = self._record()
        self.tile_event[op.tile] = ev
        self.slot_event[slot.index] = ev
        for name, arr in self.pinned_arrays.items():
            self.rm.pinned_update(self.info.datasets[name], arr)
        for name, val in tile_reds.items():
            if name in self.tile_reductions:
                self.tile_reductions[name] = self.red_specs[name].combine(
                    self.tile_reductions[name], val)
            else:
                self.tile_reductions[name] = val

    # -- edge carry -----------------------------------------------------------
    def copy_edges(self, op: CarryEdge, slot: Slot, dst: Slot,
                   next_org: Dict[str, int]) -> None:
        dh = self.slot_down.get(dst.index)
        if dh is not None:
            # Hazard — in-place slot writes: the carry overwrites rows of the
            # next tile's slot, which its last download may still be reading.
            dh.wait()
        self._device_span_start()
        td = self.td
        org = self.origins[op.tile]
        for name, lo, hi in op.items:
            src = slot.arrays[name]
            vals = src[_rows(src, lo - org[name], hi - org[name], td)]
            if dst is slot:     # 1-slot pool: source and target may overlap
                vals = vals.clone()
            darr = dst.arrays[name]
            darr[_rows(darr, lo - next_org[name], hi - next_org[name], td)].copy_(vals)
        ev = self._record()
        self.slot_event[slot.index] = ev
        self.slot_event[dst.index] = ev

    # -- download -------------------------------------------------------------
    def _make_download_task(self, arrays: Dict[str, torch.Tensor],
                            org: Dict[str, int],
                            items: List[Tuple[str, Interval]],
                            waits: Sequence[Any]
                            ) -> Callable[[], Tuple[int, int]]:
        td = self.td
        info = self.info
        codecs = self.codecs
        pin = self.cuda

        def task() -> Tuple[int, int]:
            raw = wire = 0
            pairs = []
            landed = []
            for name, iv in items:
                dat = info.datasets[name]
                arr = arrays[name]
                src = arr[_rows(arr, iv.lo - org[name], iv.hi - org[name], td)]
                if (codecs[name].name == "identity"
                        and isinstance(dat.store, RamStore)):
                    # Hazard — host-side NumPy on device tensors: the rows go
                    # straight into the pinned home, not through np.asarray.
                    pairs.append((dat.rows_tensor(td, iv.lo, iv.hi), src))
                    raw += _nbytes(src)
                    wire += _nbytes(src)
                else:
                    # A compressing codec, or a disk-backed home (never
                    # pinned): the rows land in a pinned buffer first.
                    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
                    pairs.append((host, src))
                    landed.append((dat, iv, host))
            self._lane_copy(DOWN, pairs, waits)
            for dat, iv, host in landed:
                codec = codecs[dat.name]
                if codec.name == "identity":
                    # Through the store: write_rows (chunked) or the memmap.
                    dat.write_rows(td, iv.lo, iv.hi, host)
                    r = w = _nbytes(host)
                else:
                    # Compressing codecs round-trip through NumPy, as in the
                    # reference.
                    dec, r, w = codec.roundtrip(host.numpy())
                    dat.write_rows(td, iv.lo, iv.hi, np.asarray(dec, dat.dtype))
                raw += r
                wire += w
            return raw, wire

        return task

    def stage_download(self, op: Download, slot: Slot,
                       deps: Tuple[int, ...]) -> int:
        org = self.origins[op.tile]
        items = [(name, Interval(lo, hi)) for name, lo, hi in op.items]
        # The home write must wait for earlier-queued uploads still reading
        # overlapping home rows (tile t+1's upload is submitted before tile
        # t's download).  Hazard — streams: the download lane waits on the
        # event recorded after this tile's compute.
        read_deps = [
            h for name, iv in items
            for h in self.rm.home_read_conflicts(name, iv.lo, iv.hi)]
        handle = self.tx.submit(
            DOWN, self._make_download_task(dict(slot.arrays), org, items,
                                           (self.tile_event.get(op.tile),)),
            deps=read_deps)
        self.slot_down[slot.index] = handle
        self.down_handles[op.tile] = handle
        eid = self.ledger.add(2, "download", op.raw,
                              self.ledger.t_down(op.raw), deps)
        self.patches.append((eid, handle, DOWN))
        for name, iv in items:
            self.rm.writeback(slot, name, iv.lo, iv.hi, handle)
        return eid

    # -- pinned flush ---------------------------------------------------------
    def flush_pinned(self, name: str, rows: Tuple[Tuple[int, int], ...],
                     nb: int, wire: int) -> Tuple[int, int]:
        dat = self.info.datasets[name]
        arr = self.pinned_arrays[name]
        origin = self.pinned_origins[name]
        codec = self.codecs[name]
        raw_tot = wire_tot = 0
        for lo, hi in rows:
            src = arr[_rows(arr, lo - origin, hi - origin, self.td)]
            if codec.name == "identity":
                # A blocking copy on the compute stream: it follows the tiles.
                dat.write_rows(self.td, lo, hi, src)
                r = w = _nbytes(src)
            else:
                dec, r, w = codec.roundtrip(src.cpu().numpy())
                dat.write_rows(self.td, lo, hi, np.asarray(dec, dat.dtype))
            raw_tot += r
            wire_tot += w
        return raw_tot, wire_tot
