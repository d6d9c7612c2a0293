"""The explicit Plan IR: a typed tile-instruction stream for one loop chain.

The paper's central artifact is a *tiling plan* — the runtime dependency
analysis produces a schedule of tile loads, skewed compute sweeps and stores
that is constructed once and replayed across timesteps.  This module makes
that plan first-class instead of implicit executor control flow:

* **Typed ops** — :class:`Upload`, :class:`Compute`, :class:`Download`,
  :class:`CarryEdge`, :class:`Elide`, :class:`Evict`, :class:`PinUpload`,
  :class:`WritebackPinned`, :class:`Prefetch` — each carrying the byte/flop
  annotations the cost model needs.  The op *order* is the submission order
  of Algorithm 1's three streams, so an interpreter walking the stream
  reconstructs the exact ledger dependency wiring the inline executor used.
* **A planner** — :func:`build_plan` absorbs the decide-side of the old
  ``OutOfCoreExecutor._run_chain_tiled`` monolith: footprint set algebra,
  §4.1 transfer elision, cold-read clamps, static LRU slot assignment,
  pinned-dataset residency and codec wire-byte modelling all happen here,
  once, with **no data plane**.
* **Interpreters** (:mod:`repro_torch.core.interp`) consume the stream: the ledger
  interpreter costs it (``sim`` backend, :meth:`Session.explain`, the
  autotuner); the data-plane interpreter additionally moves real bytes
  through the :class:`~repro_torch.core.transfer.TransferEngine`.  Both execute
  the *same* ops.
* **JSON export/import** — plans serialise losslessly
  (:meth:`Plan.to_json` / :meth:`Plan.from_json`) for offline analysis,
  diffing, or replay against a live chain with a matching signature.

Intervals are half-open ``[lo, hi)`` grid-row ranges along the tiled
dimension; byte math uses the per-dataset ``row_bytes`` table so any
sub-interval can be priced without the datasets themselves.

Copied from ``src/repro/core/plan.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import MISSING, dataclass, fields
from typing import ClassVar, Dict, FrozenSet, List, Optional, Sequence, Tuple

from .dependency import ChainInfo, _merge, chain_signature
from .mesh import HaloSpec
from .tiling import TileSchedule
from .transfer import resolve_codecs

Item = Tuple[str, int, int]          # (dataset, lo, hi)
Rows = Tuple[Tuple[int, int], ...]   # merged half-open row intervals


class PlanError(ValueError):
    """A plan document is malformed: bad JSON, unsupported version, an
    unknown op kind, or an op/meta field mismatch.  The message names the
    offending op index and field so a truncated or version-skewed export
    is diagnosable without reading the raw JSON."""


# -- the instruction set ----------------------------------------------------------


@dataclass(frozen=True)
class PlanOp:
    """Base of every plan instruction (frozen: plans are immutable values)."""

    kind: ClassVar[str] = "?"


@dataclass(frozen=True)
class FetchHome(PlanOp):
    """Disk -> host-RAM fetch of tile ``tile``'s staging rows (stream 3).

    Emitted when the HostModel says the chain's home working set exceeds
    host RAM: the rows tile ``tile``'s upload will read must be RAM-resident
    (decompressed into the chunk cache / paged in) before the upload worker
    touches them.  Scheduled two tiles ahead by construction — the op sits in
    the stream where tile ``tile``'s staged upload is submitted, so on a
    ≥2-slot pool the disk lane runs ahead of the host->device lane exactly
    like the host->device lane runs ahead of compute."""

    kind: ClassVar[str] = "fetch-home"
    tile: int
    items: Tuple[Item, ...]
    raw: int


@dataclass(frozen=True)
class SpillHome(PlanOp):
    """Host-RAM -> disk retirement of tile ``tile``'s downloaded rows.

    The mirror of :class:`FetchHome`: once the download has landed the rows
    home, they are pushed out to the backing store (dirty chunks compressed
    and written, fully-retired chunks dropped from the cache) so the host
    working set stays inside the budget."""

    kind: ClassVar[str] = "spill-home"
    tile: int
    items: Tuple[Item, ...]
    raw: int


@dataclass(frozen=True)
class HaloPack(PlanOp):
    """Stage this device's boundary rows for its neighbours (host-side copy
    into send buffers).  ``nbytes`` counts the rows *sent*; ``names`` the
    datasets exchanged (the chain's read set)."""

    kind: ClassVar[str] = "halo-pack"
    names: Tuple[str, ...]
    nbytes: int


@dataclass(frozen=True)
class HaloExchange(PlanOp):
    """One accumulated-depth halo exchange per chain (§5.2): neighbours'
    interior rows land in this device's skirt.  ``depth`` is rows per
    interior side; ``messages``/``nbytes`` count what this device receives,
    so device sums reproduce the mesh-global exchange totals."""

    kind: ClassVar[str] = "halo-exchange"
    depth: int
    messages: int
    nbytes: int


@dataclass(frozen=True)
class HaloUnpack(PlanOp):
    """Land received halo rows into this device's home skirt; chain staging
    (the first ``Upload``) is gated on this — skirt rows must be current
    before they are staged toward fast memory."""

    kind: ClassVar[str] = "halo-unpack"
    names: Tuple[str, ...]
    nbytes: int


@dataclass(frozen=True)
class PinUpload(PlanOp):
    """Ensure pinned datasets are device-resident (upload on a cache miss).

    ``entries``: (name, whole-array raw bytes).  ``raw``/``wire`` are the
    cold-start totals; a cross-chain pinned-cache hit costs nothing."""

    kind: ClassVar[str] = "pin-upload"
    entries: Tuple[Tuple[str, int], ...]
    raw: int
    wire: int


@dataclass(frozen=True)
class Upload(PlanOp):
    """Acquire tile ``tile``'s slot and stage its right footprint up.

    Emitted for *every* tile (slot acquisition and origin binding happen
    here) even when ``items`` is empty.  Items exclude pinned datasets and
    are cold-clamped for write-first data; a speculative-prefetch hit may
    trim them further at interpretation time."""

    kind: ClassVar[str] = "upload"
    tile: int
    slot: int
    items: Tuple[Item, ...]
    raw: int
    wire: int


@dataclass(frozen=True)
class Compute(PlanOp):
    """Run the tile's skewed loop sub-ranges on stream 0.

    ``writes`` are the merged dirty-row marks per non-pinned dataset (the
    residency manager enforces their eventual writeback/carry/elision);
    ``pinned_writes`` name pinned datasets this tile modifies."""

    kind: ClassVar[str] = "compute"
    tile: int
    slot: int
    nbytes: int
    flops: int
    writes: Tuple[Tuple[str, Rows], ...]
    pinned_writes: Tuple[str, ...]


@dataclass(frozen=True)
class CarryEdge(PlanOp):
    """Device-side copy of tile ``tile``'s right edge into the next slot.

    Moves writeback responsibility for dirty rows with the data."""

    kind: ClassVar[str] = "carry-edge"
    tile: int
    slot: int
    dst_slot: int
    items: Tuple[Item, ...]
    nbytes: int


@dataclass(frozen=True)
class Elide(PlanOp):
    """§4.1 Cyclic: retire dirty rows of dead temporaries without traffic."""

    kind: ClassVar[str] = "elide"
    tile: int
    slot: int
    items: Tuple[Item, ...]
    rows: int


@dataclass(frozen=True)
class Download(PlanOp):
    """Ship tile ``tile``'s retired left footprint home (stream 2)."""

    kind: ClassVar[str] = "download"
    tile: int
    slot: int
    items: Tuple[Item, ...]
    raw: int
    wire: int


@dataclass(frozen=True)
class Evict(PlanOp):
    """Slot reuse: tile ``tile`` displaces the previous resident of its slot.

    Informational (the residency manager refuses the reuse if dirty rows
    survive); exists so plan-level op counts match residency statistics."""

    kind: ClassVar[str] = "evict"
    tile: int
    slot: int


@dataclass(frozen=True)
class Prefetch(PlanOp):
    """§4.1 speculative prefetch: upload the next chain's assumed first tile
    during this chain's last tile.  ``items``: (name, row intervals)."""

    kind: ClassVar[str] = "prefetch"
    items: Tuple[Tuple[str, Rows], ...]
    wire: int


@dataclass(frozen=True)
class WritebackPinned(PlanOp):
    """Chain-end flush of written pinned datasets (one download event).

    ``entries``: (name, written rows, raw bytes, nominal wire bytes)."""

    kind: ClassVar[str] = "writeback-pinned"
    entries: Tuple[Tuple[str, Rows, int, int], ...]
    raw: int
    wire: int


OP_TYPES: Dict[str, type] = {
    cls.kind: cls
    for cls in (PinUpload, Upload, Compute, CarryEdge, Elide, Download,
                Evict, Prefetch, WritebackPinned, FetchHome, SpillHome,
                HaloPack, HaloExchange, HaloUnpack)
}


# -- the plan ---------------------------------------------------------------------


# v2: + ``spill_home`` plan flag and the FetchHome/SpillHome disk-tier ops.
# v3: + device-mesh sharding — ``device``/``mesh_devices``/``shard_dim`` meta
#     and the HaloPack/HaloExchange/HaloUnpack network ops.
PLAN_JSON_VERSION = 3


@dataclass(frozen=True)
class Plan:
    """One chain's complete, immutable instruction stream plus the metadata
    interpreters need to bind it (slot geometry, per-row byte widths, codec
    ratios, per-tile slot origins).  Self-contained for cost modelling: a
    plan can be simulated — or exported, diffed and re-imported — without
    the datasets it was planned against."""

    num_tiles: int
    num_slots: int
    tiled_dim: int
    early_submit: bool
    cyclic: bool
    prefetch: bool
    spill_home: bool            # host tier oversubscribed: disk ops emitted
    slot_bytes: int
    pinned_bytes: int
    loop_bytes: int
    sig_hash: str                                   # structural chain identity
    row_bytes: Tuple[Tuple[str, int], ...]          # dataset -> bytes per row
    codec_names: Tuple[Tuple[str, str], ...]        # dataset -> codec name
    codec_ratios: Tuple[Tuple[str, float], ...]     # dataset -> nominal ratio
    keep_live: Tuple[str, ...]                      # split-chain liveness
    tile_origins: Tuple[Tuple[Tuple[str, int], ...], ...]
    ops: Tuple[PlanOp, ...]
    # -- device mesh (sharded execution): which device of how many this plan
    # drives, and the decomposed dimension.  Defaults = unsharded.
    device: int = 0
    mesh_devices: int = 1
    shard_dim: int = 1
    # Write-first dats staged anyway (segmented chains: their home copies
    # hold earlier-segment results the download would otherwise clobber).
    warm: Tuple[str, ...] = ()

    # -- derived views -------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Per-kind op counts (uploads count only item-bearing staging ops)."""
        c = {"uploads": 0, "downloads": 0, "computes": 0, "carries": 0,
             "elisions": 0, "evictions": 0, "prefetches": 0,
             "pin_uploads": 0, "pin_writebacks": 0,
             "home_fetches": 0, "home_spills": 0,
             "halo_packs": 0, "halo_exchanges": 0, "halo_unpacks": 0}
        for op in self.ops:
            if isinstance(op, Upload):
                if op.items:
                    c["uploads"] += 1
            elif isinstance(op, Download):
                c["downloads"] += 1
            elif isinstance(op, Compute):
                c["computes"] += 1
            elif isinstance(op, CarryEdge):
                c["carries"] += 1
            elif isinstance(op, Elide):
                c["elisions"] += 1
            elif isinstance(op, Evict):
                c["evictions"] += 1
            elif isinstance(op, Prefetch):
                c["prefetches"] += 1
            elif isinstance(op, PinUpload):
                c["pin_uploads"] += 1
            elif isinstance(op, WritebackPinned):
                c["pin_writebacks"] += 1
            elif isinstance(op, FetchHome):
                c["home_fetches"] += 1
            elif isinstance(op, SpillHome):
                c["home_spills"] += 1
            elif isinstance(op, HaloPack):
                c["halo_packs"] += 1
            elif isinstance(op, HaloExchange):
                c["halo_exchanges"] += 1
            elif isinstance(op, HaloUnpack):
                c["halo_unpacks"] += 1
        return c

    def totals(self) -> Dict[str, int]:
        """Modelled byte totals (cold caches, no prefetch hits)."""
        up_raw = up_wire = dn_raw = dn_wire = edge = flops = 0
        disk_read = disk_written = 0
        halo_bytes = halo_messages = 0
        for op in self.ops:
            if isinstance(op, (Upload, PinUpload)):
                up_raw += op.raw
                up_wire += op.wire
            elif isinstance(op, (Download, WritebackPinned)):
                dn_raw += op.raw
                dn_wire += op.wire
            elif isinstance(op, CarryEdge):
                edge += op.nbytes
            elif isinstance(op, Compute):
                flops += op.flops
            elif isinstance(op, FetchHome):
                disk_read += op.raw
            elif isinstance(op, SpillHome):
                disk_written += op.raw
            elif isinstance(op, HaloExchange):
                halo_bytes += op.nbytes
                halo_messages += op.messages
        return {"uploaded": up_raw, "uploaded_wire": up_wire,
                "downloaded": dn_raw, "downloaded_wire": dn_wire,
                "edge_bytes": edge, "flops": flops,
                "disk_read": disk_read, "disk_written": disk_written,
                "halo_bytes": halo_bytes, "halo_messages": halo_messages}

    # -- JSON -----------------------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        meta = {
            f.name: getattr(self, f.name)
            for f in fields(self) if f.name != "ops"
        }
        ops = [{"op": op.kind, **{f.name: getattr(op, f.name)
                                  for f in fields(op)}} for op in self.ops]
        return json.dumps({"version": PLAN_JSON_VERSION, "meta": meta,
                           "ops": ops}, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise PlanError(f"plan document is not valid JSON "
                            f"(truncated export?): {e}") from e
        if not isinstance(doc, dict):
            raise PlanError(
                f"plan document must be a JSON object, got "
                f"{type(doc).__name__}")
        # v2 documents load fine: every v3 addition (device/mesh_devices/
        # shard_dim/warm meta, halo ops) defaults to the unsharded case.
        if doc.get("version") not in (2, PLAN_JSON_VERSION):
            raise PlanError(
                f"unsupported plan version {doc.get('version')!r} "
                f"(expected 2 or {PLAN_JSON_VERSION})")
        for key in ("meta", "ops"):
            if key not in doc:
                raise PlanError(f"plan document has no {key!r} section")
        if not isinstance(doc["meta"], dict):
            raise PlanError("plan 'meta' section must be a JSON object")
        meta = {k: _tuplify(v) for k, v in doc["meta"].items()}
        ops: List[PlanOp] = []
        for i, entry in enumerate(doc["ops"]):
            if not isinstance(entry, dict) or "op" not in entry:
                raise PlanError(
                    f"op {i}: not an op object (missing 'op' field): "
                    f"{entry!r}")
            entry = dict(entry)
            kind = entry.pop("op")
            op_cls = OP_TYPES.get(kind)
            if op_cls is None:
                raise PlanError(
                    f"op {i}: unknown op kind {kind!r} "
                    f"(known: {', '.join(sorted(OP_TYPES))})")
            want = {f.name for f in fields(op_cls)}
            got = set(entry)
            if got != want:
                missing = ", ".join(sorted(want - got)) or "-"
                extra = ", ".join(sorted(got - want)) or "-"
                raise PlanError(
                    f"op {i} ({kind!r}): field mismatch — missing: "
                    f"{missing}; unexpected: {extra}")
            ops.append(op_cls(**{k: _tuplify(v) for k, v in entry.items()}))
        want_meta = {f.name for f in fields(cls)} - {"ops"}
        required = {f.name for f in fields(cls)
                    if f.default is MISSING
                    and f.default_factory is MISSING} - {"ops"}
        extra_meta = set(meta) - want_meta
        missing_meta = required - set(meta)
        if extra_meta or missing_meta:
            raise PlanError(
                f"plan meta field mismatch — missing: "
                f"{', '.join(sorted(missing_meta)) or '-'}; unexpected: "
                f"{', '.join(sorted(extra_meta)) or '-'}")
        return cls(ops=tuple(ops), **meta)


def _tuplify(v):
    """JSON arrays -> tuples, recursively (plan fields are tuple-typed)."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def plans_to_json(plans: Sequence[Plan], indent: Optional[int] = None) -> str:
    """Serialise several chains' plans (a whole queued step) as one document."""
    return json.dumps([json.loads(p.to_json()) for p in plans], indent=indent)


def plans_from_json(text: str) -> List[Plan]:
    try:
        docs = json.loads(text)
    except json.JSONDecodeError as e:
        raise PlanError(f"plan-list document is not valid JSON "
                        f"(truncated export?): {e}") from e
    if not isinstance(docs, list):
        raise PlanError("plan-list document must be a JSON array of plans")
    return [Plan.from_json(json.dumps(doc)) for doc in docs]


def chain_sig_hash(info: ChainInfo) -> str:
    """Stable structural identity of a chain (names/ranges/stencils/modes) —
    survives JSON round-trips and process boundaries, unlike the replay-safe
    ``plan_signature`` which hashes kernel closures and object identities."""
    return hashlib.sha1(repr(chain_signature(info)).encode()).hexdigest()


# -- the planner ------------------------------------------------------------------


def build_plan(
    info: ChainInfo,
    sched: TileSchedule,
    *,
    num_slots: int,
    cyclic: bool = False,
    prefetch: bool = False,
    spill_home: bool = False,
    keep_live: FrozenSet[str] = frozenset(),
    warm: FrozenSet[str] = frozenset(),
    pinned_names: FrozenSet[str] = frozenset(),
    codec_spec=None,
    flops_per_point: Optional[int] = None,
    slot_bytes: int = 0,
    pinned_bytes: int = 0,
    halo: Optional[HaloSpec] = None,
) -> Plan:
    """Lower one analysed+scheduled chain to its instruction stream.

    Pure: consumes the dependency analysis (``info``) and skewed tile
    schedule (``sched``) plus the planning-relevant config knobs; touches no
    data.  Op order is the three-stream submission order of Algorithm 1 —
    with ≥2 slots tile t+1's upload is issued before tile t's compute
    (pipelined staging); a 1-slot pool runs strictly in order.

    ``spill_home`` (the HostModel's verdict that home copies oversubscribe
    host RAM) adds the fourth stream: every staged upload is preceded by a
    ``FetchHome`` of the same rows (disk -> host ahead of host -> device) and
    every download is followed by a ``SpillHome`` (host -> disk once the rows
    are retired).  Pinned datasets are exempt — pinning declares them small
    and hot, i.e. host-resident for the whole run.

    ``halo`` (sharded execution, :class:`~repro_torch.core.mesh.HaloSpec`) places
    the paper's §5.2 one-accumulated-depth-per-chain exchange at the head of
    the stream — ``HaloPack`` -> ``HaloExchange`` -> ``HaloUnpack`` on the
    network stream, gating the chain's first staged upload — and stamps the
    plan with its device position on the mesh."""
    td = info.tiled_dim
    num_tiles = sched.num_tiles
    early_submit = num_slots >= 2
    codecs = resolve_codecs(codec_spec, tuple(info.datasets))

    row_bytes: Dict[str, int] = {}
    ratios: Dict[str, float] = {}
    for name, dat in info.datasets.items():
        other = 1
        for d, s in enumerate(dat.padded_shape):
            if d != td:
                other *= s
        row_bytes[name] = other * dat.dtype.itemsize
        ratios[name] = float(codecs[name].nominal_ratio(dat.dtype))

    def nbytes(name: str, lo: int, hi: int) -> int:
        return max(0, hi - lo) * row_bytes[name]

    def wire(name: str, nb: int) -> int:
        return max(1, int(nb / ratios[name])) if nb else 0

    tile_origins = tuple(
        tuple(sorted((name, iv.lo) for name, iv in t.footprint.items()
                     if not iv.empty))
        for t in sched.tiles
    )

    ops: List[PlanOp] = []

    # -- the halo exchange (device mesh, once per chain) ---------------------
    if halo is not None and halo.num_devices > 1 and halo.messages:
        ops.append(HaloPack(names=halo.names, nbytes=halo.nbytes))
        ops.append(HaloExchange(depth=halo.depth, messages=halo.messages,
                                nbytes=halo.nbytes))
        ops.append(HaloUnpack(names=halo.names, nbytes=halo.nbytes))

    # -- pinned residency (whole-array, cached across chains) ----------------
    if pinned_names:
        entries = tuple((name, int(info.datasets[name].nbytes))
                        for name in sorted(pinned_names))
        ops.append(PinUpload(
            entries=entries,
            raw=sum(nb for _, nb in entries),
            wire=sum(wire(name, nb) for name, nb in entries)))

    # -- per-tile op constructors ---------------------------------------------
    def upload_op(t: int) -> Upload:
        tile = sched.tiles[t]
        items: List[Item] = []
        for name, pieces in tile.upload.items():
            if name in pinned_names:
                continue            # whole-array resident: never staged
            if name in info.write_first and name not in warm:
                # §4.1: write-first data never uploads — except rows the chain
                # reads before any write reaches them (cold halo skirts).
                # ``warm`` overrides the elision: a segmented chain's earlier
                # segment already landed real data home (e.g. halo-mirror
                # columns), which this segment's full-width download would
                # clobber with zero-initialised slot content if not staged.
                cold = info.cold.get(name, [])
                pieces = tuple(
                    p for iv in pieces
                    for p in (iv.clamp(clo, chi) for clo, chi in cold)
                    if not p.empty)
            for iv in pieces:
                if not iv.empty:
                    items.append((name, iv.lo, iv.hi))
        raw = sum(nbytes(n, lo, hi) for n, lo, hi in items)
        return Upload(
            tile=t, slot=t % num_slots, items=tuple(items), raw=raw,
            wire=sum(wire(n, nbytes(n, lo, hi)) for n, lo, hi in items))

    def compute_op(t: int) -> Compute:
        tile = sched.tiles[t]
        tile_bytes = tile_flops = 0
        writes: Dict[str, List[Tuple[int, int]]] = {}
        pinned_written: List[str] = []
        for k, box in enumerate(tile.loop_ranges):
            if box is None:
                continue
            npts = 1
            for a, b in box:
                npts *= b - a
            lp = info.loops[k]
            full_pts = 1
            for a, b in lp.range_:
                full_pts *= b - a
            frac = npts / full_pts
            tile_bytes += int(lp.bytes_moved() * frac)
            tile_flops += int(lp.flops(flops_per_point) * frac)
            lo_w, hi_w = box[td]
            for arg in lp.args:
                if not arg.mode.writes:
                    continue
                nm = arg.dat.name
                if nm in pinned_names:
                    if nm not in pinned_written:
                        pinned_written.append(nm)
                else:
                    writes.setdefault(nm, []).append((lo_w, hi_w))
        return Compute(
            tile=t, slot=t % num_slots, nbytes=tile_bytes, flops=tile_flops,
            writes=tuple(sorted((nm, tuple(_merge(ivs)))
                                for nm, ivs in writes.items())),
            pinned_writes=tuple(pinned_written))

    def carry_op(t: int) -> Optional[CarryEdge]:
        if t + 1 >= num_tiles:
            return None
        tile = sched.tiles[t]
        next_org = dict(tile_origins[t + 1])
        items: List[Item] = []
        for name, iv in tile.edge_to_next.items():
            if iv.empty or name not in next_org or name in pinned_names:
                continue
            items.append((name, iv.lo, iv.hi))
        if not items:
            return None
        return CarryEdge(
            tile=t, slot=t % num_slots, dst_slot=(t + 1) % num_slots,
            items=tuple(items),
            nbytes=sum(nbytes(n, lo, hi) for n, lo, hi in items))

    def retire_ops(t: int) -> Tuple[Optional[Elide], Optional[Download]]:
        tile = sched.tiles[t]
        elide_items: List[Item] = []
        dl_items: List[Item] = []
        for name, pieces in tile.download.items():
            if name in pinned_names or name in info.read_only:
                continue    # never written / flushed once at chain end
            if cyclic and name in info.write_first and name not in keep_live:
                # §4.1 Cyclic: dead temporaries stay on device — no traffic,
                # but the residency books must balance.
                elide_items.extend(
                    (name, iv.lo, iv.hi) for iv in pieces if not iv.empty)
                continue
            dl_items.extend((name, iv.lo, iv.hi) for iv in pieces if not iv.empty)
        el = dl = None
        if elide_items:
            el = Elide(tile=t, slot=t % num_slots, items=tuple(elide_items),
                       rows=sum(hi - lo for _, lo, hi in elide_items))
        if dl_items:
            raw = sum(nbytes(n, lo, hi) for n, lo, hi in dl_items)
            dl = Download(
                tile=t, slot=t % num_slots, items=tuple(dl_items), raw=raw,
                wire=sum(wire(n, nbytes(n, lo, hi)) for n, lo, hi in dl_items))
        return el, dl

    def staged_upload(t: int) -> List[PlanOp]:
        out: List[PlanOp] = []
        up = upload_op(t)
        if spill_home and up.items:
            out.append(FetchHome(tile=t, items=up.items, raw=up.raw))
        if t >= num_slots:
            out.append(Evict(tile=t, slot=t % num_slots))
        out.append(up)
        return out

    def retire_tail(t: int, dl: Optional[Download]) -> List[PlanOp]:
        if dl is None:
            return []
        out: List[PlanOp] = [dl]
        if spill_home:
            out.append(SpillHome(tile=t, items=dl.items, raw=dl.raw))
        return out

    # -- assembly: Algorithm 1's submission order -----------------------------
    ops.extend(staged_upload(0))
    for t in range(num_tiles):
        if early_submit and t + 1 < num_tiles:
            ops.extend(staged_upload(t + 1))
        ops.append(compute_op(t))
        el, dl = retire_ops(t)
        if early_submit:
            c = carry_op(t)
            if c:
                ops.append(c)
            if el:
                ops.append(el)
            ops.extend(retire_tail(t, dl))
        else:
            if el:
                ops.append(el)
            ops.extend(retire_tail(t, dl))
            c = carry_op(t)
            if c:
                ops.append(c)
            if t + 1 < num_tiles:
                ops.extend(staged_upload(t + 1))
        if prefetch and t == num_tiles - 1:
            first = sched.tiles[0]
            pf: List[Tuple[str, Rows]] = []
            pf_wire = 0
            for name, pieces in first.upload.items():
                if name in info.write_first or name in pinned_names:
                    continue
                live = tuple((iv.lo, iv.hi) for iv in pieces if not iv.empty)
                if not live:
                    continue
                pf.append((name, live))
                pf_wire += sum(wire(name, nbytes(name, lo, hi))
                               for lo, hi in live)
            ops.append(Prefetch(items=tuple(pf), wire=pf_wire))

    # -- chain-end pinned flush ----------------------------------------------
    flushed = sorted(pinned_names & info.modified)
    if flushed:
        entries = []
        for name in flushed:
            rows = tuple((lo, hi) for lo, hi in info.written.get(name, []))
            nb = sum(nbytes(name, lo, hi) for lo, hi in rows)
            entries.append((name, rows, nb, wire(name, nb)))
        ops.append(WritebackPinned(
            entries=tuple(entries),
            raw=sum(e[2] for e in entries),
            wire=sum(e[3] for e in entries)))

    return Plan(
        num_tiles=num_tiles, num_slots=num_slots, tiled_dim=td,
        early_submit=early_submit, cyclic=bool(cyclic),
        prefetch=bool(prefetch), spill_home=bool(spill_home),
        slot_bytes=int(slot_bytes),
        pinned_bytes=int(pinned_bytes), loop_bytes=info.loop_bytes(),
        sig_hash=chain_sig_hash(info),
        row_bytes=tuple(sorted(row_bytes.items())),
        codec_names=tuple(sorted((n, codecs[n].name) for n in info.datasets)),
        codec_ratios=tuple(sorted(ratios.items())),
        keep_live=tuple(sorted(keep_live)),
        tile_origins=tile_origins,
        ops=tuple(ops),
        device=halo.device if halo is not None else 0,
        mesh_devices=halo.num_devices if halo is not None else 1,
        shard_dim=halo.shard_dim if halo is not None else 1,
        warm=tuple(sorted(warm)),
    )


# -- human-readable rendering ------------------------------------------------------


def _mb(nb: float) -> str:
    if nb >= 1e9:
        return f"{nb / 1e9:.2f} GB"
    if nb >= 1e6:
        return f"{nb / 1e6:.2f} MB"
    if nb >= 1e3:
        return f"{nb / 1e3:.1f} kB"
    return f"{int(nb)} B"


def _items_str(items: Sequence[Item], limit: int = 4) -> str:
    parts = [f"{n}[{lo}:{hi})" for n, lo, hi in items[:limit]]
    if len(items) > limit:
        parts.append(f"+{len(items) - limit} more")
    return " ".join(parts) if parts else "-"


def format_plan(plan: Plan, hw=None, title: str = "plan") -> str:
    """Per-tile op listing with modelled bytes; with ``hw``, the modelled
    makespan (ledger-interpreted, cold caches) is appended.

    Every op line carries its stable index (``#N`` = position in
    ``plan.ops``): the same N the drift audit (:mod:`repro_torch.obs.audit`)
    reports as ``op #N``, traced spans carry in their ``op`` arg, and
    :mod:`repro_torch.core.verify` diagnostics cite as ``op N``."""
    tot = plan.totals()
    codec_set = sorted({c for _, c in plan.codec_names})
    lines = [
        f"{title}: {plan.num_tiles} tiles x {plan.num_slots} slots"
        f" ({'pipelined' if plan.early_submit else 'in-order'}),"
        f" tiled dim {plan.tiled_dim},"
        f" slot {_mb(plan.slot_bytes)}"
        + (f", pinned {_mb(plan.pinned_bytes)}" if plan.pinned_bytes else "")
        + f", codec {'/'.join(codec_set)}"
        + (", cyclic" if plan.cyclic else "")
        + (", prefetch" if plan.prefetch else "")
        + (", disk tier (host oversubscribed)" if plan.spill_home else "")
        + (f", device {plan.device}/{plan.mesh_devices}"
           f" (shard dim {plan.shard_dim})" if plan.mesh_devices > 1 else "")
        + (f", warm {' '.join(plan.warm)}" if plan.warm else "")
        + (f", keep-live {' '.join(plan.keep_live)}"
           if plan.keep_live else ""),
    ]
    cur_tile = None
    for idx, op in enumerate(plan.ops):
        t = getattr(op, "tile", None)
        if t is not None and t != cur_tile:
            cur_tile = t
            lines.append(f"  tile {t} -> slot {t % plan.num_slots}")
        n_before = len(lines)
        if isinstance(op, HaloPack):
            names = " ".join(op.names[:4]) + (
                f" +{len(op.names) - 4} more" if len(op.names) > 4 else "")
            lines.append(f"  halo-pack   {len(op.names)} dats ({names})"
                         f"  {_mb(op.nbytes)}")
        elif isinstance(op, HaloExchange):
            lines.append(f"  halo-exchange depth {op.depth},"
                         f" {op.messages} msgs, {_mb(op.nbytes)} (net)")
        elif isinstance(op, HaloUnpack):
            names = " ".join(op.names[:4]) + (
                f" +{len(op.names) - 4} more" if len(op.names) > 4 else "")
            lines.append(f"  halo-unpack {len(op.names)} dats ({names})"
                         f"  {_mb(op.nbytes)}")
        elif isinstance(op, PinUpload):
            names = " ".join(n for n, _ in op.entries)
            lines.append(f"  pin-upload {names}  {_mb(op.raw)}"
                         f" (wire {_mb(op.wire)})")
        elif isinstance(op, Upload):
            if op.items:
                lines.append(f"    upload   {_items_str(op.items)}"
                             f"  {_mb(op.raw)} (wire {_mb(op.wire)})")
        elif isinstance(op, Compute):
            w = _items_str([(n, r[0][0], r[-1][1]) for n, r in op.writes if r])
            lines.append(f"    compute  {_mb(op.nbytes)} touched,"
                         f" {op.flops / 1e6:.2f} MFLOP, writes {w}")
        elif isinstance(op, CarryEdge):
            lines.append(f"    carry -> slot {op.dst_slot}"
                         f"  {_items_str(op.items)}  {_mb(op.nbytes)}")
        elif isinstance(op, Elide):
            lines.append(f"    elide    {_items_str(op.items)}"
                         f"  ({op.rows} rows, no traffic)")
        elif isinstance(op, Download):
            lines.append(f"    download {_items_str(op.items)}"
                         f"  {_mb(op.raw)} (wire {_mb(op.wire)})")
        elif isinstance(op, FetchHome):
            lines.append(f"    fetch-home  {_items_str(op.items)}"
                         f"  {_mb(op.raw)} (disk -> host)")
        elif isinstance(op, SpillHome):
            lines.append(f"    spill-home  {_items_str(op.items)}"
                         f"  {_mb(op.raw)} (host -> disk)")
        elif isinstance(op, Evict):
            lines.append(f"    evict    slot {op.slot}")
        elif isinstance(op, Prefetch):
            names = " ".join(n for n, _ in op.items)
            lines.append(f"    prefetch {names or '-'}  (wire {_mb(op.wire)},"
                         f" next chain's first tile)")
        elif isinstance(op, WritebackPinned):
            names = " ".join(n for n, _, _, _ in op.entries)
            lines.append(f"  writeback-pinned {names}  {_mb(op.raw)}"
                         f" (wire {_mb(op.wire)})")
        if len(lines) > n_before:
            # Stable op index (position in plan.ops), preserving indentation.
            ln = lines[-1]
            pad = len(ln) - len(ln.lstrip())
            lines[-1] = f"{ln[:pad]}#{idx:<3d} {ln[pad:]}"
    lines.append(
        f"  totals: up {_mb(tot['uploaded'])} (wire {_mb(tot['uploaded_wire'])}),"
        f" down {_mb(tot['downloaded'])} (wire {_mb(tot['downloaded_wire'])}),"
        f" edge {_mb(tot['edge_bytes'])}"
        + (f", disk r/w {_mb(tot['disk_read'])}/{_mb(tot['disk_written'])}"
           if plan.spill_home else "")
        + (f", halo {_mb(tot['halo_bytes'])} in {tot['halo_messages']} msgs"
           if tot["halo_messages"] else ""))
    lines.append(
        "  ops: " + ", ".join(f"{v} {k}" for k, v in plan.counts().items() if v))
    if hw is not None:
        from .interp import simulate_plan  # function-level: avoids a cycle

        res = simulate_plan(plan, hw)
        bw = plan.loop_bytes / res.makespan / 1e9 if res.makespan else 0.0
        who = (f"device {plan.device}, {hw.name}"
               if plan.mesh_devices > 1 else hw.name)
        lines.append(f"  modelled makespan ({who}): "
                     f"{res.makespan * 1e3:.3f} ms"
                     f"  ({bw:.1f} GB/s avg over {_mb(plan.loop_bytes)}"
                     f" useful bytes)")
    return "\n".join(lines)
