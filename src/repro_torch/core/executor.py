"""Out-of-core executors (the paper's §4, Algorithm 1).

``OutOfCoreExecutor`` — explicit memory management with three slots:
while tile *t* executes (stream 0), tile *t+1*'s right footprint uploads
(stream 1) and tile *t−1*'s left footprint downloads (stream 2); after each
tile the right edge is copied device-side into the next slot.  Transfer
elision per §4.1: read-only datasets never download, write-first datasets
never upload, Cyclic additionally skips the download of write-first
temporaries, and speculative prefetch uploads the *next* chain's first tile
during the current chain's last tile.

Since the Plan-IR redesign the executor is a thin planner/interpreter pair:

* :meth:`plan_chain` lowers a chain to an explicit, typed instruction
  stream (:class:`~repro_torch.core.plan.Plan`) via dependency analysis + skewed
  tile scheduling + :func:`~repro_torch.core.plan.build_plan`, memoised on the
  replay-safe ``plan_signature`` plus every planning-relevant config knob.
* :meth:`run_chain` hands that stream to one of the two interpreters in
  :mod:`repro_torch.core.interp`: the ledger interpreter (``simulate_only`` —
  modelled timeline, no data) or the data-plane interpreter (real slot
  tensors, transfer-engine staging, codecs, tile compute).  Both execute
  the *same* ops, so simulated and real runs cannot drift apart.

``ResidentExecutor`` — the paper's baseline: everything resident in fast
memory for the whole run (raises, like the paper's segfault, if it can't fit).

Data plane: home copies are host tensors (slow memory, pinned when the
device is CUDA) or disk-backed stores (``mmap``/``chunked``, never pinned:
their rows are staged through pinned buffers, and the plan's
FetchHome/SpillHome ops run on the transfer engine's disk lane); slots are
tensors on ``OOCConfig.device``; on CUDA the
upload and download lanes copy on their own streams beside the compute
stream, so the paper's three streams are real.  Modelled *timings* still come
from the calibrated :class:`~repro_torch.core.memory.HardwareModel` ledger.

Ported from ``src/repro/core/executor.py``, the serving layer's shared
plan cache (``shared_plans``, ``tenant``) included.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .dependency import (
    ChainInfo,
    analyze_chain,
    chain_signature,
    plan_signature,
    shared_plan_signature,
    split_chain,
)
from .device import resolve_device
from .engine import TileEngine
from .interp import DataPlaneInterpreter, LedgerInterpreter, SpecState
from .tile_graph import drop_pool
from .loop import ParallelLoop
from .memory import H100, HardwareModel, TransferLedger
from .plan import Plan, build_plan
from .tiling import TileSchedule, make_tile_schedule
from .transfer import ResidencyManager, TransferEngine, resolve_codecs
from .transfer.engine import DOWN, UP
from .workspace import Workspaces
from ..obs.tracer import AnyTracer, as_tracer


@dataclass
class OOCConfig:
    hw: HardwareModel = H100
    capacity_bytes: Optional[float] = None   # default: hw.fast_capacity
    num_slots: int = 3
    num_tiles: Optional[int] = None          # default: smallest that fits
    tiled_dim: int = 0
    cyclic: bool = False                     # §4.1 unsafe temporaries opt
    prefetch: bool = False                   # §4.1 speculative prefetch
    flops_per_point: Optional[int] = None    # compute model override
    # Ledger interpreter only — no data plane.  For modelled benchmarks at
    # scaled-down sizes (correctness is covered by the executing tests).
    simulate_only: bool = False
    # -- transfer subsystem knobs --------------------------------------------
    transfer: str = "sync"                   # "sync" | "threaded"
    codec: Union[str, Dict[str, str]] = "identity"   # name or {dat: name, "*": ...}
    pinned: Tuple[str, ...] = ()             # datasets kept device-resident
    # -- host tier (repro_torch.core.store) ----------------------------------------
    # Host-RAM budget for dataset home copies; chains whose working set
    # exceeds it get FetchHome/SpillHome ops against the disk-backed stores.
    host_capacity: Optional[float] = None    # default: hw.host_capacity
    # Statically verify every plan before interpreting it
    # (repro_torch.core.verify); error-severity diagnostics raise
    # PlanVerificationError instead of executing a corrupting stream.
    debug: bool = False
    # -- observability (repro_torch.obs) -------------------------------------------
    # True mints a fresh span Tracer; an existing Tracer shares one spine
    # across executors (the sharded mesh and serve lanes do this).  Off by
    # default: the hot path then pays one attribute check per chain/op.
    trace: object = None                     # None/False | True | obs.Tracer
    # Where slots live and tiles run: "cuda" (raises without CUDA) or "cpu".
    device: str = "cuda"

    @property
    def capacity(self) -> float:
        return self.capacity_bytes if self.capacity_bytes is not None else self.hw.fast_capacity

    @property
    def host_budget(self) -> float:
        return (self.host_capacity if self.host_capacity is not None
                else self.hw.host_capacity)

    def codec_key(self) -> Tuple:
        """Hashable form of the codec spec (plan wire bytes depend on it)."""
        if isinstance(self.codec, dict):
            return tuple(sorted(self.codec.items()))
        return (self.codec,)


@dataclass
class ChainStats:
    num_tiles: int
    loop_bytes: int            # the paper's 'useful bytes' for avg-BW metric
    uploaded: int              # raw (uncompressed) bytes staged up
    downloaded: int            # raw (uncompressed) bytes staged down
    edge_bytes: int
    prefetch_hits: int
    wall_s: float
    modelled_s: float
    achieved_bw_model: float   # loop_bytes / modelled makespan
    slot_bytes: int
    plan_cache_hit: bool = False   # chain plan replayed from cache
    plan_s: float = 0.0            # analysis + scheduling time (0 on hits)
    verify_s: float = 0.0          # ``debug`` plan verification time
    # -- transfer subsystem --------------------------------------------------
    uploaded_wire: int = 0         # post-codec bytes the link carried up
    downloaded_wire: int = 0       # post-codec bytes the link carried down
    compression_ratio: float = 1.0  # raw / wire over both directions
    queue_wait_s: float = 0.0      # submit-to-start latency summed over tasks
    transfer_mode: str = "sync"
    # -- plan IR -------------------------------------------------------------
    # Per-kind op counts straight from the chain's instruction stream
    # (uploads/downloads/carries/elisions/evictions/...), so benchmarks
    # report plan structure without re-deriving it from ledger events.
    op_counts: Dict[str, int] = field(default_factory=dict)
    # -- disk tier (repro_torch.core.store) ----------------------------------------
    # Bytes that crossed the disk boundary this chain: the backing stores'
    # achieved counters on data-plane runs (all traffic, including lazy
    # chunk-cache misses), the FetchHome/SpillHome modelled bytes in sim mode.
    disk_read: int = 0
    disk_written: int = 0
    # -- device mesh (repro_torch.core.sharded) --------------------------------
    # Halo-exchange traffic this chain's plan carried (messages/bytes landing
    # in this device's skirts; aggregated over devices by the sharded
    # executor).  Zero for unsharded chains.
    halo_messages: int = 0
    halo_bytes: int = 0
    # -- the tile function as CUDA graphs (repro_torch.core.tile_graph) -------
    # The counterpart of the reference's ``TileEngine.num_compiles``: per
    # chain run on a CUDA device, the graph keys seen (each key's first tile
    # runs eagerly, its warm-up), captures, replays, the captures' host
    # seconds and the device bytes they reserved for the run's pool, and the
    # replays held against the eager tile function (``check_replays``).
    # Zero on the CPU and in sim mode, where every tile runs eagerly.
    graph_warmups: int = 0
    graph_captures: int = 0
    graph_replays: int = 0
    graph_capture_s: float = 0.0
    graph_pool_bytes: int = 0
    graph_checked: int = 0
    # -- the device capacity (repro_torch.core.workspace) ---------------------
    # What the plan charged beside its slots and pinned residency: the tile
    # function's workspace and the allocator's rounding.
    workspace_bytes: int = 0


# ChainStats fields of the tile graphs (``TileGraphs.stats()``'s keys).
GRAPH_FIELDS = ("graph_warmups", "graph_captures", "graph_replays",
                "graph_capture_s", "graph_pool_bytes", "graph_checked")


@dataclass
class ChainPlan:
    """The memoised product of dependency analysis + tile scheduling + the
    tile engine + the lowered instruction stream for one chain
    signature.  Cyclic loop chains (CloverLeaf/OpenSBLI timesteps) are
    structurally identical across steps, so every flush after the first
    replays one of these instead of paying ``analyze_chain`` +
    ``make_tile_schedule`` + ``build_plan`` again."""

    key: Tuple
    info: ChainInfo
    sched: TileSchedule
    engine: TileEngine
    slot_bytes: int     # per-slot bytes, pinned datasets excluded
    sig: Tuple          # structural chain_signature (prefetch guessing)
    plan_s: float       # construction cost (what cache hits save)
    ir: Plan = None                         # the typed instruction stream
    pinned_names: frozenset = frozenset()   # pinned datasets this chain touches
    pinned_bytes: int = 0                   # their whole-array residency cost
    # Charged beside them: the tile function's workspace and the allocator's
    # rounding of the slot and pinned tensors (core/workspace.py).
    workspace_bytes: int = 0


class OutOfCoreExecutor:
    """Explicitly-managed 3-slot streaming executor (Algorithm 1)."""

    def __init__(self, config: OOCConfig = None, *, device=None,
                 shared_plans=None):
        self.cfg = config or OOCConfig()
        # ``device`` overrides ``cfg.device``: the sharded executor of a
        # ``cuda:N`` mesh shares one config and puts each shard on its card.
        self.device = resolve_device(device if device is not None
                                     else self.cfg.device)
        # The upload and download lanes' own CUDA streams; compute runs on
        # the caller's current stream.
        self.streams = ({UP: torch.cuda.Stream(self.device),
                         DOWN: torch.cuda.Stream(self.device)}
                        if self.device.type == "cuda" else None)
        # LRU-bounded: kernels capturing a per-step constant (a real dt
        # changing every step) legitimately produce a new plan per flush —
        # without a bound a long run would accumulate engines/ChainInfos
        # without limit.
        self._plans: "OrderedDict[Tuple, ChainPlan]" = OrderedDict()
        self._max_plans = 32
        self._no_fit: set = set()   # keys known to raise MemoryError
        # The tile function's workspace and the tile counts that fit it
        # (memoised on the chain's structure, not its captured values).
        self.workspaces = Workspaces()
        self.plan_hits = 0
        self.plan_misses = 0
        self.plan_time_s = 0.0
        # Optional cross-executor plan cache (repro_torch.serve.
        # SharedPlanCache): consulted on a local miss under the tenant-neutral
        # signature, fed on every build.  ``tenant`` attributes lookups for
        # the serving layer's cross-tenant hit counters; executors outside a
        # server leave both None.
        self.shared_plans = shared_plans
        self.tenant: Optional[str] = None
        # The transfer subsystem: engine (worker threads or sync fallback)
        # and residency manager (slot pool, dirty tracking, pinned cache,
        # capacity accounting) are executor-lifetime so pinned device arrays
        # and transfer statistics persist across chains.
        self.transfer = TransferEngine(mode=self.cfg.transfer)
        self.residency = ResidencyManager(
            capacity_bytes=self.cfg.capacity, num_slots=self.cfg.num_slots,
            pinned=frozenset(self.cfg.pinned))
        # Cross-chain speculative-prefetch state (shared by both interpreters).
        self._spec = SpecState()
        # Collective halo-exchange hook: a mesh-owning parent executor
        # (repro_torch.core.sharded) installs a callable here so this
        # executor's data-plane interpreter can run HaloExchange ops for real.
        self.halo_runtime = None
        self.history: List[ChainStats] = []
        # Observability spine (repro_torch.obs): a mesh/serve parent may overwrite
        # both to share one tracer and prefix this executor's tracks.
        self.tracer: AnyTracer = as_tracer(self.cfg.trace)
        self.trace_tag: str = ""
        # Per-chain ledgers, retained only while tracing — the drift audit
        # needs each chain's modelled timeline next to its achieved spans.
        self.ledgers: List[TransferLedger] = []
        # Device seconds of the upload/download lanes' copies (CUDA events;
        # zero on the CPU), summed over chains.
        self.copy_s: Dict[str, float] = {UP: 0.0, DOWN: 0.0}

    # -- planning ---------------------------------------------------------------
    def plan_chain(self, loops: Sequence[ParallelLoop],
                   keep_live: frozenset = frozenset(),
                   halo=None, *, warm: frozenset = frozenset()) -> ChainPlan:
        """Analysis + tile scheduling + engine + the lowered Plan IR,
        memoised on the replay-safe ``plan_signature`` (structure, dataset
        identity, kernel fingerprints) plus the planning-relevant config
        knobs.  ``keep_live`` names datasets a split chain's remainder still
        reads (they may not be elided), and is part of the cache key because
        the §4.1 elision decisions are baked into the instruction stream.
        ``halo`` (a :class:`~repro_torch.core.mesh.HaloSpec`, sharded
        execution) stamps the plan with its device-mesh position and places
        the once-per-chain halo exchange at the head of the op stream.
        ``warm`` names write-first dats that must stage anyway — a split or
        segmented chain's earlier part landed real home data the §4.1 upload
        elision would let this part's download clobber.
        Raises ``MemoryError`` (uncached) when no tile count fits, so
        ``run_chain`` can split."""
        cfg = self.cfg
        key = (plan_signature(loops, cfg.tiled_dim), cfg.num_tiles,
               cfg.num_slots, float(cfg.capacity), float(cfg.host_budget),
               tuple(sorted(cfg.pinned)), bool(cfg.cyclic),
               bool(cfg.prefetch), cfg.codec_key(), cfg.flops_per_point,
               tuple(sorted(keep_live)), halo, tuple(sorted(warm)))
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self.plan_hits += 1
            return plan
        if key in self._no_fit:   # negative cache: skip the doomed analysis
            raise MemoryError("chain cannot fit (cached verdict); splitting")
        shared_key = None
        if self.shared_plans is not None:
            # Same config knobs, tenant-neutral dataset identity: a plan
            # another executor (or tenant) built for an isomorphic chain
            # replays here once its ChainInfo is rebound to our datasets.
            shared_key = (shared_plan_signature(loops, cfg.tiled_dim),) + key[1:]
            cached = self.shared_plans.lookup(shared_key, self.tenant)
            if cached is not None:
                adopted = self._adopt_shared(cached, loops, key)
                if adopted is not None:
                    self._plans[key] = adopted
                    if len(self._plans) > self._max_plans:
                        self._plans.popitem(last=False)
                    self.plan_hits += 1
                    return adopted
        t0 = time.perf_counter()
        try:
            info = analyze_chain(loops, tiled_dim=cfg.tiled_dim)
            pinned_names = self.residency.pinned & frozenset(info.datasets)
            pinned_bytes = sum(info.datasets[n].nbytes for n in pinned_names)
            # The eager tile function's intermediates sit beside the slots on
            # the device: the tile count is the smallest whose slots, pinned
            # residency and workspace fit (``core/workspace.py``).
            if cfg.num_tiles:
                sched = make_tile_schedule(info, cfg.num_tiles)
                # Nothing to charge against an unbounded capacity.
                workspace = (self.workspaces.charge(
                    info, sched, pinned_names, cfg.num_slots)
                    if np.isfinite(cfg.capacity) else 0)
            else:
                sched, workspace = self.workspaces.fit_tiles(
                    info, cfg.capacity, cfg.num_slots, pinned_names,
                    pinned_bytes)
            slot_bytes = sched.slot_bytes(exclude=pinned_names)
            # Single capacity oracle for BOTH tiers: fast-memory overflow
            # raises (run_chain answers by splitting); host-RAM overflow is
            # a planning verdict — the chain's home working set spills to
            # the disk tier via FetchHome/SpillHome ops instead of dying.
            home_bytes = sum(d.nbytes for d in info.datasets.values())
            self.residency.check_fit(slot_bytes, pinned_bytes, workspace)
            spill_home = self.residency.host_overflow(home_bytes,
                                                      cfg.host_budget)
        except MemoryError:
            if len(self._no_fit) >= 8 * self._max_plans:
                self._no_fit.clear()
            self._no_fit.add(key)
            raise
        ir = build_plan(
            info, sched, num_slots=cfg.num_slots, cyclic=cfg.cyclic,
            prefetch=cfg.prefetch, spill_home=spill_home,
            keep_live=frozenset(keep_live), warm=frozenset(warm),
            pinned_names=pinned_names, codec_spec=cfg.codec,
            flops_per_point=cfg.flops_per_point, slot_bytes=slot_bytes,
            pinned_bytes=pinned_bytes, halo=halo,
        )
        # The engine is owned by the plan: it closes over the chain's kernels,
        # and the fingerprint in ``key`` keeps it consistent with them.
        plan = ChainPlan(
            key=key, info=info, sched=sched, engine=TileEngine(info),
            slot_bytes=slot_bytes, sig=chain_signature(info),
            plan_s=time.perf_counter() - t0, ir=ir,
            pinned_names=pinned_names, pinned_bytes=pinned_bytes,
            workspace_bytes=workspace,
        )
        self._plans[key] = plan
        if len(self._plans) > self._max_plans:
            self._plans.popitem(last=False)
        self.plan_misses += 1
        self.plan_time_s += plan.plan_s
        if shared_key is not None:
            self.shared_plans.insert(shared_key, plan, self.tenant)
        return plan

    def _adopt_shared(self, cp: ChainPlan, loops: Sequence[ParallelLoop],
                      key: Tuple) -> Optional[ChainPlan]:
        """Rebind a shared-cache ChainPlan to this chain's datasets.

        The Plan IR and tile schedule reference datasets by *name*, and the
        engine reads only names, halos, dtypes and the donor chain's kernels
        (value-identical to ours by the shared signature) from its chain,
        never a home: the data plane hands it the slot tensors.  So a
        shallow copy with ``info.datasets`` swapped to our Dataset objects is
        a complete rebind, and the interpreters stage from our homes.
        Returns None if the dataset name sets somehow disagree (signature
        collision paranoia — build fresh)."""
        dats = {}
        for lp in loops:
            for a in lp.args:
                dats.setdefault(a.dat.name, a.dat)
        if set(dats) != set(cp.info.datasets):
            return None
        if all(dats[n] is d for n, d in cp.info.datasets.items()):
            info = cp.info            # same tenant, different executor/lane
        else:
            info = replace(cp.info, datasets=dats)
        return ChainPlan(
            key=key, info=info, sched=cp.sched, engine=cp.engine,
            slot_bytes=cp.slot_bytes, sig=cp.sig, plan_s=0.0, ir=cp.ir,
            pinned_names=cp.pinned_names, pinned_bytes=cp.pinned_bytes,
            workspace_bytes=cp.workspace_bytes,
        )

    @property
    def plan_hit_rate(self) -> float:
        tot = self.plan_hits + self.plan_misses
        return self.plan_hits / tot if tot else 0.0

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        """Stop the transfer engine's worker threads.  Optional (they are
        daemons), but long-lived processes creating many executors should
        call it — or rely on this running at garbage collection."""
        self.transfer.close()

    def reset_data_caches(self) -> None:
        """Forget device-side cached *data* (pinned arrays, speculative
        prefetch captures) after home copies changed underneath the executor
        — ``Session.restore`` calls this so a resumed run cannot replay
        device state from before the checkpoint.  Plan caches survive: plans
        are data-independent."""
        self.residency._pinned_cache.clear()
        if self.device.type == "cuda":
            drop_pool(self.device, self, "_spec")   # its captures' pool
        self._spec = SpecState()

    def __del__(self):  # pragma: no cover - interpreter-shutdown timing
        try:
            self.close()
        except Exception:
            pass

    # -- main entry ------------------------------------------------------------
    def run_chain(self, loops: Sequence[ParallelLoop],
                  keep_live: frozenset = frozenset(), *,
                  plan: Optional[Plan] = None, halo=None,
                  warm: frozenset = frozenset()) -> Dict[str, np.ndarray]:
        """Plan one chain and interpret its instruction stream; if no tile
        count makes its slots fit fast memory (skew span exceeding the grid —
        long chains on small problems), split the chain and run the halves
        sequentially.  This is the runtime equivalent of OPS bounding the
        number of loops tiled across.

        ``plan`` replays an explicit (e.g. JSON-imported) instruction stream
        instead of the freshly-planned one; its signature hash must match
        the chain's.

        Splitting breaks the §4.1 Cyclic contract, so the halves carry
        ``keep_live``/``warm`` sets from :func:`~repro_torch.core.dependency.
        split_chain` (shared with ``Session._plan_split``).  That policy also
        keeps the whole chain's read-first datasets live in both halves,
        which the reference package's split does not: a split Cyclic chain
        plans differently from the reference's (and returns the reference
        backend's result where the reference package's loses data).  The
        halo exchange (``halo``, sharded execution) happens once at chain
        start, so the head keeps it; the tail re-reads rows the head already
        refreshed."""
        try:
            return self._interpret_chain(loops, keep_live, plan, halo, warm)
        except MemoryError:
            if len(loops) <= 1 or plan is not None:
                raise
            (head, h_live, h_warm), (tail, t_live, t_warm) = split_chain(
                loops, keep_live, warm)
            out = self.run_chain(head, h_live, halo=halo, warm=h_warm)
            # Both halves may contribute to the same reduction: combine, not
            # overwrite.
            specs = {r.name: r for lp in loops for r in lp.reductions}
            for name, val in self.run_chain(tail, t_live, warm=t_warm).items():
                out[name] = (np.asarray(specs[name].combine(out[name], val))
                             if name in out else val)
            return out

    def _interpret_chain(self, loops: Sequence[ParallelLoop],
                         keep_live: frozenset,
                         ir: Optional[Plan] = None,
                         halo=None,
                         warm: frozenset = frozenset()
                         ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        t_wall = time.perf_counter()
        tr = self.tracer
        chain_index = len(self.history)
        t_tr0 = tr.clock() if tr.enabled else 0.0
        n_cached = self.plan_hits
        cp = self.plan_chain(loops, keep_live, halo, warm=warm)
        cache_hit = self.plan_hits > n_cached
        if ir is None:
            ir = cp.ir
        elif ir.sig_hash != cp.ir.sig_hash:
            raise ValueError(
                "imported plan does not match this chain (signature hash "
                f"{ir.sig_hash[:12]} != {cp.ir.sig_hash[:12]})")
        elif (ir.num_tiles, ir.num_slots, ir.tiled_dim) != (
                cp.ir.num_tiles, cp.ir.num_slots, cp.ir.tiled_dim):
            # Same chain, different geometry: the imported op stream would be
            # bound to this config's tile schedule and fail far away inside
            # the transfer engine — reject it here with the real reason.
            raise ValueError(
                "imported plan does not match this config's tile geometry "
                f"(plan {ir.num_tiles} tiles x {ir.num_slots} slots, dim "
                f"{ir.tiled_dim}; config {cp.ir.num_tiles} x "
                f"{cp.ir.num_slots}, dim {cp.ir.tiled_dim})")
        verify_s = 0.0
        if cfg.debug:
            from .verify import verify_plan  # function-level: avoids a cycle

            t_verify = time.perf_counter()
            verify_plan(ir).raise_for_errors(
                f"chain {ir.sig_hash[:12]} (debug mode)")
            verify_s = time.perf_counter() - t_verify
        tx = self.transfer
        tx_before = tx.snapshot()
        # Disk-tier accounting: on data-plane runs the backing stores count
        # every byte that actually crossed the disk boundary (FetchHome /
        # SpillHome traffic AND lazy chunk-cache misses inside staging tasks).
        stores = {id(d.store): d.store for d in cp.info.datasets.values()}
        disk_before = {
            k: (s.stats["disk_bytes_read"], s.stats["disk_bytes_written"])
            for k, s in stores.items()}
        if cfg.simulate_only:
            interp = LedgerInterpreter(
                ir, cfg.hw, rm=self.residency, spec=self._spec,
                datasets=cp.info.datasets,
                tracer=tr, trace_tag=self.trace_tag,
                chain_index=chain_index)
        else:
            if self.device.type == "cuda":
                # Page-locked homes make the lanes' host copies asynchronous
                # (``Dataset.pin`` leaves disk-backed homes alone).
                for dat in cp.info.datasets.values():
                    dat.pin()
            interp = DataPlaneInterpreter(
                ir, cfg.hw, rm=self.residency, spec=self._spec, cp=cp, tx=tx,
                codecs=resolve_codecs(cfg.codec, tuple(cp.info.datasets)),
                device=self.device, streams=self.streams,
                halo_runtime=self.halo_runtime,
                tracer=tr, trace_tag=self.trace_tag,
                chain_index=chain_index)
        res = interp.run()
        graph_stats = {}
        if not cfg.simulate_only:
            for lane, sec in interp.copy_s.items():
                self.copy_s[lane] += sec
            graph_stats = interp.graph_stats
        if tr.enabled:
            self.ledgers.append(res.ledger)
            tr.emit("chain", cat="chain", track=self.trace_tag + "chain",
                    t_start=t_tr0, t_end=tr.clock(),
                    args={"chain": chain_index, "sig": ir.sig_hash[:12],
                          "tiles": ir.num_tiles, "cache_hit": cache_hit,
                          "mode": "sim" if cfg.simulate_only else "data"})
        tx_delta = tx.delta(tx.snapshot(), tx_before)
        raw_total = res.uploaded + res.downloaded
        wire_total = res.uploaded_wire + res.downloaded_wire
        if cfg.simulate_only:
            disk_read, disk_written = res.disk_read, res.disk_written
        else:
            disk_read = sum(
                s.stats["disk_bytes_read"] - disk_before[k][0]
                for k, s in stores.items())
            disk_written = sum(
                s.stats["disk_bytes_written"] - disk_before[k][1]
                for k, s in stores.items())
        self.history.append(
            ChainStats(
                num_tiles=ir.num_tiles,
                loop_bytes=ir.loop_bytes,
                uploaded=res.uploaded,
                downloaded=res.downloaded,
                edge_bytes=res.edge_bytes,
                prefetch_hits=res.prefetch_hits,
                wall_s=time.perf_counter() - t_wall,
                modelled_s=res.makespan,
                achieved_bw_model=(ir.loop_bytes / res.makespan
                                   if res.makespan else 0.0),
                slot_bytes=cp.slot_bytes,
                plan_cache_hit=cache_hit,
                plan_s=0.0 if cache_hit else cp.plan_s,
                verify_s=verify_s,
                uploaded_wire=res.uploaded_wire,
                downloaded_wire=res.downloaded_wire,
                compression_ratio=(raw_total / wire_total
                                   if wire_total else 1.0),
                queue_wait_s=tx_delta.get("queue_wait_s", 0.0),
                transfer_mode=tx.mode,
                op_counts=ir.counts(),
                disk_read=disk_read,
                disk_written=disk_written,
                halo_messages=res.halo_messages,
                halo_bytes=res.halo_bytes,
                **graph_stats,
                workspace_bytes=cp.workspace_bytes,
            )
        )
        return res.reductions

    # -- aggregate metrics -----------------------------------------------------
    def average_bandwidth_model(self) -> float:
        """The paper's 'Average Bandwidth' over everything run so far."""
        tot_b = sum(c.loop_bytes for c in self.history)
        tot_t = sum(c.modelled_s for c in self.history)
        return tot_b / tot_t if tot_t else 0.0

    def transfer_stats(self) -> Dict[str, float]:
        """Transfer-subsystem totals over everything run so far: raw vs wire
        bytes each direction, the achieved compression ratio, and queue-wait
        (submit-to-start latency; real queueing in threaded mode, a few
        microseconds of inline dispatch overhead per task in sync mode)."""
        up_raw = sum(c.uploaded for c in self.history)
        dn_raw = sum(c.downloaded for c in self.history)
        up_wire = sum(c.uploaded_wire for c in self.history)
        dn_wire = sum(c.downloaded_wire for c in self.history)
        wire = up_wire + dn_wire
        rs = self.residency.stats
        return {
            "mode": self.transfer.mode,
            "bytes_up_raw": up_raw,
            "bytes_down_raw": dn_raw,
            "bytes_up_wire": up_wire,
            "bytes_down_wire": dn_wire,
            "bytes_moved_wire": wire,
            "compression_ratio": (up_raw + dn_raw) / wire if wire else 1.0,
            "queue_wait_s": sum(c.queue_wait_s for c in self.history),
            "elided_rows": rs["elided_rows"],
            "evictions": rs["evictions"],
            "pinned_hits": rs["pinned_hits"],
            # disk tier (repro_torch.core.store): bytes across the disk
            # boundary (the stores' counters on the data plane) and the
            # FetchHome/SpillHome ops the disk lane ran
            "bytes_disk_read": sum(c.disk_read for c in self.history),
            "bytes_disk_written": sum(c.disk_written for c in self.history),
            "home_fetches": sum(c.op_counts.get("home_fetches", 0)
                                for c in self.history),
            "home_spills": sum(c.op_counts.get("home_spills", 0)
                               for c in self.history),
            # device mesh (repro_torch.core.sharded): halo-exchange traffic
            "halo_messages": sum(c.halo_messages for c in self.history),
            "halo_bytes": sum(c.halo_bytes for c in self.history),
            # per-lane queue-wait / service-time histograms straight from the
            # TransferHandle timestamps ({lane: {"queue_wait": snap, ...}})
            "lanes": self.transfer.lane_stats(),
            # the lanes' copy time on the device alone (CUDA events)
            "copy_s": dict(self.copy_s),
            # the tile function as CUDA graphs (ChainStats.graph_*, summed)
            **{f: sum(getattr(c, f) for c in self.history) for f in GRAPH_FIELDS},
        }


class ResidentExecutor:
    """Paper baseline: all datasets live in fast memory for the whole run.

    Implemented as the 1-tile schedule with an up-front capacity check; the
    ledger charges one initial upload per dataset (amortised across chains:
    subsequent chains reuse resident data, as in the paper's setup) and no
    per-chain traffic.
    """

    def __init__(self, hw: HardwareModel = H100,
                 capacity_bytes: Optional[float] = None, device: str = "cuda"):
        self.hw = hw
        self.capacity = capacity_bytes if capacity_bytes is not None else hw.fast_capacity
        self._resident: Set[str] = set()
        self._resident_bytes = 0
        self._inner = OutOfCoreExecutor(
            OOCConfig(hw=hw, capacity_bytes=float("inf"), num_tiles=1, num_slots=1,
                      device=device)
        )
        self.history = self._inner.history

    def run_chain(self, loops: Sequence[ParallelLoop]) -> Dict[str, np.ndarray]:
        # Capacity check needs only the touched-dataset set — enumerating
        # args directly keeps the inner planner's cache stats honest (one
        # plan per chain, not a self-inflicted hit per run).
        for lp in loops:
            for arg in lp.args:
                if arg.dat.name not in self._resident:
                    self._resident.add(arg.dat.name)
                    self._resident_bytes += arg.dat.nbytes
        if self._resident_bytes > self.capacity:
            raise MemoryError(
                f"resident set {self._resident_bytes}B exceeds fast memory "
                f"{self.capacity}B — the paper's segfault, reproduced politely"
            )
        reds = self._inner.run_chain(loops)
        # Resident baseline: per-chain link traffic doesn't apply; replace the
        # modelled time with pure compute time.
        last = self.history[-1]
        ledger = TransferLedger(self.hw)
        t = ledger.t_compute(last.loop_bytes, 0)
        last.modelled_s = max(t, 1e-30)
        last.achieved_bw_model = last.loop_bytes / last.modelled_s
        return reds

    # plan-cache stats proxy to the inner executor (shared planner)
    @property
    def tracer(self) -> AnyTracer:
        return self._inner.tracer

    @property
    def ledgers(self) -> List[TransferLedger]:
        return self._inner.ledgers

    @property
    def plan_hits(self) -> int:
        return self._inner.plan_hits

    @property
    def plan_misses(self) -> int:
        return self._inner.plan_misses

    @property
    def plan_time_s(self) -> float:
        return self._inner.plan_time_s

    @property
    def plan_hit_rate(self) -> float:
        return self._inner.plan_hit_rate

    def transfer_stats(self) -> Dict[str, float]:
        return self._inner.transfer_stats()

    def average_bandwidth_model(self) -> float:
        tot_b = sum(c.loop_bytes for c in self.history)
        tot_t = sum(c.modelled_s for c in self.history)
        return tot_b / tot_t if tot_t else 0.0
