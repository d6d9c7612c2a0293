"""Sharded out-of-core execution: the device mesh composed with tiling.

This is the execution model of the paper's §5.2 evaluation, made a
first-class backend: the grid is decomposed along ``shard_dim`` (default 1,
the *non*-tiled dimension) over a :class:`~repro_torch.core.mesh.DeviceMesh`;
every shard runs the ordinary out-of-core machinery — dependency analysis,
skewed tiles along dim 0, the typed Plan IR, the shared interpreters —
over its *extended region* (owned interval + redundant-compute skirt), and
the shards exchange one **accumulated-depth** halo per chain instead of one
per loop (the §5.2 message-aggregation trade-off).

Mechanics:

* Each shard owns a contiguous interval of the shard dimension plus a
  ``skirt`` of redundant rows toward interior neighbours
  (:func:`~repro_torch.core.mesh.shard_geometries`).  Loops are *localised* per
  shard: ranges clipped to the extended region, datasets swapped for
  shard-local homes, kernel ``coords()`` offset back to global coordinates
  so position-dependent kernels stay exact.  Reduction loops are clipped to
  the owned interval so global reductions are combined, not double-counted.
* A chain whose accumulated halo depth (sum of per-loop read extents along
  ``shard_dim``) exceeds the skirt is split into *segments* that fit, with
  one exchange per segment — the runtime equivalent of OPS bounding the
  number of loops tiled across (see PAPERS.md).
* The exchange itself is lowered into the Plan IR
  (``HaloPack``/``HaloExchange``/``HaloUnpack``,
  :func:`~repro_torch.core.plan.build_plan` with a
  :class:`~repro_torch.core.mesh.HaloSpec`), costed on the ledger's network
  stream per device, and executed by the per-device
  :class:`~repro_torch.core.interp.DataPlaneInterpreter` through the
  collective runtime installed here — host-side copies on a ``sim:N``
  virtual mesh, peer copies through
  :func:`~repro_torch.core.distributed.exchange_halos` on a ``cuda:N`` mesh
  of real cards.

Every shard gets its own :class:`~repro_torch.core.executor.OutOfCoreExecutor`
(per-device plan caches, residency, transfer engine, ledger), so
``Session.explain()`` reports genuinely per-device makespans and
``Session.tune()`` can enumerate shard counts.  On a ``sim:N`` mesh every
shard runs on the session's device; on a ``cuda:N`` mesh with a CUDA
session, shard ``s`` runs on card ``s``.

Ported from ``src/repro/core/sharded.py``.  What differs:

* the ``cuda:N`` exchange (:meth:`ShardedOutOfCoreExecutor._exchange_peer`)
  replaces the reference's ``ppermute`` under ``shard_map``; there is no
  jitted collective to cache;
* a shard-local home the executor writes (scatter, exchange) gets its
  ``version`` bumped, so the inner executors' device caches keyed on it
  (speculative-prefetch captures, pinned arrays) never replay rows from
  before the write;
* the MemoryError split of a shard's segment takes its halves from
  :func:`~repro_torch.core.dependency.split_chain`, as
  ``OutOfCoreExecutor.run_chain`` does (fault C1 is fixed there).

Host copies and in-flight lanes: scatter, gather and the host-path exchange
read and write the shard-local homes on the host between inner
``run_chain`` calls, and each of those returns only after its transfer
engine has drained and its compute stream has finished
(``DataPlaneInterpreter.finish``), so no download is still landing and no
upload still reading when a mesh copy runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import torch

from .block import Block
from .dataset import Dataset, torch_dtype
from .dependency import loop_kernel_fingerprint, split_chain
from .distributed import HaloExchangeStats, _band, exchange_halos
from .executor import GRAPH_FIELDS, ChainStats, OOCConfig, OutOfCoreExecutor
from .loop import Accessor, Arg, ParallelLoop
from .mesh import DeviceMesh, HaloSpec, MeshError, ShardGeometry, shard_geometries
from ..obs.metrics import merge_histogram_snapshots
from ..obs.tracer import as_tracer

# Cap on the auto-sized redundant-compute skirt (rows per interior side).
# The skirt targets the deepest chain's accumulated halo depth (CloverLeaf's
# 51-loop timestep accumulates ~40 rows) so one exchange covers the whole
# chain; this cap bounds the redundant memory/compute on very long chains,
# and ``min_width - halo`` clamps it on narrow shards.  Override with
# ``halo_depth=``.
DEFAULT_MAX_SKIRT = 64


class ShardingError(MeshError):
    """The chain cannot be decomposed over the requested mesh."""


def loop_halo_extent(lp: ParallelLoop, dim: int) -> int:
    """Max |read offset| of one loop along ``dim`` — its halo-depth cost."""
    e = 0
    for arg in lp.args:
        if arg.mode.reads:
            e = max(e, arg.stencil.max_abs_extent(dim))
    return e


def split_segments(loops: Sequence[ParallelLoop], dim: int,
                   budget: int) -> List[List[ParallelLoop]]:
    """Split a chain into segments whose accumulated halo depth (sum of
    per-loop read extents along ``dim``) fits ``budget`` — one exchange per
    segment keeps every shard's owned interval valid.

    A loop that both writes datasets *and* carries reductions ends its
    segment: its writes are clipped to the owned interval (reduction
    correctness), so later loops may only read them after an exchange."""
    segs: List[List[ParallelLoop]] = []
    cur: List[ParallelLoop] = []
    acc = 0
    for lp in loops:
        e = loop_halo_extent(lp, dim)
        if e > budget:
            raise ShardingError(
                f"loop {lp.name!r} reads {e} rows along shard dim {dim} but "
                f"the redundant-compute skirt is only {budget} rows — use "
                f"fewer devices or a larger halo_depth")
        if cur and acc + e > budget:
            segs.append(cur)
            cur, acc = [], 0
        cur.append(lp)
        acc += e
        if lp.reductions and any(a.mode.writes for a in lp.args):
            segs.append(cur)
            cur, acc = [], 0
    if cur:
        segs.append(cur)
    return segs


# -- kernel re-basing --------------------------------------------------------------


class _OffsetAccessor(Accessor):
    """Proxy accessor adding a constant offset to ``coords()`` so kernels of
    a localised loop still see *global* grid coordinates (position-dependent
    kernels — initialisation fields, coordinate-based forcing — stay exact
    under decomposition).  ``device`` is forwarded: kernels make fresh
    tensors on ``acc.device``, which must be the shard's device."""

    def __init__(self, inner: Accessor, offsets: Tuple[int, ...]):
        self._inner = inner
        self._offsets = offsets

    @property
    def shape(self):
        return self._inner.shape

    @property
    def device(self):
        return self._inner.device

    def coords(self):
        return tuple(c + o if o else c
                     for c, o in zip(self._inner.coords(), self._offsets))

    def __call__(self, name, offset=None):
        return self._inner(name, offset)


def shift_kernel(kernel, offsets: Tuple[int, ...]):
    """Wrap ``kernel`` so its accessor reports global coordinates."""

    def sharded_kernel(acc):
        return kernel(_OffsetAccessor(acc, offsets))

    return sharded_kernel


# -- per-block shard state ---------------------------------------------------------


class _ShardState:
    """Everything one global block's decomposition owns: per-shard local
    blocks and datasets (created once, so per-shard plan caches hit across
    timesteps), plus home-copy version tracking for scatter/gather."""

    def __init__(self, block: Block, mesh: DeviceMesh, shard_dim: int,
                 skirt: int):
        self.block = block
        self.mesh = mesh
        self.shard_dim = shard_dim
        self.skirt = skirt
        self.geos: List[ShardGeometry] = shard_geometries(
            block.size[shard_dim], mesh.num_devices, skirt)
        self.blocks: List[Block] = []
        for geo in self.geos:
            size = list(block.size)
            size[shard_dim] = geo.ext_size
            self.blocks.append(
                Block(f"{block.name}@{mesh.spec}/{geo.index}", tuple(size)))
        self.globals: Dict[str, Dataset] = {}       # name -> global dataset
        self.locals: Dict[str, List[Dataset]] = {}  # name -> per-shard homes
        self.versions: Dict[str, int] = {}          # global version at sync
        self.min_width = min(g.width for g in self.geos)
        # The device path stacks uniform per-device blocks, as the
        # reference's collective does; uneven shard widths fall back to host
        # copies for THIS block only.
        self.uniform = len({g.width for g in self.geos}) == 1

    def ensure_local(self, gdat: Dataset) -> List[Dataset]:
        name = gdat.name
        if self.globals.get(name) is not gdat:
            # New (or replaced) global dataset: rebuild the local homes.
            self.globals[name] = gdat
            self.locals.pop(name, None)
            self.versions.pop(name, None)
        if name in self.locals:
            return self.locals[name]
        sd = self.shard_dim
        h_lo, h_hi = gdat.halo[sd]
        if self.skirt + max(h_lo, h_hi) > self.min_width:
            raise ShardingError(
                f"dataset {name!r}: skirt {self.skirt} + halo "
                f"{max(h_lo, h_hi)} exceeds the narrowest shard width "
                f"{self.min_width} — use fewer devices or a smaller "
                f"halo_depth")
        self.locals[name] = [
            Dataset(block=self.blocks[s], name=name, dtype=gdat.dtype,
                    halo=gdat.halo)
            for s in range(len(self.geos))
        ]
        return self.locals[name]

    def row_bytes(self, name: str) -> int:
        """Bytes per shard-dim row of a local home (identical across shards:
        only the shard dimension is decomposed)."""
        dat = self.locals[name][0]
        other = 1
        for d, s in enumerate(dat.padded_shape):
            if d != self.shard_dim:
                other *= s
        return other * dat.dtype.itemsize

    def transfers(self, name: str):
        """Directed boundary copies one exchange performs for ``name``:
        ``(src_shard, dst_shard, global_lo, global_hi)`` — each interior
        boundary refreshes the downstream shard's full stale region (skirt +
        dataset halo) from the upstream shard's *owned* rows."""
        sd = self.shard_dim
        h_lo, h_hi = self.globals[name].halo[sd]
        out = []
        for s in range(len(self.geos) - 1):
            b = self.geos[s].hi  # == geos[s+1].lo
            out.append((s, s + 1, b - self.skirt - h_lo, b))
            out.append((s + 1, s, b, b + self.skirt + h_hi))
        return out


# -- the sharded executor ----------------------------------------------------------


@dataclass
class ShardedChainPlan:
    """Per-device Plan IRs for one chain (segments x shards, stream order).
    ``Session.plan()`` flattens ``ir`` so every device's instruction stream
    is inspectable/exportable individually."""

    ir: Tuple


class ShardedOutOfCoreExecutor:
    """One executor per mesh device, one accumulated-depth exchange per
    chain segment; a drop-in ``run_chain`` backend."""

    def __init__(self, config: OOCConfig = None, *,
                 mesh: DeviceMesh = None, shard_dim: int = 1,
                 halo_depth: Optional[int] = None):
        self.cfg = config or OOCConfig()
        self.mesh = mesh or DeviceMesh.sim(1)
        self.shard_dim = shard_dim
        self.halo_depth = halo_depth
        # A cuda:N mesh on a CUDA session puts shard s on card s; every
        # other mesh keeps its shards on the session's device.
        devices = [None] * self.mesh.num_devices
        if (self.mesh.kind == "cuda" and not self.cfg.simulate_only
                and torch.device(self.cfg.device).type == "cuda"):
            devices = self.mesh.torch_devices()
        # The inner executors share THIS config object (the Session's cyclic
        # toggle and tuner overrides reach every device).
        self.inner: List[OutOfCoreExecutor] = [
            OutOfCoreExecutor(self.cfg, device=dev) for dev in devices
        ]
        # One tracing spine for the whole mesh: each device's executor emits
        # onto the shared tracer under a ``devN/`` track prefix (so Perfetto
        # shows per-device compute/upload/download swim-lanes), and the mesh
        # itself gets scatter/gather/exchange spans on a ``mesh`` track.
        self.tracer = as_tracer(self.cfg.trace)
        self.trace_tag = ""
        for i, ex in enumerate(self.inner):
            ex.tracer = self.tracer
            ex.trace_tag = f"dev{i}/"
        self.history: List[ChainStats] = []
        # Achieved (data-plane) exchange traffic, counted by the collective
        # runtime; the modelled counterpart is summed over ChainStats.
        self.halo_stats = HaloExchangeStats()
        self.exchange_path = "peer" if self.mesh.kind == "cuda" else "host"
        self._states: Dict[int, _ShardState] = {}

    # -- plumbing shared with the plain executor ------------------------------
    @property
    def plan_hits(self) -> int:
        return sum(ex.plan_hits for ex in self.inner)

    @property
    def plan_misses(self) -> int:
        return sum(ex.plan_misses for ex in self.inner)

    @property
    def plan_time_s(self) -> float:
        return sum(ex.plan_time_s for ex in self.inner)

    @property
    def plan_hit_rate(self) -> float:
        tot = self.plan_hits + self.plan_misses
        return self.plan_hits / tot if tot else 0.0

    def close(self) -> None:
        for ex in self.inner:
            ex.close()

    def reset_data_caches(self) -> None:
        for ex in self.inner:
            ex.reset_data_caches()
        # Home copies changed underneath us (Session.restore): re-scatter.
        for state in self._states.values():
            state.versions.clear()

    def transfer_stats(self) -> Dict[str, float]:
        stats = [ex.transfer_stats() for ex in self.inner]
        out: Dict[str, float] = {"mode": self.inner[0].transfer.mode}
        for key in stats[0]:
            if key in ("mode", "compression_ratio", "lanes", "copy_s"):
                continue
            out[key] = sum(s[key] for s in stats)
        # The lanes' device copy seconds add up per lane.
        out["copy_s"] = {lane: sum(s["copy_s"][lane] for s in stats)
                         for lane in stats[0]["copy_s"]}
        wire = out.get("bytes_moved_wire", 0)
        raw = out.get("bytes_up_raw", 0) + out.get("bytes_down_raw", 0)
        out["compression_ratio"] = raw / wire if wire else 1.0
        # Per-lane histograms fold across devices (fixed bucket bounds make
        # the snapshots mergeable) instead of summing like the scalars.
        lanes: Dict[str, Dict[str, dict]] = {}
        for s in stats:
            for lane, hists in s.get("lanes", {}).items():
                dst = lanes.setdefault(lane, {})
                for k, snap in hists.items():
                    dst[k] = merge_histogram_snapshots(dst.get(k, {}), snap)
        out["lanes"] = lanes
        return out

    def average_bandwidth_model(self) -> float:
        tot_b = sum(c.loop_bytes for c in self.history)
        tot_t = sum(c.modelled_s for c in self.history)
        return tot_b / tot_t if tot_t else 0.0

    def __del__(self):  # pragma: no cover - interpreter-shutdown timing
        try:
            self.close()
        except Exception:
            pass

    # -- decomposition ---------------------------------------------------------
    def _state_for(self, loops: Sequence[ParallelLoop]) -> _ShardState:
        """The block's decomposition, with the skirt auto-sized to the
        deepest chain seen so far: ideally the whole chain's accumulated
        halo depth fits one exchange (segmentation re-stages every segment's
        read footprint, which costs far more than skirt compute), clamped by
        the narrowest shard and ``DEFAULT_MAX_SKIRT``.  A deeper chain
        rebuilds the decomposition once (the global homes are authoritative
        between chains, so a rebuild is just a re-scatter)."""
        block = loops[0].block
        sd = self.shard_dim
        if sd >= block.ndim:
            raise ShardingError(
                f"shard_dim {sd} out of range for {block.ndim}-D block "
                f"{block.name!r}")
        h_max = max((max(a.dat.halo[sd]) for lp in loops
                     for a in lp.args), default=0)
        min_width = block.size[sd] // self.mesh.num_devices
        if min_width < 1:
            raise ShardingError(
                f"cannot shard extent {block.size[sd]} over "
                f"{self.mesh.num_devices} devices")
        if self.halo_depth is not None:
            skirt = self.halo_depth
        else:
            needed = sum(loop_halo_extent(lp, sd) for lp in loops)
            skirt = max(0, min(min_width - h_max, needed,
                               DEFAULT_MAX_SKIRT))
        state = self._states.get(id(block))
        if (state is not None and self.halo_depth is None
                and skirt > state.skirt):
            state = None      # deeper chain arrived: rebuild decomposition
        if state is None:
            state = _ShardState(block, self.mesh, sd, skirt)
            self._states[id(block)] = state
        for lp in loops:
            for a in lp.args:
                state.ensure_local(a.dat)
        return state

    def _localize(self, state: _ShardState, lp: ParallelLoop,
                  s: int) -> Optional[ParallelLoop]:
        """One shard's version of one loop: range clipped to the extended
        region (owned only, for reduction loops), shifted to local
        coordinates; args re-bound to the shard-local datasets; the kernel
        wrapped so coords() stays global.  None when the clip is empty."""
        geo = state.geos[s]
        sd = state.shard_dim
        n = state.mesh.num_devices
        a, b = lp.range_[sd]
        if lp.reductions:
            lo = max(a, geo.lo) if s > 0 else a
            hi = min(b, geo.hi) if s < n - 1 else b
        else:
            lo = max(a, geo.ext_lo) if s > 0 else a
            hi = min(b, geo.ext_hi) if s < n - 1 else b
        if hi <= lo:
            return None
        off = geo.ext_lo
        range_ = list(lp.range_)
        range_[sd] = (lo - off, hi - off)
        args = tuple(
            Arg(state.locals[arg.dat.name][s], arg.stencil, arg.mode)
            for arg in lp.args)
        kernel = lp.kernel if off == 0 else shift_kernel(
            lp.kernel, tuple(off if d == sd else 0
                             for d in range(lp.block.ndim)))
        local = ParallelLoop(
            name=lp.name, block=state.blocks[s], range_=tuple(range_),
            args=args, kernel=kernel, reductions=lp.reductions)
        # Plan-cache key stability: derive the local kernel fingerprint from
        # the (memoised) global one instead of re-walking the wrapper.
        local.__dict__["_kernel_fp"] = (
            "shard", off, sd, loop_kernel_fingerprint(lp))
        return local

    # -- scatter / exchange / gather -------------------------------------------
    def _scatter(self, state: _ShardState, names) -> None:
        """Global home -> shard-local homes (full extended region + halos)
        for datasets whose global copy changed since the last sync."""
        tr = self.tracer
        t_tr0 = tr.clock() if tr.enabled else 0.0
        moved = 0
        sd = state.shard_dim
        for name in names:
            gdat = state.globals[name]
            if state.versions.get(name) == gdat.version:
                continue
            h_lo, h_hi = gdat.halo[sd]
            for s, ldat in enumerate(state.locals[name]):
                geo = state.geos[s]
                vals = gdat.read_rows(sd, geo.ext_lo - h_lo,
                                      geo.ext_hi + h_hi)
                ldat.write_rows(sd, -h_lo, geo.ext_size + h_hi, vals)
                ldat.version += 1
                moved += vals.nbytes
            state.versions[name] = gdat.version
        if tr.enabled and moved:
            tr.emit("scatter", cat="mesh", track=self.trace_tag + "mesh",
                    t_start=t_tr0, t_end=tr.clock(), args={"bytes": moved})

    def _gather(self, state: _ShardState, names) -> None:
        """Shard-local owned rows -> global home.  Edge shards also own the
        global halo rows (their halo-mirror loops wrote them)."""
        tr = self.tracer
        t_tr0 = tr.clock() if tr.enabled else 0.0
        moved = 0
        sd = state.shard_dim
        n = state.mesh.num_devices
        extent = state.block.size[sd]
        for name in names:
            gdat = state.globals[name]
            h_lo, h_hi = gdat.halo[sd]
            for s, ldat in enumerate(state.locals[name]):
                geo = state.geos[s]
                lo = geo.lo if s > 0 else -h_lo
                hi = geo.hi if s < n - 1 else extent + h_hi
                vals = ldat.read_rows(sd, lo - geo.ext_lo, hi - geo.ext_lo)
                gdat.write_rows(sd, lo, hi, vals)
                moved += vals.nbytes
            state.versions[name] = gdat.version
        if tr.enabled and moved:
            tr.emit("gather", cat="mesh", track=self.trace_tag + "mesh",
                    t_start=t_tr0, t_end=tr.clock(), args={"bytes": moved})

    def _halo_spec(self, state: _ShardState, s: int,
                   names: Tuple[str, ...]) -> HaloSpec:
        """This device's plan-level exchange annotation (``names`` = the
        read set of ITS local segment); summing the per-device
        messages/bytes over the mesh reproduces the runtime totals exactly,
        because the collective refreshes precisely these per-device sets."""
        n = state.mesh.num_devices
        sd = state.shard_dim
        msgs = nbytes = 0
        h_max = 0
        for name in names:
            h_lo, h_hi = state.globals[name].halo[sd]
            h_max = max(h_max, h_lo, h_hi)
            rb = state.row_bytes(name)
            if s > 0:
                msgs += 1
                nbytes += (state.skirt + h_lo) * rb
            if s < n - 1:
                msgs += 1
                nbytes += (state.skirt + h_hi) * rb
        return HaloSpec(device=s, num_devices=n, shard_dim=sd,
                        depth=state.skirt + h_max, messages=msgs,
                        nbytes=nbytes, names=names)

    def _exchange(self, state: _ShardState,
                  names_by_shard: List[Tuple[str, ...]]) -> None:
        """The collective: refresh each participating shard's stale
        (non-owned) region of the datasets ITS segment reads from its
        neighbours' owned rows, counting achieved messages/bytes.
        Host-side copies on a virtual mesh; the ``exchange_halos`` peer
        copies on a ``cuda:N`` one.  Every refreshed home gets its version
        bumped."""
        if self.mesh.num_devices <= 1:
            return
        union = tuple(sorted({n for names in names_by_shard for n in names}))
        if not union:
            return
        tr = self.tracer
        t_tr0 = tr.clock() if tr.enabled else 0.0
        msgs0, bytes0 = self.halo_stats.messages, self.halo_stats.bytes
        peer = self.exchange_path == "peer" and state.uniform
        if peer:
            self._exchange_peer(state, union, names_by_shard)
        sd = state.shard_dim
        for name in union:
            locs = state.locals[name]
            rb = state.row_bytes(name)
            for src, dst, glo, ghi in state.transfers(name):
                if name not in names_by_shard[dst]:
                    continue  # that shard's segment never reads it
                if not peer:  # the peer path already landed them
                    vals = locs[src].read_rows(
                        sd, glo - state.geos[src].ext_lo,
                        ghi - state.geos[src].ext_lo)
                    locs[dst].write_rows(
                        sd, glo - state.geos[dst].ext_lo,
                        ghi - state.geos[dst].ext_lo, vals)
                    locs[dst].version += 1
                self.halo_stats.messages += 1
                self.halo_stats.bytes += (ghi - glo) * rb
        if tr.enabled:
            tr.emit("halo-exchange", cat="mesh",
                    track=self.trace_tag + "mesh",
                    t_start=t_tr0, t_end=tr.clock(),
                    args={"path": "peer" if peer else "host",
                          "messages": self.halo_stats.messages - msgs0,
                          "bytes": self.halo_stats.bytes - bytes0})

    def _exchange_peer(self, state: _ShardState, names,
                       names_by_shard) -> None:
        """The exchange of a ``cuda:N`` mesh: for each dataset, one buffer
        per shard of uniform width (owned rows in the centre, ``depth`` =
        skirt + dataset halo on each side) on ``torch_devices()[s]``, one
        ``exchange_halos(periodic=False)`` over them, and the received
        regions landed in the shard-local homes — exactly the host path's
        refresh regions (``state.transfers``), so accounting is
        path-independent.

        Only the two ``depth``-wide bands at the edges of each shard's owned
        rows are uploaded: they are all a neighbour receives, and the rest
        of the centre is never read.  The buffers go one dataset at a time,
        so the exchange holds one dataset's blocks on the cards at once."""
        sd = state.shard_dim
        geos = state.geos
        w = state.min_width
        devices = self.mesh.torch_devices()
        for name in names:
            gdat = state.globals[name]
            h_lo, h_hi = gdat.halo[sd]
            depth = state.skirt + max(h_lo, h_hi)
            shape = list(state.locals[name][0].padded_shape)
            shape[sd] = w + 2 * depth
            bufs = []
            for s, geo in enumerate(geos):
                ldat = state.locals[name][s]
                buf = torch.zeros(tuple(shape), dtype=torch_dtype(gdat.dtype),
                                  device=devices[s])
                for lo in (geo.lo, geo.hi - depth):
                    # Owned row g sits at buffer row depth + g - geo.lo.
                    vals = ldat.rows_tensor(sd, lo - geo.ext_lo,
                                            lo + depth - geo.ext_lo)
                    _band(buf, sd, depth + lo - geo.lo,
                          2 * depth + lo - geo.lo).copy_(vals)
                bufs.append({name: buf})
            exchange_halos(bufs, depth, dim=sd, periodic=False)
            for src, dst, glo, ghi in state.transfers(name):
                if name not in names_by_shard[dst]:
                    continue
                blo = depth + (glo - geos[dst].lo)
                got = _band(bufs[dst][name], sd, blo, blo + (ghi - glo))
                ldat = state.locals[name][dst]
                ldat.write_rows(sd, glo - geos[dst].ext_lo,
                                ghi - geos[dst].ext_lo, got.cpu())
                ldat.version += 1

    # -- main entry ------------------------------------------------------------
    def run_chain(self, loops: Sequence[ParallelLoop],
                  keep_live: frozenset = frozenset()):
        if self.mesh.num_devices == 1:
            # Degenerate mesh: exactly the unsharded executor (bit-identical
            # to the ``ooc`` backend by construction).
            before = len(self.inner[0].history)
            out = self.inner[0].run_chain(loops, keep_live)
            self.history.extend(self.inner[0].history[before:])
            return out
        state = self._state_for(loops)
        segments = split_segments(loops, self.shard_dim, state.skirt)
        sim = self.cfg.simulate_only
        if self.cfg.debug:
            # Per-plan verification happens inside each inner executor; this
            # adds the cross-device pass (exchange depth/message consistency
            # over every per-device plan of every segment).
            from .verify import verify_plans  # function-level: avoids a cycle

            verify_plans(self.plan_chain(loops, keep_live).ir
                         ).raise_for_errors("sharded chain (debug mode)")
        if not sim:
            self._scatter(state, sorted(
                {a.dat.name for lp in loops for a in lp.args}))
        specs = {r.name: r for lp in loops for r in lp.reductions}
        reductions: Dict[str, np.ndarray] = {}
        modified: Set[str] = set()
        accessed: Set[str] = set()
        not_elidable = self._chain_live_set(loops)
        for i, seg in enumerate(segments):
            tail_reads = frozenset(
                a.dat.name for later in segments[i + 1:] for lp in later
                for a in lp.args if a.mode.reads)
            self._run_segment(state, seg,
                              keep_live | tail_reads | not_elidable,
                              reductions, specs, sim, accessed)
            modified.update(a.dat.name for lp in seg for a in lp.args
                            if a.mode.writes)
            accessed.update(a.dat.name for lp in seg for a in lp.args)
        if not sim:
            self._gather(state, sorted(modified))
        return reductions

    def _localize_segment(self, state, seg):
        """Per-shard local loop lists and their read sets (what the exchange
        refreshes and the per-device plans annotate)."""
        locals_by_shard = []
        names_by_shard: List[Tuple[str, ...]] = []
        for s in range(self.mesh.num_devices):
            local = [loc for lp in seg
                     if (loc := self._localize(state, lp, s)) is not None]
            locals_by_shard.append(local)
            names_by_shard.append(tuple(sorted(
                {a.dat.name for lp in local for a in lp.args
                 if a.mode.reads})))
        return locals_by_shard, names_by_shard

    @staticmethod
    def _chain_live_set(loops: Sequence[ParallelLoop]) -> frozenset:
        """Datasets the §4.1 cyclic elision may NOT touch at segment level:
        everything that is not write-first over the *whole* chain.  A
        segment's local classification can turn a chain-read-first dataset
        (``reset_field`` writing ``xvel0`` in the last segment) into a
        segment-write-first one — eliding its download would leave the home
        rows stale for the next chain's halo exchange, which ``ooc-cyclic``
        on the unsegmented chain would never do."""
        first: Dict[str, bool] = {}
        for lp in loops:
            for a in lp.args:
                if a.dat.name not in first:
                    first[a.dat.name] = not a.mode.reads
        return frozenset(n for n, wf in first.items() if not wf)

    @staticmethod
    def _warm_set(local_seg, accessed_earlier: Set[str]) -> frozenset:
        """Write-first dats of this shard's segment whose home copies hold
        earlier-segment results: the §4.1 write-first upload elision would
        let this segment's full-width download clobber them (e.g. halo
        columns a clipped-out mirror loop wrote on another shard), so they
        stage like read-first data instead."""
        first: Dict[str, bool] = {}
        for lp in local_seg:
            for a in lp.args:
                if a.dat.name not in first:
                    first[a.dat.name] = not a.mode.reads  # pure WRITE first
        return frozenset(n for n, wf in first.items()
                         if wf and n in accessed_earlier)

    def _run_segment(self, state, seg, keep_live, reductions, specs,
                     sim, accessed_earlier: Set[str]) -> None:
        locals_by_shard, names_by_shard = self._localize_segment(state, seg)
        done = [False]

        def runtime(op=None):
            # One collective per segment epoch.  Interpreters executing
            # their HaloExchange ops route here; the pre-fire below already
            # ran it, so they see it done.
            if not done[0]:
                done[0] = True
                self._exchange(state, names_by_shard)

        # Pre-fire the collective at segment start: shards run sequentially,
        # so a shard whose local segment has no reads (hence no halo op)
        # must not mutate its owned rows before a later shard's exchange
        # sources them.
        if not sim and any(names_by_shard):
            runtime()
        seg_stats: List[List[ChainStats]] = []
        for s in range(self.mesh.num_devices):
            local = locals_by_shard[s]
            if not local:
                seg_stats.append([])
                continue
            halo = self._halo_spec(state, s, names_by_shard[s])
            warm = self._warm_set(local, accessed_earlier)
            ex = self.inner[s]
            before = len(ex.history)
            ex.halo_runtime = runtime
            try:
                reds = ex.run_chain(local, keep_live, halo=halo, warm=warm)
            finally:
                ex.halo_runtime = None
            seg_stats.append(ex.history[before:])
            for name, val in reds.items():
                if name in reductions:
                    reductions[name] = np.asarray(
                        specs[name].combine(reductions[name], val))
                else:
                    reductions[name] = np.asarray(val)
        self.history.append(self._aggregate(seg_stats))

    def _aggregate(self, per_shard: List[List[ChainStats]]) -> ChainStats:
        """One mesh-level ChainStats per segment: traffic sums over devices,
        modelled time = the slowest device (they run concurrently)."""
        flat = [c for stats in per_shard for c in stats]
        modelled = max((sum(c.modelled_s for c in stats)
                        for stats in per_shard if stats), default=0.0)
        loop_bytes = sum(c.loop_bytes for c in flat)
        op_counts: Dict[str, int] = {}
        for c in flat:
            for k, v in c.op_counts.items():
                op_counts[k] = op_counts.get(k, 0) + v
        raw = sum(c.uploaded + c.downloaded for c in flat)
        wire = sum(c.uploaded_wire + c.downloaded_wire for c in flat)
        return ChainStats(
            num_tiles=max((c.num_tiles for c in flat), default=0),
            loop_bytes=loop_bytes,
            uploaded=sum(c.uploaded for c in flat),
            downloaded=sum(c.downloaded for c in flat),
            edge_bytes=sum(c.edge_bytes for c in flat),
            prefetch_hits=sum(c.prefetch_hits for c in flat),
            wall_s=sum(c.wall_s for c in flat),
            modelled_s=modelled,
            achieved_bw_model=loop_bytes / modelled if modelled else 0.0,
            slot_bytes=max((c.slot_bytes for c in flat), default=0),
            workspace_bytes=max((c.workspace_bytes for c in flat), default=0),
            plan_cache_hit=all(c.plan_cache_hit for c in flat) if flat
            else False,
            plan_s=sum(c.plan_s for c in flat),
            verify_s=sum(c.verify_s for c in flat),
            uploaded_wire=sum(c.uploaded_wire for c in flat),
            downloaded_wire=sum(c.downloaded_wire for c in flat),
            compression_ratio=raw / wire if wire else 1.0,
            queue_wait_s=sum(c.queue_wait_s for c in flat),
            transfer_mode=flat[0].transfer_mode if flat else "sync",
            op_counts=op_counts,
            disk_read=sum(c.disk_read for c in flat),
            disk_written=sum(c.disk_written for c in flat),
            halo_messages=sum(c.halo_messages for c in flat),
            halo_bytes=sum(c.halo_bytes for c in flat),
            **{f: sum(getattr(c, f) for c in flat) for f in GRAPH_FIELDS},
        )

    # -- planning (Session.plan / explain / tune) ------------------------------
    def plan_chain(self, loops: Sequence[ParallelLoop],
                   keep_live: frozenset = frozenset(), *,
                   warm: frozenset = frozenset()):
        """Per-device Plan IRs (segments x shards) without executing or
        moving any data — what ``Session.plan()``/``explain()`` flatten into
        device-annotated instruction streams."""
        if self.mesh.num_devices == 1:
            return self.inner[0].plan_chain(loops, keep_live, warm=warm)
        state = self._state_for(loops)
        segments = split_segments(loops, self.shard_dim, state.skirt)
        plans = []
        accessed: Set[str] = set(warm)
        not_elidable = self._chain_live_set(loops)
        for i, seg in enumerate(segments):
            tail_reads = frozenset(
                a.dat.name for later in segments[i + 1:] for lp in later
                for a in lp.args if a.mode.reads)
            locals_by_shard, names_by_shard = self._localize_segment(
                state, seg)
            for s in range(self.mesh.num_devices):
                if not locals_by_shard[s]:
                    continue
                halo = self._halo_spec(state, s, names_by_shard[s])
                seg_warm = self._warm_set(locals_by_shard[s], accessed)
                plans.extend(self._plan_local(
                    self.inner[s], locals_by_shard[s],
                    keep_live | tail_reads | not_elidable,
                    halo, seg_warm))
            accessed.update(a.dat.name for lp in seg for a in lp.args)
        return ShardedChainPlan(ir=tuple(plans))

    def _plan_local(self, ex: OutOfCoreExecutor, local, keep_live, halo,
                    warm) -> List:
        """Plan one shard's local segment, mirroring ``run_chain``'s
        MemoryError split exactly (the halo stays with the head; the halves'
        live and warm sets come from
        :func:`~repro_torch.core.dependency.split_chain`, which
        ``OutOfCoreExecutor.run_chain`` and ``Session._plan_split`` call
        too) — so ``Session.plan()``/``explain()`` show the instruction
        streams execution will replay, and the plan cache is primed with the
        same keys."""
        try:
            return [ex.plan_chain(local, keep_live, halo, warm=warm).ir]
        except MemoryError:
            if len(local) <= 1:
                raise
            (head, h_live, h_warm), (tail, t_live, t_warm) = split_chain(
                local, keep_live, warm)
            return (self._plan_local(ex, head, h_live, halo, h_warm)
                    + self._plan_local(ex, tail, t_live, None, t_warm))
