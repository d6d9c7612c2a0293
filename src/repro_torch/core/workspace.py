"""The tile function's device workspace, charged to the out-of-core plan.

The reference's tile function is one XLA program (``jax.jit(tile_fn)``),
and its planner charges only the slots and the pinned residency to the
device's capacity (``src/repro/core/tiling.py::choose_num_tiles``,
``executor.py::plan_chain``).  The port's tile function
(:meth:`~repro_torch.core.engine.TileEngine.tile_fn`) is eager torch ops:
every intermediate of every loop kernel is a tensor of the loop's box, and
on the card those tensors sit beside the slots.  Uncharged, an out-of-core
run of CloverLeaf 2D peaked at 1.29 times its planned capacity on the H100.

The *workspace* of a tile is the peak bytes of the tensors its tile function
creates beyond the tensors it is given (the slot and pinned tensors): every
eager intermediate, kernel output and reduction.  :class:`LiveBytes` counts
them at the dispatcher, each new storage once, as the caching allocator
holds it (:func:`device_bytes`), and releases it when the storage dies.
:meth:`Workspaces.chain_workspace` runs the tile function on the ``meta``
device (no data, no host sync, no allocation) at the schedule's slot shapes
and takes the largest tile's peak.  The executor charges it, with the
allocator's rounding of the slot and pinned tensors, beside the slots and
the pinned residency, and picks the smallest tile count where all of it
fits (:meth:`Workspaces.fit_tiles`, from
:meth:`~repro_torch.core.executor.OutOfCoreExecutor.plan_chain`); the same
charge holds on every device, so CPU and card plans are the same.

The peak depends on each active loop's box and on which loops are active,
that is on the tile's signature (:meth:`TileEngine.signature`), and on the
chain's structure and kernel code, not on values a kernel captures
(CloverLeaf's ``dt`` changes every step): the memos are keyed on those.

What else an out-of-core run holds on the card, and why none of it is a
second workspace:

* the tile graphs' warm-ups and captures share the run's one pool
  (:mod:`repro_torch.core.tile_graph`), so one workspace serves both;
* each slot is one block (:func:`one_block`), so blocks of changing sizes
  do not fragment the allocator under a hard cap;
* the speculative prefetch's captures are copied into the first slot as
  soon as it exists and dropped before the other slots are made, and are
  made only after the last chain's slots are freed;
* a one-slot pool's edge carry clones one dataset's edge rows between
  tiles, charged where it is larger than the workspace; with more slots an
  edge carry copies between slots and allocates nothing.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .dataset import torch_dtype
from .dependency import ChainInfo
from .engine import TileEngine, _fresh_start
from .tiling import TileSchedule, choose_num_tiles, make_tile_schedule

# What the CUDA caching allocator holds for a tensor.  A block of up to
# 1 MiB is cut from a shared 2 MiB segment in multiples of 512 bytes.  A
# larger one is cut from a free block of the large pool, whose remainder
# stays with it when it is 1 MiB or less, or from a new segment: a shared
# 20 MiB one below 10 MiB, one of its own in multiples of 2 MiB from there.
SMALL, SMALL_ROUND, LARGE, LARGE_ROUND = 1 << 20, 512, 10 << 20, 2 << 20


def _up(nbytes: int, step: int) -> int:
    return -(-int(nbytes) // step) * step


def device_bytes(nbytes: int) -> int:
    """At most the bytes the caching allocator holds for a tensor of
    ``nbytes`` (a shared segment's slack aside)."""
    if nbytes <= SMALL:
        return _up(nbytes, SMALL_ROUND)
    held = _up(nbytes, SMALL_ROUND) + SMALL
    return max(held, _up(nbytes, LARGE_ROUND)) if nbytes >= LARGE else held


class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the storages created by the ops run under it.

    A storage an op returns that no op has seen before counts once, as
    :func:`device_bytes`, until it dies; a view or an in-place result adds
    nothing.  Storages an op reads that were made outside the mode (the
    slots, captured tensors) never count."""

    def __init__(self):
        super().__init__()
        self._known: Dict[int, int] = {}   # storage -> its counted bytes (0: not ours)
        self.live = 0
        self.peak = 0

    def _forget(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)

    def _see(self, t: torch.Tensor, counted: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        nb = device_bytes(st.nbytes()) if counted else 0
        self._known[key] = nb
        weakref.finalize(st, self._forget, key)
        if nb:
            self.live += nb
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                self._see(t, counted=False)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._see(t, counted=True)
        return out


def slot_tensors(sched: TileSchedule, pinned: Iterable[str],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty tensors of the run's shapes: a slot's (each dataset's max
    footprint in the tiled dim) and the pinned datasets' whole arrays."""
    info = sched.chain
    pinned = frozenset(pinned)
    out = {}
    for name, dat in info.datasets.items():
        shape = list(dat.padded_shape)
        if name not in pinned:
            if name not in sched.max_fp_len:
                continue
            shape[info.tiled_dim] = sched.max_fp_len[name]
        out[name] = torch.empty(tuple(shape), dtype=torch_dtype(dat.dtype),
                                device=device)
    return out


def tile_origins(sched: TileSchedule, t: int,
                 pinned: Iterable[str]) -> Dict[str, int]:
    """Tile ``t``'s slot origins (``build_plan``'s ``tile_origins``) and the
    pinned arrays' (minus their low halo)."""
    info = sched.chain
    org = {name: iv.lo for name, iv in sched.tiles[t].footprint.items()
           if not iv.empty}
    for name in pinned:
        org[name] = -info.datasets[name].halo[info.tiled_dim][0]
    return org


def _block(specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
           ) -> Tuple[List[int], List[int], int]:
    """Offsets, byte sizes and total of ``specs`` laid out 512-byte aligned
    in one block."""
    offsets, sizes, total = [], [], 0
    for shape, dtype in specs:
        nb = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        offsets.append(total)
        sizes.append(nb)
        total += _up(nb, SMALL_ROUND)
    return offsets, sizes, total


def one_block(specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
              device: torch.device) -> List[torch.Tensor]:
    """Zero-filled tensors of ``specs`` (shape, dtype), as views of one
    allocation (``_block``'s layout).  The caching allocator then holds one
    block where it would hold one per dataset: under a hard cap on device
    memory, many blocks of sizes that change from chain to chain fragment
    it.  A slot is one block, and so are the prefetch captures."""
    offsets, sizes, total = _block(specs)
    buf = torch.zeros(total, dtype=torch.uint8, device=device)
    return [buf[o:o + nb].view(dtype).view(shape)
            for o, nb, (shape, dtype) in zip(offsets, sizes, specs)]


def rounding_bytes(sched: TileSchedule, pinned: Iterable[str],
                   num_slots: int) -> int:
    """What the allocator holds beyond the slot and pinned bytes the plan
    counts: each slot's one block (:func:`one_block`) and each pinned array
    rounded up."""
    pinned = frozenset(pinned)
    extra, specs = 0, []
    for name, t in slot_tensors(sched, pinned, torch.device("meta")).items():
        if name in pinned:
            nb = t.untyped_storage().nbytes()
            extra += device_bytes(nb) - nb
        else:
            specs.append((tuple(t.shape), t.dtype))
    if specs:
        _, sizes, total = _block(specs)
        extra += num_slots * (device_bytes(total) - sum(sizes))
    return extra


def measure_tile(engine: TileEngine, sched: TileSchedule, t: int,
                 slots: Dict[str, torch.Tensor], pinned: Iterable[str]) -> int:
    """Peak workspace bytes of tile ``t`` run eagerly on ``slots``."""
    tile = sched.tiles[t]
    device = next(iter(slots.values())).device
    mode = LiveBytes()
    with mode:
        reds = engine.tile_fn(tile, slots, tile_origins(sched, t, pinned),
                              _fresh_start(device))
    del reds
    return mode.peak


def _code(fn) -> object:
    return getattr(fn, "__code__", None) or type(fn)


def structure_key(info: ChainInfo) -> Tuple:
    """What the workspace depends on besides the tile: the chain's loops,
    ranges, dataset layouts, stencils, modes, reductions and kernel code;
    no captured value (``chain_sig_hash`` leaves them out too)."""
    return (info.tiled_dim,) + tuple(
        (lp.name, lp.range_,
         tuple((a.dat.name, tuple(a.dat.block.size), tuple(a.dat.halo),
                a.dat.dtype.str, a.stencil.points, a.mode.value) for a in lp.args),
         tuple((r.name, r.op) for r in lp.reductions),
         _code(lp.kernel))
        for lp in info.loops)


def _carry_clone(sched: TileSchedule) -> int:
    """A one-slot pool's edge carry clones one dataset's edge rows at a
    time (``DataPlaneInterpreter.copy_edges``), between tiles."""
    info = sched.chain
    td = info.tiled_dim
    most = 0
    for tile in sched.tiles:
        for name, iv in tile.edge_to_next.items():
            if iv.empty:
                continue
            dat = info.datasets[name]
            row = dat.dtype.itemsize
            for d, s in enumerate(dat.padded_shape):
                if d != td:
                    row *= s
            most = max(most, device_bytes(iv.length * row))
    return most


class Workspaces:
    """An executor's workspace planner: what the tile function holds on the
    device, and the tile count that leaves room for it.  Its two memos
    (bounded, oldest out first) live as long as the executor."""

    MAX_ENTRIES = 4096

    def __init__(self):
        self._peaks: "OrderedDict[Tuple, int]" = OrderedDict()
        self._tiles: "OrderedDict[Tuple, int]" = OrderedDict()
        self._lock = threading.Lock()

    def _get(self, memo: OrderedDict, key: Tuple):
        with self._lock:
            got = memo.get(key)
            if got is not None:
                memo.move_to_end(key)
            return got

    def _put(self, memo: OrderedDict, key: Tuple, value: int) -> None:
        with self._lock:
            memo[key] = value
            if len(memo) > self.MAX_ENTRIES:
                memo.popitem(last=False)

    def chain_workspace(self, info: ChainInfo, sched: TileSchedule,
                        pinned: Iterable[str] = (), num_slots: int = 3, *,
                        key: Tuple = None) -> int:
        """The largest tile's workspace bytes over ``sched``, from the tile
        function run on the ``meta`` device, memoised per structure and tile
        signature; with one slot, at least the edge carry's clone.  ``key``
        is :func:`structure_key` of ``info`` when the caller has it."""
        pinned = frozenset(pinned)
        key = structure_key(info) if key is None else key
        engine = TileEngine(info)
        slots = None
        peak = _carry_clone(sched) if num_slots == 1 else 0
        for t, tile in enumerate(sched.tiles):
            mkey = (key, pinned, TileEngine.signature(tile))
            got = self._get(self._peaks, mkey)
            if got is None:
                if slots is None:
                    slots = slot_tensors(sched, pinned, torch.device("meta"))
                got = measure_tile(engine, sched, t, slots, pinned)
                self._put(self._peaks, mkey, got)
            peak = max(peak, got)
        return peak

    def charge(self, info: ChainInfo, sched: TileSchedule,
               pinned: Iterable[str] = (), num_slots: int = 3, *,
               key: Tuple = None) -> int:
        """What the plan charges beyond its slot and pinned bytes: the
        workspace (:meth:`chain_workspace`) and the allocator's rounding of
        the slot and pinned tensors (:func:`rounding_bytes`)."""
        pinned = frozenset(pinned)
        return (self.chain_workspace(info, sched, pinned, num_slots, key=key)
                + rounding_bytes(sched, pinned, num_slots))

    def fit_tiles(self, info: ChainInfo, capacity: float, num_slots: int,
                  pinned: Iterable[str] = (), pinned_bytes: int = 0
                  ) -> Tuple[TileSchedule, int]:
        """The smallest tile count whose ``num_slots`` slots, pinned
        residency and workspace fit ``capacity``: its schedule and workspace
        bytes.

        The search starts where the reference's stops,
        ``choose_num_tiles(info, capacity)``.  Where the workspace does not
        fit beside those slots, it steps up from there by 1, 2, 4, ... tiles
        (more tiles, smaller slots and workspace) until a count fits, then
        bisects down to the smallest count that fits.
        Every count returned was checked.  The count (or that none fits)
        is memoised per structure, capacity, slots and pinned set, so a
        timestep chain whose ``dt`` changed skips the search.  Raises
        ``MemoryError`` where no count fits (as ``choose_num_tiles`` does)
        or where the slots and pinned residency alone do not fit at the
        reference's count (as ``check_fit`` did before the workspace was
        charged)."""
        pinned = frozenset(pinned)
        key = structure_key(info)
        mkey = (key, float(capacity), int(num_slots), pinned, int(pinned_bytes))

        def probe(n: int) -> Tuple[TileSchedule, int, bool]:
            sched = make_tile_schedule(info, n)
            ws = self.charge(info, sched, pinned, num_slots, key=key)
            need = (num_slots * sched.slot_bytes(exclude=pinned) + pinned_bytes
                    + ws)
            return sched, ws, need <= capacity

        n = self._get(self._tiles, mkey)
        if n == 0:
            raise MemoryError("chain cannot fit (cached verdict of its structure)")
        if n is not None:
            sched, ws, _ = probe(n)
            return sched, ws
        try:
            sched, ws = self._search(info, capacity, num_slots, pinned,
                                     pinned_bytes, probe)
        except MemoryError:
            self._put(self._tiles, mkey, 0)
            raise
        self._put(self._tiles, mkey, len(sched.tiles))
        return sched, ws

    @staticmethod
    def _search(info: ChainInfo, capacity: float, num_slots: int,
                pinned: frozenset, pinned_bytes: int,
                probe) -> Tuple[TileSchedule, int]:
        """:meth:`fit_tiles`'s search; ``probe(n)`` is (schedule, charge,
        whether it fits) at ``n`` tiles.  A count past the reference's is
        probed on its own schedule, cheap at such counts, where another
        ``choose_num_tiles`` would bisect from thousands of tiles."""
        n = choose_num_tiles(info, capacity, num_slots=num_slots)
        sched, ws, fits = probe(n)
        if not fits:
            if (num_slots * sched.slot_bytes(exclude=pinned) + pinned_bytes
                    > capacity):
                raise MemoryError(
                    f"{num_slots} slots and {int(pinned_bytes)}B pinned exceed "
                    f"fast capacity {int(capacity)}B at {n} tiles")
            # More tiles than the tiled extent has rows shrink nothing.
            td = info.tiled_dim
            rows = (max(lp.range_[td][1] for lp in info.loops)
                    - min(lp.range_[td][0] for lp in info.loops))
            lo, step = n, 1             # lo: the largest count known not to fit
            while not fits:
                if n >= rows:
                    raise MemoryError(
                        f"the tile workspace ({ws}B at {n} tiles) leaves no "
                        f"room for slots in fast capacity {int(capacity)}B")
                lo, n = n, min(n + step, rows)
                step *= 2
                sched, ws, fits = probe(n)
            while n - lo > 1:
                mid = (lo + n) // 2
                got = probe(mid)
                if got[2]:
                    n, sched, ws = mid, got[0], got[1]
                else:
                    lo = mid
        return sched, ws
