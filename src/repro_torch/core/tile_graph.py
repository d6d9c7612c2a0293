"""A chain run's tile function as CUDA graphs: the counterpart of the
reference's ``jax.jit(tile_fn)``.

The reference compiles one XLA program per tile signature
(``src/repro/core/engine.py::TileEngine._build``) and calls it for every
tile of that signature, the tile's starts and slot origins entering as
traced scalars.  The port's tile function is eager torch ops
(:meth:`~repro_torch.core.engine.TileEngine.tile_fn`); on a CUDA device
:class:`TileGraphs` captures it as a ``torch.cuda.CUDAGraph`` per graph key
(:meth:`~repro_torch.core.engine.TileEngine.graph_key`: the signature, the
slot-local offsets and the tensors) and replays it, which takes the host's
dispatch of a tile's launches (about 1,500 for a CloverLeaf 2D timestep)
off the tile's path.  It is not ``torch.compile``: a replay runs the eager
launches as they were captured, so it is bit-identical to the eager tile.

The graphs belong to one run of a chain (one
:class:`~repro_torch.core.interp.DataPlaneInterpreter`), not to the
plan's engine, which several tenants and lanes share: the slot tensors are
new on every run, and captured Python scalars (CloverLeaf's ``dt``) are
the plan's, whose key fingerprints them.  A key's life:

* its first tile runs the eager tile function on a side stream (one per
  compute stream; the warm-up, with real results) with its allocations in
  the run's one memory pool.  A key whose tiles never repeat is never
  captured, so a host sync there costs time and nothing else; the capture
  refuses one;
* its second tile captures (``capture_error_mode="thread_local"``: the
  lanes' worker threads go on copying, and nothing synchronises the device
  or empties the allocator's cache) into the same pool, then replays on the
  caller's stream;
* later tiles replay.  A key seen once captures nothing.

The tiled dim's start, which ``coords()`` reads, lives in a 0-d ``int32``
tensor per loop and key, filled on the compute stream before each replay
(where a kernel reads it).  All graphs of a run share one pool: replays are
serialised on one stream, each graph's and each warm-up's reductions are
cloned out of it right after the replay or warm-up, and nothing else of
either outlives it.  The run's end drops the graphs and the pool.  A failed
capture or replay raises; nothing falls back to the eager tile function.

The device memory of the tile function is one workspace, which the plan
charges beside the slots (:mod:`repro_torch.core.workspace`).  A warm-up
outside the pool would leave its blocks cached on the side stream while the
next capture allocates the pool's: two workspaces, and under a hard cap a
capture cannot free the first (the allocator frees no cached block while a
capture is under way).  So warm-ups and captures share the pool, whose
freed blocks each reuses; the run's slots are in it too
(:class:`~repro_torch.core.interp.DataPlaneInterpreter`), so that dropping
it at the run's end gives all of the run's memory back to the card.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

import torch

from .engine import TileEngine
from .tiling import TilePlan


# What the runs on one compute stream share, made once: a side stream for
# warm-ups and captures (a stream per run would take a new one from
# PyTorch's round-robin pool every run, in time one a lane copies on).
_SIDES_LOCK = threading.Lock()
_SIDES: Dict[Tuple[int, int], torch.cuda.Stream] = {}
# One lock per card for its runs' memory pools, held while a thread's
# allocations go to a pool (``allocating_to``), while it captures, and while
# a pool is dropped: the caching allocator frees a pool's memory only when no
# capture or pool routing is under way on the card (it asserts so), and two
# runs on one compute stream must not enqueue on its side stream while the
# other captures there.
_LOCKS: Dict[int, threading.RLock] = {}


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def device_lock(device) -> threading.RLock:
    """The card's pool lock (see above)."""
    with _SIDES_LOCK:
        return _LOCKS.setdefault(_index(device), threading.RLock())


@contextlib.contextmanager
def allocating_to(pool, device):
    """This thread's allocations on ``device`` from ``pool`` (a
    ``torch.cuda.MemPool``) for the ``with`` body, under the card's lock;
    no routing where ``pool`` is None (the CPU)."""
    if pool is None:
        yield
        return
    with device_lock(device), torch.cuda.use_mem_pool(pool, _index(device)):
        yield


def drop_pool(device, owner, attr: str) -> None:
    """Set ``owner.attr`` (the last reference to a pool, or to what holds
    one) to None under the card's lock: the pool's memory goes back to the
    card at once, not at the next allocation that fails."""
    if getattr(owner, attr, None) is None:
        return
    with device_lock(device):
        setattr(owner, attr, None)


class _Key:
    """One graph key's state: its graph once captured, the start tensor it
    reads, the loops that read it, and its static reduction outputs."""

    __slots__ = ("graph", "starts", "used", "reds")

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.starts: Optional[torch.Tensor] = None
        self.used: Set[int] = set()
        self.reds: Dict[str, torch.Tensor] = {}


class TileGraphs:
    """``engine``'s tile function as CUDA graphs for one run of its chain on
    ``device``, over ``tensors`` (the run's slot tensors; pinned tensors join
    with :meth:`hold`), its warm-ups and captures in ``pool`` (the run's
    ``torch.cuda.MemPool``, which the interpreter makes and its slots share).  Call it as ``engine.run_tile``: ``reds =
    graphs(tile, slots, origins)`` enqueues the tile on the current stream
    and returns its reduction contributions.  Raises ``ValueError`` for a
    tensor it does not hold (a replaced slot tensor).

    Records: ``warmups`` (keys seen, each first tile run eagerly),
    ``captures``, ``replays``, ``capture_s`` (host seconds of the captures,
    instantiation included), ``pool_bytes`` (device bytes the warm-ups and
    captures reserved for the run's pool), ``checked`` (replays held against the
    eager function, :attr:`check_replays`), ``last_mode`` (the last tile's:
    ``warmup``, ``capture`` or ``replay``)."""

    # When set (a test and ``chip_smoke.py`` hook, read when a run opens):
    # every replay is held, ``torch.equal``, against the eager tile function
    # on clones of the tile's tensors.
    check_replays = False

    def __init__(self, engine: TileEngine, device: torch.device,
                 tensors: Iterable[torch.Tensor], pool):
        self.engine = engine
        self.device = torch.device("cuda", _index(device))
        self._held: Dict[int, torch.Tensor] = {}
        for t in tensors:
            self.hold(t)
        self._keys: Dict[Tuple, _Key] = {}
        self._pool = pool
        self._check = self.check_replays
        self.warmups = self.captures = self.replays = self.checked = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.last_mode: Optional[str] = None
        main = torch.cuda.current_stream(self.device)
        with _SIDES_LOCK:
            key = (self.device.index, main.cuda_stream)
            if key not in _SIDES:
                _SIDES[key] = torch.cuda.Stream(self.device)
            self._side = _SIDES[key]
        self._open = True

    @property
    def is_open(self) -> bool:
        """Until :meth:`release`."""
        return self._open

    def hold(self, tensor: torch.Tensor) -> None:
        if tensor.device != self.device:
            raise ValueError(f"TileGraphs on {self.device} cannot hold a tensor "
                             f"on {tensor.device}")
        self._held[id(tensor)] = tensor

    def stats(self) -> Dict[str, float]:
        """The records under their ``ChainStats`` names (``graph_*``)."""
        return {"graph_warmups": self.warmups, "graph_captures": self.captures,
                "graph_replays": self.replays, "graph_capture_s": self.capture_s,
                "graph_pool_bytes": self.pool_bytes, "graph_checked": self.checked}

    def release(self) -> None:
        """Drop every graph, the tensors held and the pool.  Idempotent; the
        caller has synchronised the stream the replays ran on and holds the
        card's lock (``drop_pool``), as the pool may go with the graphs."""
        self._keys.clear()
        self._held.clear()
        self._pool = None
        self._open = False

    # -- the tile -----------------------------------------------------------------
    def __call__(self, tile: TilePlan, slots: Dict[str, torch.Tensor],
                 origins: Dict[str, int]) -> Dict[str, torch.Tensor]:
        if not self._open:
            raise RuntimeError("TileGraphs used after release()")
        for name, t in slots.items():
            if self._held.get(id(t)) is not t:
                raise ValueError(f"TileGraphs replay the slot tensors they were made "
                                 f"with; {name!r} is not one of them")
        key = self.engine.graph_key(tile, slots, origins)
        state = self._keys.get(key)
        if state is None:
            self._keys[key] = _Key()
            self.last_mode = "warmup"
            return self._warm(tile, slots, origins)
        if state.graph is None:
            self._capture(state, tile, slots, origins)
            self.last_mode = "capture"
        else:
            self.last_mode = "replay"
        if self._check:
            return self._checked_replay(state, tile, slots, origins)
        return self._replay(state, tile)

    def _warm(self, tile, slots, origins) -> Dict[str, torch.Tensor]:
        main = torch.cuda.current_stream(self.device)
        side = self._side
        before = torch.cuda.memory_reserved(self.device)
        with device_lock(self.device):
            side.wait_stream(main)
            with torch.cuda.stream(side):
                with allocating_to(self._pool, self.device):
                    pooled = self.engine.run_tile(tile, slots, origins)
                # out of the pool, whose blocks a later replay may write
                reds = {name: v.clone() for name, v in pooled.items()}
                del pooled
            main.wait_stream(side)
        for v in reds.values():
            if v.is_cuda:
                v.record_stream(main)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - before
        self.warmups += 1
        return reds

    def _capture(self, state: _Key, tile, slots, origins) -> None:
        n = len(tile.loop_ranges)
        state.starts = torch.zeros(n, dtype=torch.int32, device=self.device)

        def start_t(k: int, start: int) -> torch.Tensor:
            state.used.add(k)
            return state.starts[k]

        before = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        # assigned first: a key whose capture failed raises again at its next
        # tile rather than running eagerly
        state.graph = graph = torch.cuda.CUDAGraph()
        with device_lock(self.device), torch.cuda.stream(self._side):
            graph.capture_begin(pool=self._pool.id, capture_error_mode="thread_local")
            try:
                state.reds = self.engine.tile_fn(tile, slots, origins, start_t)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - before
        self.captures += 1

    def _replay(self, state: _Key, tile: TilePlan) -> Dict[str, torch.Tensor]:
        td = self.engine.td
        for k in state.used:
            state.starts[k].fill_(tile.loop_ranges[k][td][0])
        state.graph.replay()
        self.replays += 1
        return {name: v.clone() for name, v in state.reds.items()}

    def _checked_replay(self, state: _Key, tile, slots, origins):
        clones = {name: t.clone() for name, t in slots.items()}
        want = self.engine.run_tile(tile, clones, origins)
        got = self._replay(state, tile)
        bad: List[str] = [n for n in slots if not torch.equal(slots[n], clones[n])]
        bad += [f"reduction {n}" for n in want if not torch.equal(got[n], want[n])]
        if bad or set(got) != set(want):
            raise RuntimeError(f"tile {tile.index}: the replay differs from the eager "
                               f"tile function on cloned slots in {bad}")
        self.checked += 1
        return got
