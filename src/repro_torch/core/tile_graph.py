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
  compute stream; the warm-up, with real results).  A key whose tiles never
  repeat is never captured, so a host sync there costs time and nothing
  else; the capture refuses one;
* its second tile captures (``capture_error_mode="thread_local"``: the
  lanes' worker threads go on copying, and nothing synchronises the device
  or empties the allocator's cache) into the run's one memory pool, then
  replays on the caller's stream;
* later tiles replay.  A key seen once captures nothing.

The tiled dim's start, which ``coords()`` reads, lives in a 0-d ``int32``
tensor per loop and key, filled on the compute stream before each replay
(where a kernel reads it).  All graphs of a run share one pool: replays are
serialised on one stream, each graph's reductions are cloned right after its
replay, and nothing else of a replay outlives it.  The run's end drops the
graphs; the caching allocator frees a pool that no graph uses when an
allocation would otherwise fail, or at ``torch.cuda.empty_cache()``.  A
failed capture or replay raises; nothing falls back to the eager tile
function.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

import torch

from .engine import TileEngine
from .tiling import TilePlan


class _Side:
    """What the runs on one compute stream share, made once: a side stream
    for warm-ups and captures (a stream per run would take a new one from
    PyTorch's round-robin pool every run, in time one a lane copies on, and
    strand the warm-ups' cached blocks on it), and a lock: two runs on one
    compute stream (two threads on a device's default stream) must not
    enqueue on the side stream while the other captures on it."""

    __slots__ = ("stream", "lock")

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()


_SIDES_LOCK = threading.Lock()
_SIDES: Dict[Tuple[int, int], _Side] = {}


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
    with :meth:`hold`).  Call it as ``engine.run_tile``: ``reds =
    graphs(tile, slots, origins)`` enqueues the tile on the current stream
    and returns its reduction contributions.  Raises ``ValueError`` for a
    tensor it does not hold (a replaced slot tensor).

    Records: ``warmups`` (keys seen, each first tile run eagerly),
    ``captures``, ``replays``, ``capture_s`` (host seconds of the captures,
    instantiation included), ``pool_bytes`` (device bytes the captures
    reserved for the run's pool), ``checked`` (replays held against the
    eager function, :attr:`check_replays`), ``last_mode`` (the last tile's:
    ``warmup``, ``capture`` or ``replay``)."""

    # When set (a test and ``chip_smoke.py`` hook, read when a run opens):
    # every replay is held, ``torch.equal``, against the eager tile function
    # on clones of the tile's tensors.
    check_replays = False

    def __init__(self, engine: TileEngine, device: torch.device,
                 tensors: Iterable[torch.Tensor]):
        self.engine = engine
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self._held: Dict[int, torch.Tensor] = {}
        for t in tensors:
            self.hold(t)
        self._keys: Dict[Tuple, _Key] = {}
        self._pool = torch.cuda.graph_pool_handle()
        self._check = self.check_replays
        self.warmups = self.captures = self.replays = self.checked = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.last_mode: Optional[str] = None
        main = torch.cuda.current_stream(self.device)
        with _SIDES_LOCK:
            key = (self.device.index, main.cuda_stream)
            if key not in _SIDES:
                _SIDES[key] = _Side(self.device)
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
        """Drop every graph and the tensors held; the pool, no longer used
        by a graph, is the caching allocator's to free.  Idempotent; the
        caller has synchronised the stream the replays ran on."""
        self._keys.clear()
        self._held.clear()
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
        with side.lock:
            side.stream.wait_stream(main)
            with torch.cuda.stream(side.stream):
                reds = self.engine.run_tile(tile, slots, origins)
            main.wait_stream(side.stream)
        for v in reds.values():
            if v.is_cuda:
                v.record_stream(main)
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
        side = self._side
        with side.lock, torch.cuda.stream(side.stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
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
