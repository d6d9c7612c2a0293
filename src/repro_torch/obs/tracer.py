"""Low-overhead span tracing.

The tracing spine is a single :class:`Tracer` shared by every layer of one
run (executor, interpreters, transfer lanes, sharded mesh, serve).  Design
constraints, in order:

* **Disabled is free.**  Instrumentation sites hold a tracer reference and
  guard on ``tracer.enabled`` — a plain class attribute, so the untraced hot
  path pays one attribute load and a branch.  ``NullTracer.span()`` returns a
  module-level singleton context manager: no allocation either.
* **Thread-safe.**  Threaded transfer lanes and serve worker threads emit
  concurrently; the span buffer is a ``deque`` guarded by a lock.
* **Bounded.**  The buffer is a ring (``capacity`` spans); old spans are
  dropped, never the run.  ``Tracer.dropped`` counts evictions.
* **One clock.**  ``Tracer.clock`` is an injectable ``() -> float`` (default
  ``time.perf_counter``) so serve-layer stats and spans cannot disagree, and
  tests can pin time.

Copied from ``src/repro/obs/tracer.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Iterable, List, Optional,
                    Union)


class Span:
    """One half-open ``[t_start, t_end)`` interval on a named track.

    Times are seconds on the emitting tracer's clock — wall-clock for data
    planes, *modelled* seconds for the sim interpreter (the drift audit
    exploits exactly that).  ``args`` is a small JSON-able dict; by
    convention spans tied to ledger events carry ``eid`` (one event) or
    ``eids`` (inline ops covering several), plus ``op`` (the plan op index
    shown by ``format_plan`` as ``#N``) and ``chain``.
    """

    __slots__ = ("name", "cat", "track", "t_start", "t_end", "args")

    def __init__(self, name: str, cat: str, track: str,
                 t_start: float, t_end: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.cat = cat
        self.track = track
        self.t_start = t_start
        self.t_end = t_end
        self.args = args

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "cat": self.cat, "track": self.track,
                "t_start": self.t_start, "t_end": self.t_end,
                "args": self.args or {}}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, track={self.track!r}, "
                f"t={self.t_start:.6f}..{self.t_end:.6f})")


class _SpanCtx:
    """Context manager minted by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc: object) -> None:
        self._tracer.emit(self._name, cat=self._cat, track=self._track,
                          t_start=self._t0, t_end=self._tracer.clock(),
                          args=self._args)


class _NullCtx:
    """Singleton no-op context manager — ``NullTracer.span()`` allocates
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_CTX = _NullCtx()


class Tracer:
    """Thread-safe, ring-buffered span recorder."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.clock = clock
        self.capacity = int(capacity)
        self._spans: Deque[Span] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def emit(self, name: str, *, cat: str = "", track: str = "",
             t_start: float, t_end: float,
             args: Optional[Dict[str, Any]] = None) -> Span:
        """Record a finished span.  Safe from any thread."""
        span = Span(name, cat, track, t_start, t_end, args)
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)
        return span

    def span(self, name: str, *, cat: str = "", track: str = "",
             args: Optional[Dict[str, Any]] = None) -> _SpanCtx:
        """``with tracer.span("scatter", track="mesh"): ...`` — times the
        body on this tracer's clock and emits on exit."""
        return _SpanCtx(self, name, cat, track, args)

    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- convenience exporters -------------------------------------------
    def chrome(self) -> Dict[str, Any]:
        """Chrome trace-event document for the current buffer."""
        from .chrome import chrome_trace
        return chrome_trace(self.spans())

    def save(self, path: str) -> Dict[str, Any]:
        """Write the Chrome trace to ``path`` (open in Perfetto)."""
        doc = self.chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


class NullTracer:
    """Disabled tracer: every instrumentation site checks ``enabled`` first,
    so in practice none of these methods run on hot paths."""

    enabled = False
    clock = staticmethod(time.perf_counter)

    def emit(self, name: str, *, cat: str = "", track: str = "",
             t_start: float, t_end: float,
             args: Optional[Dict[str, Any]] = None) -> None:
        return None

    def span(self, name: str, *, cat: str = "", track: str = "",
             args: Optional[Dict[str, Any]] = None) -> _NullCtx:
        return _NULL_CTX

    def spans(self) -> List[Span]:
        return []

    def clear(self) -> None:
        return None

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()

AnyTracer = Union[Tracer, NullTracer]


def as_tracer(spec: object) -> AnyTracer:
    """Resolve a user-facing ``trace=`` value to a tracer.

    ``None``/``False`` → the shared :data:`NULL_TRACER`; ``True`` → a fresh
    :class:`Tracer`; a tracer instance → itself (lets callers share one
    spine across executors, devices and serve lanes).
    """
    if spec is None or spec is False:
        return NULL_TRACER
    if spec is True:
        return Tracer()
    if isinstance(spec, (Tracer, NullTracer)):
        return spec
    raise TypeError(f"trace= expects bool, None or a Tracer; got {spec!r}")


def merge_spans(*traces: Union[AnyTracer, Iterable[Span]]) -> List[Span]:
    """Combine spans from several tracers/iterables, ordered by start time."""
    out: List[Span] = []
    for tr in traces:
        out.extend(tr.spans() if hasattr(tr, "spans") else tr)  # type: ignore[union-attr]
    out.sort(key=lambda s: (s.t_start, s.t_end))
    return out
