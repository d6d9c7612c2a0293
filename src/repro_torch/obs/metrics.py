"""Structured metrics: counters, gauges, histograms, and a registry.

Instruments are individually locked (serve worker threads update them
concurrently); snapshots are plain JSON-able dicts so they can ride inside
``Session.transfer_stats()`` / ``StencilServer.metrics()`` without dragging
this module into every consumer.

Histograms use fixed decade buckets tuned for seconds-scale latencies
(1 µs … 100 s) — queue waits and service times across sim and real hardware
span that whole range, and fixed bounds make per-device snapshots mergeable
(:func:`merge_histogram_snapshots`, used by the sharded executor to fold
per-device lane histograms into one ``transfer_stats()`` view).

Copied from ``src/repro/obs/metrics.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS: Tuple[float, ...] = tuple(10.0 ** e for e in range(-6, 3))


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max.

    ``buckets`` are upper bounds; an observation lands in the first bucket
    whose bound is >= the value, or in ``overflow``.
    """

    __slots__ = ("_lock", "bounds", "counts", "overflow", "count", "sum",
                 "min", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.counts: List[int] = [0] * len(self.bounds)
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            i = bisect.bisect_left(self.bounds, v)
            if i < len(self.bounds):
                self.counts[i] += 1
            else:
                self.overflow += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            mean = self.sum / self.count if self.count else 0.0
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "buckets": [[b, c] for b, c in zip(self.bounds, self.counts)],
                "overflow": self.overflow,
            }


def merge_histogram_snapshots(a: Dict[str, Any],
                              b: Dict[str, Any]) -> Dict[str, Any]:
    """Fold two :meth:`Histogram.snapshot` dicts into one (same bounds)."""
    if not a:
        return dict(b)
    if not b:
        return dict(a)
    ab = [bound for bound, _ in a["buckets"]]
    bb = [bound for bound, _ in b["buckets"]]
    if ab != bb:
        raise ValueError("cannot merge histograms with different buckets")
    count = a["count"] + b["count"]
    total = a["sum"] + b["sum"]
    lo = min(x["min"] for x in (a, b) if x["count"]) if count else 0.0
    hi = max(x["max"] for x in (a, b) if x["count"]) if count else 0.0
    return {
        "count": count,
        "sum": total,
        "mean": total / count if count else 0.0,
        "min": lo,
        "max": hi,
        "buckets": [[bound, ca + cb] for (bound, ca), (_, cb)
                    in zip(a["buckets"], b["buckets"])],
        "overflow": a["overflow"] + b["overflow"],
    }


class MetricsRegistry:
    """Named instruments behind one lock; ``snapshot()`` is a plain dict."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter()
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge()
            return inst

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(
                    bounds if bounds is not None else DEFAULT_BUCKETS)
            return inst

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {k: c.snapshot()
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.snapshot()
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self._histograms.items())},
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)
