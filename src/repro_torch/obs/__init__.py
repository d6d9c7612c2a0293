"""repro_torch.obs — unified runtime tracing & metrics spine.

One observability layer for the whole stack:

* :mod:`repro_torch.obs.tracer` — a low-overhead span :class:`Tracer` (thread-safe,
  ring-buffered) with a :class:`NullTracer` default so untraced hot paths pay
  a single attribute check.  Spans are emitted by ``OutOfCoreExecutor``
  (per-chain / per-tile / per-plan-op), the ``TransferEngine`` worker lanes,
  ``ShardedOutOfCoreExecutor`` (per-device streams + halo exchange) and
  ``repro_torch.serve.StencilServer`` (admission, queue-wait, lane lease,
  preempt/restore).
* :mod:`repro_torch.obs.chrome` — Chrome trace-event JSON export (one track per
  stream/lane/device/tenant, viewable in Perfetto / ``chrome://tracing``).
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms behind a
  :class:`MetricsRegistry`, surfaced as ``StencilServer.metrics()`` and the
  per-lane histograms in ``Session.transfer_stats()``.
* :mod:`repro_torch.obs.audit` — the modelled-vs-achieved **drift audit**:
  :func:`repro_torch.obs.audit.compare` aligns the achieved span timeline against
  the ``LedgerInterpreter``'s modelled event stream op-by-op and reports
  per-stream ratios plus the top-k divergent ops.

This package deliberately imports nothing from :mod:`repro_torch.core` at runtime —
the core layers import *us*, never the reverse.

Copied from ``src/repro/obs/__init__.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from .audit import DriftReport, OpDrift, StreamDrift, compare
from .chrome import (chrome_trace, export_chrome_trace, spans_from_chrome,
                     validate_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      merge_histogram_snapshots)
from .tracer import NULL_TRACER, NullTracer, Span, Tracer, as_tracer

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER", "as_tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "merge_histogram_snapshots",
    "chrome_trace", "export_chrome_trace", "spans_from_chrome",
    "validate_chrome_trace",
    "compare", "DriftReport", "StreamDrift", "OpDrift",
]
