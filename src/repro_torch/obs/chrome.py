"""Chrome trace-event JSON export.

Emits the "JSON Array Format" subset every trace viewer understands
(Perfetto, ``chrome://tracing``, speedscope): one ``ph="X"`` complete event
per span with microsecond ``ts``/``dur``, plus ``ph="M"`` metadata events
naming the process and one thread per distinct span track — so compute,
upload, download, disk, network, per-device and per-tenant activity each get
their own swim-lane.

Copied from ``src/repro/obs/chrome.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Union

from .tracer import Span, Tracer

_SpanSource = Union[Tracer, Iterable[Span]]


def _spans(source: _SpanSource) -> List[Span]:
    if hasattr(source, "spans"):
        return source.spans()  # type: ignore[union-attr]
    return list(source)  # type: ignore[arg-type]


def chrome_trace(source: _SpanSource, *,
                 process_name: str = "repro") -> Dict[str, Any]:
    """Build a Chrome trace-event document from spans (or a tracer)."""
    spans = _spans(source)
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    for s in spans:
        track = s.track or "main"
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": track},
            })
        events.append({
            "name": s.name,
            "cat": s.cat or "span",
            "ph": "X",
            "ts": s.t_start * 1e6,
            "dur": (s.t_end - s.t_start) * 1e6,
            "pid": 0,
            "tid": tid,
            "args": s.args or {},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(source: _SpanSource, path: str, *,
                        process_name: str = "repro") -> Dict[str, Any]:
    """Write the Chrome trace for ``source`` to ``path`` and return it."""
    doc = chrome_trace(source, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> None:
    """Schema-check a trace document; raises ``ValueError`` on violations.

    Checks the invariants viewers rely on: a ``traceEvents`` list, complete
    events with numeric non-negative ``ts``/``dur`` and a ``tid`` that has a
    ``thread_name`` metadata event, JSON-serialisable ``args``.
    """
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    named_tids = {0}
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                raise ValueError(f"unknown metadata event {ev.get('name')!r}")
            named_tids.add(ev["tid"])
        elif ph == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in ev:
                    raise ValueError(f"complete event missing {key!r}: {ev}")
            if not isinstance(ev["ts"], (int, float)):
                raise ValueError("ts must be numeric")
            if not isinstance(ev["dur"], (int, float)) or ev["dur"] < 0:
                raise ValueError("dur must be numeric and non-negative")
            if ev["tid"] not in named_tids:
                raise ValueError(f"tid {ev['tid']} has no thread_name event")
            json.dumps(ev.get("args", {}))
        else:
            raise ValueError(f"unexpected event phase {ph!r}")


def spans_from_chrome(doc: Dict[str, Any]) -> List[Span]:
    """Reconstruct spans from a Chrome trace document (the round-trip of
    :func:`chrome_trace`; times come back with µs precision)."""
    tracks: Dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev["tid"]] = ev["args"]["name"]
    out: List[Span] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        t0 = ev["ts"] / 1e6
        out.append(Span(ev["name"], ev.get("cat", ""),
                        tracks.get(ev["tid"], "main"),
                        t0, t0 + ev["dur"] / 1e6, ev.get("args") or None))
    return out
