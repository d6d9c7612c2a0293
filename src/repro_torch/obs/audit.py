"""Modelled-vs-achieved drift audit.

The ledger gives every chain a *modelled* timeline: ``simulate()`` assigns
each :class:`repro_torch.core.memory.Event` a ``t_start``/``t_end`` on its stream.
A traced run gives the *achieved* timeline: spans carrying ``eid`` (lane
spans, modelled spans) or ``eids`` (dispatch spans covering ops executed
inline on the issue thread).  :func:`compare` aligns the two event-by-event
and reports, per stream, the achieved/modelled time ratio plus the top-k
divergent ops — turning "the sim says N× speed-up" into a falsifiable
per-op claim (``format_plan`` prints the same ``#op`` indices, and
``repro_torch.core.verify`` diagnostics cite them as ``op N``).

The oracle case: a sim-mode run emits its spans *from* the modelled
timeline, so ``compare`` must report a per-stream ratio of exactly ``1.0``
— both sides accumulate the identical floats in the identical order.

Copied from ``src/repro/obs/audit.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, List, Optional, Tuple, Union,
                    TYPE_CHECKING)

from .tracer import Span, Tracer

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.memory import TransferLedger

STREAM_NAMES: Dict[int, str] = {
    0: "compute", 1: "upload", 2: "download", 3: "disk", 4: "network"}


def stream_name(stream: int) -> str:
    return STREAM_NAMES.get(stream, f"stream{stream}")


@dataclass
class OpDrift:
    """One matched ledger event: modelled vs achieved duration."""

    op: int                 # plan op index (#N in format_plan; -1 unknown)
    eid: int                # ledger event id
    kind: str               # event kind ("upload", "compute", ...)
    stream: int
    modelled_s: float
    achieved_s: float

    @property
    def ratio(self) -> float:
        if self.modelled_s == 0.0:
            return 1.0 if self.achieved_s == 0.0 else float("inf")
        return self.achieved_s / self.modelled_s

    @property
    def divergence(self) -> float:
        """Symmetric distance from ratio 1.0 used for top-k ranking."""
        r = self.ratio
        if r <= 0.0:
            return float("inf")
        return r if r >= 1.0 else 1.0 / r


@dataclass
class StreamDrift:
    """Per-stream aggregate over the matched events."""

    stream: int
    name: str
    events: int = 0         # ledger events on this stream
    matched: int = 0        # ... with an achieved span
    modelled_s: float = 0.0
    achieved_s: float = 0.0

    @property
    def ratio(self) -> float:
        if self.modelled_s == 0.0:
            return 1.0 if self.achieved_s == 0.0 else float("inf")
        return self.achieved_s / self.modelled_s


@dataclass
class DriftReport:
    """Output of :func:`compare`."""

    streams: Dict[int, StreamDrift]
    ops: List[OpDrift] = field(default_factory=list)  # matched events
    unmatched_events: int = 0   # ledger events with no achieved span
    spans_seen: int = 0         # spans considered after filtering

    def top(self, k: int = 5) -> List[OpDrift]:
        """The k most divergent matched ops (ties broken by modelled time)."""
        ranked = sorted(self.ops,
                        key=lambda o: (o.divergence, o.modelled_s),
                        reverse=True)
        return ranked[:k]

    @property
    def overall_ratio(self) -> float:
        modelled = sum(s.modelled_s for s in self.streams.values())
        achieved = sum(s.achieved_s for s in self.streams.values())
        if modelled == 0.0:
            return 1.0 if achieved == 0.0 else float("inf")
        return achieved / modelled

    def summary(self, top_k: int = 5) -> str:
        lines = ["drift audit (achieved / modelled):"]
        for sid in sorted(self.streams):
            s = self.streams[sid]
            lines.append(
                f"  {s.name:<9} ratio {s.ratio:10.4g}  "
                f"modelled {s.modelled_s:.6g}s  achieved {s.achieved_s:.6g}s  "
                f"({s.matched}/{s.events} events matched)")
        if self.unmatched_events:
            lines.append(f"  unmatched ledger events: {self.unmatched_events}")
        top = self.top(top_k)
        if top:
            lines.append(f"  top-{len(top)} divergent ops:")
            for o in top:
                lines.append(
                    f"    op #{o.op} {o.kind:<10} [{stream_name(o.stream)}] "
                    f"modelled {o.modelled_s:.6g}s achieved "
                    f"{o.achieved_s:.6g}s ratio {o.ratio:.4g}")
        return "\n".join(lines)


def _achieved_by_eid(spans: Iterable[Span]) -> Tuple[
        Dict[int, float], Dict[int, int]]:
    """Map eid -> achieved duration (and -> plan op index when known).

    Spans with a single ``eid`` (lane spans, sim modelled spans) take
    precedence over ``eids`` dispatch spans: the former time the event
    itself, the latter time the issuing op and are only used for events
    executed inline on the issue thread.
    """
    achieved: Dict[int, float] = {}
    op_of: Dict[int, int] = {}
    deferred: List[Span] = []
    for s in spans:
        a = s.args
        if not a:
            continue
        eid = a.get("eid")
        if eid is not None:
            achieved[eid] = s.t_end - s.t_start
            if "op" in a:
                op_of[eid] = a["op"]
        elif a.get("eids"):
            deferred.append(s)
    for s in deferred:
        a = s.args or {}
        eids = [e for e in a["eids"] if e not in achieved]
        if not eids:
            continue
        # An inline op's dispatch time covers all its events; attribute it
        # proportionally to the modelled share later — here, split evenly.
        share = (s.t_end - s.t_start) / len(eids)
        for e in eids:
            achieved[e] = share
            if "op" in a:
                op_of[e] = a["op"]
    return achieved, op_of


def compare(ledger: "TransferLedger",
            trace: Union[Tracer, Iterable[Span]], *,
            chain: Optional[int] = None,
            tag: str = "") -> DriftReport:
    """Align achieved spans against the ledger's modelled event stream.

    ``chain`` filters spans by their ``chain`` arg (each executor numbers
    chains in submission order — pass the index of the ledger's chain);
    ``tag`` filters by track prefix (e.g. ``"dev0/"`` on a sharded run,
    ``"lane2/"`` on a serve lane).
    """
    spans: List[Span] = (trace.spans() if isinstance(trace, Tracer)
                         else list(trace))
    if tag:
        spans = [s for s in spans if s.track.startswith(tag)]
    if chain is not None:
        spans = [s for s in spans
                 if s.args is not None and s.args.get("chain") == chain]
    ledger.simulate()  # idempotent: fills Event.t_start/t_end
    achieved, op_of = _achieved_by_eid(spans)

    streams: Dict[int, StreamDrift] = {}
    ops: List[OpDrift] = []
    unmatched = 0
    for ev in ledger.events:
        sd = streams.get(ev.stream)
        if sd is None:
            sd = streams[ev.stream] = StreamDrift(
                stream=ev.stream, name=stream_name(ev.stream))
        sd.events += 1
        got: Any = achieved.get(ev.eid)
        if got is None:
            unmatched += 1
            continue
        modelled = ev.t_end - ev.t_start
        sd.matched += 1
        sd.modelled_s += modelled
        sd.achieved_s += got
        ops.append(OpDrift(op=op_of.get(ev.eid, -1), eid=ev.eid,
                           kind=ev.kind, stream=ev.stream,
                           modelled_s=modelled, achieved_s=got))
    return DriftReport(streams=streams, ops=ops,
                       unmatched_events=unmatched, spans_seen=len(spans))
