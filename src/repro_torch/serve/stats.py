"""Per-tenant and server-level observability.

Copied from ``src/repro/serve/stats.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TenantStats:
    """One tenant's service record.

    ``predicted_s`` accumulates the admission oracle's modelled makespans,
    ``achieved_modelled_s`` the ledger makespans the executing interpreter
    actually recorded — both come from the same :class:`TransferLedger`
    model, so their ratio is the serving layer's *scheduling* overhead
    signal (cache warmth, splits), not model error.

    ``queue_wait_s`` (and every other wall-time in these rows) is read from
    the server's single injected clock (``StencilServer(clock=...)``) — the
    same source the :mod:`repro_torch.obs` tracer stamps serve spans with, so the
    predicted-vs-achieved rows and the trace timeline can be compared
    instant-for-instant."""

    tenant: str
    priority: int = 0
    state: str = "idle"             # idle | queued | running | preempted | closed
    lane: Optional[int] = None
    chains: int = 0
    loops: int = 0
    queue_wait_s: float = 0.0       # wall time spent waiting for a lane grant
    predicted_s: float = 0.0
    achieved_modelled_s: float = 0.0
    preemptions: int = 0
    rejected: int = 0               # AdmissionError count
    plan_hits: int = 0              # lane-level plan-cache hits while running

    @property
    def predicted_vs_achieved(self) -> float:
        """achieved / predicted modelled time (1.0 = oracle-exact)."""
        if self.predicted_s <= 0.0:
            return 1.0
        return self.achieved_modelled_s / self.predicted_s


@dataclass
class ServerStats:
    """A point-in-time snapshot assembled by :meth:`StencilServer.stats`."""

    policy: str
    lanes: int
    mesh: str
    tenants: Dict[str, TenantStats] = field(default_factory=dict)
    jobs_completed: int = 0
    jobs_rejected: int = 0
    preemptions: int = 0
    lane_busy_modelled_s: List[float] = field(default_factory=list)
    plan_cache: Dict[str, int] = field(default_factory=dict)

    @property
    def cross_tenant_plan_hits(self) -> int:
        return int(self.plan_cache.get("cross_tenant_hits", 0))

    def summary(self) -> str:
        """Human-readable multi-line digest (the ``--serve`` bench prints
        this per policy)."""
        lines = [
            f"server[{self.mesh} policy={self.policy}]: "
            f"{self.jobs_completed} chains served, "
            f"{self.jobs_rejected} rejected, {self.preemptions} preemptions, "
            f"{self.cross_tenant_plan_hits} cross-tenant plan hits",
            "  lane busy (modelled): "
            + " ".join(f"l{i}={t * 1e3:.2f}ms"
                       for i, t in enumerate(self.lane_busy_modelled_s)),
        ]
        for name in sorted(self.tenants):
            t = self.tenants[name]
            lines.append(
                f"  {name}: prio={t.priority} chains={t.chains} "
                f"wait={t.queue_wait_s * 1e3:.1f}ms "
                f"predicted={t.predicted_s * 1e3:.2f}ms "
                f"achieved={t.achieved_modelled_s * 1e3:.2f}ms "
                f"(x{t.predicted_vs_achieved:.2f}) "
                f"preempted={t.preemptions}")
        return "\n".join(lines)
