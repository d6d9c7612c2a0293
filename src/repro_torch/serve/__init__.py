"""repro_torch.serve — multi-tenant serving over a shared device pool.

A :class:`StencilServer` admits many concurrent tenant
:class:`~repro_torch.core.Session`\\ s, schedules their chain plans onto a
pool of out-of-core executor lanes (sized by a ``DeviceMesh``: ``sim:N``
lanes sharing one device, or ``cuda:N`` with a lane per card), uses the
Plan-IR ledger interpreter as an admission-control oracle, shares chain
plans across tenants under the tenant-neutral ``shared_plan_signature``,
and preempts / migrates long-running jobs at chain boundaries through
checkpoints.

Quick start::

    from repro_torch.serve import StencilServer

    with StencilServer("sim:2", policy="sjf") as server:   # device="cuda"
        rt = server.session("alice", priority=1)
        app.run(rt, steps=5)        # any app: Sessions are unchanged
        print(server.stats().summary())

Ported from ``src/repro/serve/``; it imports neither JAX nor ``repro``.
"""
from .cache import SharedPlanCache
from .errors import AdmissionError, ServeError, UnknownTenantError
from .oracle import AdmissionOracle, AdmissionVerdict
from .policy import (
    JobView,
    SchedulingPolicy,
    available_policies,
    make_policy,
    register_policy,
)
from .server import ServerClient, StencilServer
from .stats import ServerStats, TenantStats

__all__ = [
    "AdmissionError", "AdmissionOracle", "AdmissionVerdict", "JobView",
    "SchedulingPolicy", "ServeError", "ServerClient", "ServerStats",
    "SharedPlanCache", "StencilServer", "TenantStats", "UnknownTenantError",
    "available_policies", "make_policy", "register_policy",
]
