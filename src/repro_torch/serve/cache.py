"""Cross-tenant shared chain-plan cache.

``OutOfCoreExecutor`` memoises :class:`~repro_torch.core.executor.ChainPlan`
objects per-executor, keyed by ``plan_signature`` — which embeds dataset
*object identity*, so two tenants running the same app on their own datasets
can never share a plan that way.  The server hands every lane executor (and
the admission oracle's sim executor) one :class:`SharedPlanCache`; executors
consult it on a local miss under the tenant-neutral
``shared_plan_signature`` key and feed it on every build.  A hit replays the
donor's analysis, tile schedule, instruction stream and its
:class:`~repro_torch.core.engine.TileEngine`, rebound to the adopter's
datasets (``OutOfCoreExecutor._adopt_shared``).  The port's engine runs
eagerly, so what an adopter saves is the planning.

Soundness: equal shared signatures mean isomorphic dataset layouts and
value-identical kernels (``kernel_fingerprint`` hashes code + captured
constants; captures that are not plain data fingerprint by identity and so
never match across tenants).  All config knobs that shape a plan are part of
the key, codecs included — but note the README caveat: a *lossy* codec
registered under one name for two tenants shares plans by name, as it does
within a single session.

Copied from ``src/repro/serve/cache.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.core.executor import ChainPlan


class SharedPlanCache:
    """Thread-safe LRU of ``(shared_key) -> (ChainPlan, first_tenant)``.

    ``lookup``/``insert`` are the executor-facing protocol (see
    ``OutOfCoreExecutor.plan_chain``); the tenant argument only feeds the
    cross-tenant hit counters surfaced in :class:`~repro_torch.serve.ServerStats`.
    """

    def __init__(self, max_plans: int = 128) -> None:
        self.max_plans = max_plans
        self._lock = threading.Lock()
        self._plans: "OrderedDict[Tuple, Tuple[ChainPlan, Optional[str]]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.cross_tenant_hits = 0

    def lookup(self, key: Tuple, tenant: Optional[str]) -> "Optional[ChainPlan]":
        with self._lock:
            ent = self._plans.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._plans.move_to_end(key)
            self.hits += 1
            if ent[1] is not None and tenant is not None and ent[1] != tenant:
                self.cross_tenant_hits += 1
            return ent[0]

    def insert(self, key: Tuple, plan: "ChainPlan",
               tenant: Optional[str]) -> None:
        with self._lock:
            if key in self._plans:
                # First writer wins: keep the donor attribution (and its
                # engine — concurrent builders racing here built equivalent
                # plans, either is fine).
                self._plans.move_to_end(key)
                return
            self._plans[key] = (plan, tenant)
            self.inserts += 1
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "plans": len(self._plans),
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "cross_tenant_hits": self.cross_tenant_hits,
            }
