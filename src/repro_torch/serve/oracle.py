"""Ledger-interpreter admission control.

The Plan IR gives the server an exact cost model *before* any data moves: a
submitted chain is lowered to its instruction stream(s) through the shared
plan cache (so repeat chains cost a cache lookup), then costed with
``simulate_plan`` on cold caches.  The oracle answers two questions:

* **does it fit** — mirror ``run_chain``'s MemoryError chain-splitting (the
  executor charges slots, pinned residency and the tile function's
  workspace, ``repro_torch.core.workspace``, and so does the verdict); if
  even single-loop chains cannot fit the slot pool, the job is *rejected*
  (typed :class:`~repro_torch.serve.AdmissionError` at the submit site)
  instead of wedging a lane at run time;
* **how long will it take** — the summed modelled makespan, which the
  scheduler's cost-aware policy and the per-tenant SLA estimates consume.

Because the oracle's sim executor shares the server's ``SharedPlanCache``,
the plans it builds during admission are the very plans the data-plane lanes
replay — predicted and achieved makespans come from one ledger model.

Ported from ``src/repro/serve/oracle.py``.  The reference copies its split
from the JAX ``Session._plan_split``, which lacks the rule that both halves
keep the whole chain's read-first datasets live (ROADMAP fault C1), so it
predicts split Cyclic chains that the port's ``run_chain`` never executes.
This oracle splits through :func:`~repro_torch.core.dependency.split_chain`,
as ``run_chain`` and ``Session._plan_split`` do: unsplit chains get the
reference's verdict, split Cyclic chains the port's own plans.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Sequence, Tuple, TYPE_CHECKING

from ..core.dependency import split_chain
from ..core.interp import predict_plans
from ..core.tune import make_sim_executor

from .cache import SharedPlanCache

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.executor import OutOfCoreExecutor
    from ..core.loop import ParallelLoop
    from ..core.plan import Plan
    from ..core.program import ExecutionConfig


@dataclass(frozen=True)
class AdmissionVerdict:
    """The oracle's prediction for one submitted chain."""

    admitted: bool
    predicted_makespan_s: float      # summed modelled makespan, all splits
    predicted_bytes: int             # peak fast-memory footprint of any plan
    capacity_bytes: float            # the pool capacity it was checked against
    chains: int                      # plans after MemoryError splitting
    reason: str = ""                 # human-readable rejection cause


class AdmissionOracle:
    """Predict footprint and makespan for a chain on this server's config.

    One ledger-only executor, serialised by a lock (planning mutates its
    caches); its plan cache is the server's shared one, so admission work is
    never thrown away — the lane that later runs the job replays the same
    plans.  It is built on the lanes' ``device`` (a ledger-only executor
    allocates nothing there and moves no data) and is never traced.
    """

    def __init__(self, config: "ExecutionConfig",
                 shared: SharedPlanCache) -> None:
        self._ex: "OutOfCoreExecutor" = make_sim_executor(
            config, shared_plans=shared)
        self._lock = threading.Lock()
        self.capacity_bytes: float = float(self._ex.cfg.capacity)
        self.hw = self._ex.cfg.hw
        self.predictions = 0
        self.rejections = 0

    @property
    def plan_time_s(self) -> float:
        """Seconds this oracle spent building plans (cache hits cost none)."""
        return self._ex.plan_time_s

    def predict(self, loops: Sequence["ParallelLoop"], *,
                cyclic: bool = False,
                tenant: Optional[str] = None) -> AdmissionVerdict:
        """Lower ``loops`` (one chain) and cost it.  Never raises for a
        too-big job — rejection is a verdict, the server turns it into a
        typed ``AdmissionError`` at the submit site."""
        with self._lock:
            self._ex.cfg.cyclic = bool(cyclic)
            self._ex.tenant = tenant
            self.predictions += 1
            try:
                planned = self._plan_split(list(loops), frozenset(), frozenset())
            except MemoryError as e:
                self.rejections += 1
                return AdmissionVerdict(
                    admitted=False, predicted_makespan_s=0.0,
                    predicted_bytes=0, capacity_bytes=self.capacity_bytes,
                    chains=0,
                    reason=f"no tiling fits even single-loop chains: {e}")
            makespan, peak = predict_plans([p for p, _ in planned], self.hw,
                                           [ws for _, ws in planned])
            return AdmissionVerdict(
                admitted=True, predicted_makespan_s=makespan,
                predicted_bytes=peak, capacity_bytes=self.capacity_bytes,
                chains=len(planned))

    def close(self) -> None:
        self._ex.close()

    def _plan_split(self, loops: List["ParallelLoop"],
                    keep_live: FrozenSet[str],
                    warm: FrozenSet[str]) -> List[Tuple["Plan", int]]:
        """``run_chain``'s MemoryError split, plans only, each with what the
        executor charged beside its slots (its workspace): the oracle must
        predict exactly the chains a lane will execute."""
        try:
            cp = self._ex.plan_chain(loops, keep_live, warm=warm)
            ws = getattr(cp, "workspace_bytes", 0)
            return ([(p, ws) for p in cp.ir] if isinstance(cp.ir, tuple)
                    else [(cp.ir, ws)])
        except MemoryError:
            if len(loops) <= 1:
                raise
            (head, h_live, h_warm), (tail, t_live, t_warm) = split_chain(
                loops, keep_live, warm)
            return (self._plan_split(head, h_live, h_warm)
                    + self._plan_split(tail, t_live, t_warm))
