"""The multi-tenant stencil server.

A :class:`StencilServer` owns a pool of *lanes* — one full
:class:`~repro_torch.core.executor.OutOfCoreExecutor` per device of a
:class:`~repro_torch.core.mesh.DeviceMesh` — plus one
:class:`~repro_torch.serve.SharedPlanCache` and one ledger-backed
:class:`~repro_torch.serve.AdmissionOracle` shared by everything.

Tenants attach with :meth:`session`, which returns an ordinary
:class:`~repro_torch.core.Session` whose backend is a :class:`ServerClient`;
the three bundled apps run through it unchanged.  Every flushed chain
becomes one *job*:

1. the admission oracle lowers it to Plan IR (through the shared cache) and
   predicts footprint + makespan; jobs that cannot fit even after splitting
   raise :class:`~repro_torch.serve.AdmissionError` at the submit site;
2. the job queues; when a lane frees, the scheduling policy (``fifo`` /
   ``sjf`` — priority classes always dominate) picks the next grant;
3. the chain executes on the granted lane.  A lane keeps the previous
   tenant's device-side caches warm and resets them only on tenant change,
   so a tenant bouncing between chains on one lane keeps its pinned arrays.

Chains are atomic (the paper's unit of scheduling); preemption happens at
chain boundaries, where dataset homes are authoritative.  A preempt-flagged
tenant's next submit checkpoints its datasets to the server spill directory
(:func:`~repro_torch.core.store.save_checkpoint`, format 1, which the JAX
package loads too), re-enters the queue behind the higher-priority work,
restores on re-grant (possibly on a *different* lane: migration) and resumes
bit-identically.

Determinism: tenants own disjoint datasets and kernels are pure, so results
never depend on which lane ran a chain or in what order jobs were granted —
concurrency moves wall-clock time only.  ``tests/test_torch_serve.py`` pins
this against serial runs under both policies.

Ported from ``src/repro/serve/server.py``.  What differs:

* ``device`` (``"cuda"`` by default; it raises where there is no CUDA).  On
  a ``sim:N`` mesh every lane is on ``device``, so N lanes share one card;
  on ``cuda:N`` lane i is on card i (``DeviceMesh.torch_devices``).  The
  reference's ``jax:N`` raises :class:`~repro_torch.core.MeshError`.
* Each lane on a CUDA device computes on its own stream, owned by the
  server and entered around the lane's ``run_chain``; without it every
  tenant thread would enqueue its tiles on the legacy default stream and
  the lanes would serialise there.  A plain Session computes on the
  caller's current stream.
* The default ``hw`` is the port's own target, ``H100``, where the
  reference's is its ``TPU_V5E``.
* The oracle splits chains as the port's ``run_chain`` does (see
  :mod:`repro_torch.serve.oracle`).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Union,
                    TYPE_CHECKING)

import torch

from ..core.backends import _ooc_executor
from ..core.memory import H100, HardwareModel
from ..core.mesh import parse_mesh
from ..core.program import ExecutionConfig, Session, SessionClosedError
from ..core.store import load_checkpoint, save_checkpoint
from ..obs.metrics import MetricsRegistry
from ..obs.tracer import AnyTracer, Tracer, as_tracer

from .cache import SharedPlanCache
from .errors import AdmissionError, ServeError, UnknownTenantError
from .oracle import AdmissionOracle, AdmissionVerdict
from .policy import JobView, SchedulingPolicy, make_policy
from .stats import ServerStats, TenantStats

if TYPE_CHECKING:  # pragma: no cover - typing only
    import numpy as np

    from ..core.dataset import Dataset
    from ..core.executor import ChainStats, OutOfCoreExecutor
    from ..core.loop import ParallelLoop


class _ClientCfg:
    """The ``backend.cfg`` shim a :class:`ServerClient` exposes so
    ``Session.cyclic = True`` (what the apps set) lands per-tenant instead of
    mutating a shared lane config."""

    def __init__(self, hw: HardwareModel) -> None:
        self.cyclic = False
        self.hw = hw


@dataclass
class _Tenant:
    """Server-side record of one attached session."""

    name: str
    priority: int
    cfg: _ClientCfg
    state: str = "idle"
    lane: Optional[int] = None             # lease held only while running
    closed: bool = False
    preempt_requested: bool = False
    needs_cache_reset: bool = False        # set by Session.restore()
    ckpt_path: Optional[str] = None
    datasets: Dict[str, "Dataset"] = field(default_factory=dict)
    history: List["ChainStats"] = field(default_factory=list)
    # counters mirrored into TenantStats snapshots
    chains: int = 0
    loops: int = 0
    queue_wait_s: float = 0.0
    predicted_s: float = 0.0
    achieved_modelled_s: float = 0.0
    preemptions: int = 0
    rejected: int = 0
    plan_hits: int = 0
    last_pred_s: float = 0.0


class ServerClient:
    """The Session backend that routes ``run_chain`` to a server.

    Built by :meth:`StencilServer.session`; implements exactly the backend
    protocol :mod:`repro_torch.core.backends` documents (``run_chain``,
    ``cfg``, ``history``, ``close``) plus the data-cache hook
    ``Session.restore`` calls."""

    def __init__(self, server: "StencilServer", tenant: str,
                 cfg: _ClientCfg) -> None:
        self._server = server
        self._tenant = tenant
        self.cfg = cfg

    @property
    def tenant(self) -> str:
        return self._tenant

    @property
    def tracer(self) -> AnyTracer:
        """The server-wide tracer (shared by every lane), so
        ``Session.trace()`` works on server-backed sessions too."""
        return self._server.tracer

    def run_chain(self, loops: Sequence["ParallelLoop"]
                  ) -> Dict[str, "np.ndarray"]:
        return self._server.submit(self._tenant, loops)

    @property
    def history(self) -> List["ChainStats"]:
        return self._server.tenant_history(self._tenant)

    def reset_data_caches(self) -> None:
        self._server.flag_cache_reset(self._tenant)

    def close(self) -> None:
        self._server.deregister(self._tenant)


class StencilServer:
    """Admit many tenant Sessions onto one shared lane pool.

    ``mesh`` sizes the pool (``"sim:4"`` = four lanes on ``device``;
    ``"cuda:N"`` = one lane per card); the remaining knobs mirror
    :class:`~repro_torch.core.program.ExecutionConfig` and apply to every
    lane uniformly, which is what makes cross-tenant plan sharing sound
    (config knobs are part of the shared-cache key)."""

    def __init__(self, mesh: Union[str, int, None] = "sim:4", *,
                 device: str = "cuda",
                 policy: str = "fifo",
                 backend: str = "ooc",
                 hw: Union[HardwareModel, str] = H100,
                 capacity_bytes: Optional[float] = None,
                 num_slots: int = 3,
                 num_tiles: Optional[int] = None,
                 tiled_dim: int = 0,
                 prefetch: bool = False,
                 flops_per_point: Optional[int] = None,
                 transfer: str = "sync",
                 codec: Union[str, Dict[str, str]] = "identity",
                 host_capacity: Optional[float] = None,
                 spill_dir: Optional[str] = None,
                 auto_preempt: bool = True,
                 max_shared_plans: int = 128,
                 trace: Union[bool, Tracer] = False,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if backend not in ("ooc", "ooc-async", "sim"):
            raise ServeError(
                f"serving lanes must be ooc-family executors, got {backend!r}")
        self.mesh = parse_mesh(mesh if mesh is not None else 1)
        # One wall-clock source for everything the server times: tenant
        # queue-wait accounting (ServerStats predicted-vs-achieved rows),
        # serve-layer spans and lane spans all read ``self._clock`` — inject
        # a fake in tests to pin them to the same instants.
        self._clock: Callable[[], float] = (
            clock if clock is not None else time.perf_counter)
        self.tracer: AnyTracer = as_tracer(trace)
        if self.tracer.enabled:
            self.tracer.clock = self._clock  # type: ignore[method-assign]
        self.metrics_registry = MetricsRegistry()
        self._config = ExecutionConfig(
            backend="ooc", hw=hw, capacity_bytes=capacity_bytes,
            num_slots=num_slots, num_tiles=num_tiles, tiled_dim=tiled_dim,
            prefetch=prefetch, flops_per_point=flops_per_point,
            simulate_only=(backend == "sim"),
            transfer=("threaded" if backend == "ooc-async" else transfer),
            codec=codec, host_capacity=host_capacity, device=device)
        self.plan_cache = SharedPlanCache(max_plans=max_shared_plans)
        devices = ([str(d) for d in self.mesh.torch_devices()]
                   if self.mesh.kind == "cuda"
                   else [self._config.device] * self.mesh.num_devices)
        self.lanes: List["OutOfCoreExecutor"] = [
            _ooc_executor(self._config, shared_plans=self.plan_cache,
                          device=dev)
            for dev in devices]
        # One compute stream per lane on a CUDA device, entered around the
        # lane's chain: lanes sharing a card overlap instead of queueing on
        # the default stream.
        self.lane_streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(lane.device)
            if lane.device.type == "cuda" and not lane.cfg.simulate_only
            else None
            for lane in self.lanes]
        # The tracer rides on the lanes directly rather than through
        # ``self._config`` so the admission oracle's sim executor (which
        # shares that config) never pollutes the trace with phantom runs.
        for i, lane_ex in enumerate(self.lanes):
            lane_ex.tracer = self.tracer
            lane_ex.trace_tag = f"lane{i}/"
        self.oracle = AdmissionOracle(self._config, self.plan_cache)
        self.policy: SchedulingPolicy = make_policy(policy)
        self.auto_preempt = auto_preempt
        self._own_spill = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="repro-serve-")
        self._cond = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._free: List[int] = list(range(self.mesh.num_devices))
        self._waiting: List[JobView] = []
        self._seq = 0
        self._lane_busy: List[float] = [0.0] * self.mesh.num_devices
        self.jobs_completed = 0
        self.jobs_rejected = 0
        self.preemptions = 0
        self._closed = False

    # -- tenant lifecycle -------------------------------------------------------
    def session(self, tenant: Optional[str] = None, *,
                priority: int = 0) -> Session:
        """Register a tenant and return its :class:`Session` (backend =
        :class:`ServerClient`).  ``Session.close()`` deregisters it."""
        with self._cond:
            if self._closed:
                raise ServeError("server is closed")
            name = tenant or f"tenant-{len(self._tenants)}"
            existing = self._tenants.get(name)
            if existing is not None and not existing.closed:
                raise ServeError(f"tenant {name!r} is already attached")
            ten = _Tenant(name=name, priority=priority,
                          cfg=_ClientCfg(hw=self._config.hw))
            self._tenants[name] = ten
        return Session(backend=ServerClient(self, name, ten.cfg))

    def deregister(self, name: str) -> None:
        """Detach a tenant (idempotent; called by ``Session.close``)."""
        with self._cond:
            ten = self._tenants.get(name)
            if ten is None or ten.closed:
                return
            ten.closed = True
            ten.state = "closed"
            self._cond.notify_all()

    def _tenant(self, name: str) -> _Tenant:
        ten = self._tenants.get(name)
        if ten is None:
            raise UnknownTenantError(f"unknown tenant {name!r}")
        if ten.closed:
            raise SessionClosedError(
                f"tenant {name!r} submitted work after Session.close()")
        return ten

    # -- the job path -----------------------------------------------------------
    def submit(self, name: str, loops: Sequence["ParallelLoop"]
               ) -> Dict[str, "np.ndarray"]:
        """Admit, queue, and execute one chain for ``name``; returns its
        reduction results.  Blocks until a lane is granted and the chain has
        run.  Raises :class:`AdmissionError` if the oracle rejects it."""
        loops = list(loops)
        with self._cond:
            ten = self._tenant(name)
            for lp in loops:
                for a in lp.args:
                    ten.datasets[a.dat.name] = a.dat
            cyclic = ten.cfg.cyclic
        tr = self.tracer
        mr = self.metrics_registry
        t_adm = tr.clock() if tr.enabled else 0.0
        verdict = self.oracle.predict(loops, cyclic=cyclic, tenant=name)
        if tr.enabled:
            tr.emit("admit", cat="serve", track=f"tenant/{name}",
                    t_start=t_adm, t_end=tr.clock(),
                    args={"tenant": name, "admitted": verdict.admitted,
                          "predicted_s": verdict.predicted_makespan_s})
        if not verdict.admitted:
            with self._cond:
                ten.rejected += 1
                self.jobs_rejected += 1
            mr.counter("jobs_rejected").inc()
            raise AdmissionError(
                f"job rejected for tenant {name!r}: {verdict.reason}",
                predicted_bytes=verdict.predicted_bytes,
                capacity_bytes=verdict.capacity_bytes)

        preempt_path: Optional[str] = None
        with self._cond:
            if ten.preempt_requested and ten.datasets:
                preempt_path = os.path.join(
                    self.spill_dir, f"{name}.preempt.npz")
        if preempt_path is not None:
            # Chain boundary: homes are authoritative, so the snapshot is the
            # tenant's whole live state.  Taken outside the server lock —
            # only this tenant's thread touches these datasets.
            t_ck = tr.clock() if tr.enabled else 0.0
            save_checkpoint(preempt_path, list(ten.datasets.values()),
                            chains_flushed=ten.chains)
            if tr.enabled:
                tr.emit("preempt-checkpoint", cat="serve",
                        track=f"tenant/{name}",
                        t_start=t_ck, t_end=tr.clock(),
                        args={"tenant": name,
                              "datasets": len(ten.datasets)})
            mr.counter("preemptions").inc()
            with self._cond:
                ten.preempt_requested = False
                ten.preemptions += 1
                self.preemptions += 1
                ten.state = "preempted"
                ten.ckpt_path = preempt_path
                ten.needs_cache_reset = True

        t0 = self._clock()
        with self._cond:
            lane_idx = self._await_grant_locked(ten, verdict)
            t_grant = self._clock()
            ten.queue_wait_s += t_grant - t0
            ten.state = "running"
            ten.last_pred_s = verdict.predicted_makespan_s
            ten.predicted_s += verdict.predicted_makespan_s
        if tr.enabled:
            tr.emit("queue-wait", cat="serve", track=f"tenant/{name}",
                    t_start=t0, t_end=t_grant,
                    args={"tenant": name, "lane": lane_idx})
        mr.histogram("queue_wait_s").observe(t_grant - t0)
        mr.gauge("queue_depth").set(float(len(self._waiting)))
        lane = self.lanes[lane_idx]
        stream = self.lane_streams[lane_idx]
        try:
            if lane.tenant != name or ten.needs_cache_reset:
                lane.reset_data_caches()
                lane.tenant = name
                ten.needs_cache_reset = False
            if ten.ckpt_path is not None:
                # Resume after preemption — possibly on a different lane
                # (migration).  Restoring re-materialises the exact homes the
                # checkpoint captured, so the resumed run is bit-identical.
                t_rs = tr.clock() if tr.enabled else 0.0
                load_checkpoint(ten.ckpt_path, list(ten.datasets.values()))
                lane.reset_data_caches()
                ten.ckpt_path = None
                if tr.enabled:
                    tr.emit("preempt-restore", cat="serve",
                            track=f"tenant/{name}",
                            t_start=t_rs, t_end=tr.clock(),
                            args={"tenant": name, "lane": lane_idx})
            lane.cfg.cyclic = bool(ten.cfg.cyclic)
            h0 = len(lane.history)
            hits0 = lane.plan_hits
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                reds = lane.run_chain(loops)
            with self._cond:
                new = lane.history[h0:]
                achieved = sum(cs.modelled_s for cs in new)
                ten.history.extend(new)
                ten.achieved_modelled_s += achieved
                self._lane_busy[lane_idx] += achieved
                ten.plan_hits += lane.plan_hits - hits0
                ten.chains += 1
                ten.loops += len(loops)
                self.jobs_completed += 1
            mr.counter("jobs_completed").inc()
            mr.histogram("achieved_modelled_s").observe(achieved)
            return reds
        finally:
            with self._cond:
                ten.state = "idle" if not ten.closed else "closed"
                self._release_locked(ten)
            if tr.enabled:
                # The lane lease: one slice per job on the lane's own track,
                # named after the tenant that held it.
                tr.emit(name, cat="lease", track=f"lane{lane_idx}",
                        t_start=t_grant, t_end=tr.clock(),
                        args={"tenant": name, "lane": lane_idx,
                              "predicted_s": verdict.predicted_makespan_s})

    def _next_seq_locked(self) -> int:
        self._seq += 1
        return self._seq

    def _await_grant_locked(self, ten: _Tenant,
                            verdict: AdmissionVerdict) -> int:
        """Queue this job and block until the policy grants it a lane."""
        entry = JobView(tenant=ten.name, seq=self._next_seq_locked(),
                        priority=ten.priority,
                        predicted_makespan_s=verdict.predicted_makespan_s)
        self._waiting.append(entry)
        ten.state = "queued" if ten.state != "preempted" else ten.state
        try:
            while True:
                if ten.closed:
                    raise SessionClosedError(
                        f"tenant {ten.name!r} was closed while queued")
                if self._closed:
                    raise ServeError("server closed while a job was queued")
                if self._free:
                    pick = self.policy.select(self._waiting)
                    if pick is entry:
                        lane_idx = self._free.pop(0)   # lowest index: sticky
                        ten.lane = lane_idx
                        self._waiting.remove(entry)
                        self._cond.notify_all()
                        return lane_idx
                if self.auto_preempt:
                    self._flag_victim_locked(entry)
                # Timed wait: a missed notify (or a policy pick that went to
                # another waiter) must not strand this job.
                self._cond.wait(timeout=0.05)
        except BaseException:
            if entry in self._waiting:
                self._waiting.remove(entry)
            self._cond.notify_all()
            raise

    def _flag_victim_locked(self, waiter: JobView) -> None:
        """With every lane busy and a higher-priority job waiting, flag the
        lowest-priority *running* tenant: at its next chain boundary it
        checkpoints, yields its place and re-queues behind this job."""
        if self._free:
            return
        running = [t for t in self._tenants.values()
                   if t.state == "running" and not t.preempt_requested]
        victims = [t for t in running if t.priority < waiter.priority]
        if not victims:
            return
        victim = min(victims, key=lambda t: (t.priority, t.name))
        victim.preempt_requested = True

    def _release_locked(self, ten: _Tenant) -> None:
        if ten.lane is not None:
            self._free.append(ten.lane)
            self._free.sort()
            ten.lane = None
        self._cond.notify_all()

    # -- preemption -------------------------------------------------------------
    def preempt(self, name: str) -> None:
        """Flag ``name`` for preemption.  Takes effect at the tenant's next
        chain boundary (its next submit): checkpoint, re-queue, restore on
        re-grant.  Chains themselves are atomic."""
        with self._cond:
            ten = self._tenant(name)
            ten.preempt_requested = True
            self._cond.notify_all()

    # -- client plumbing --------------------------------------------------------
    def tenant_history(self, name: str) -> List["ChainStats"]:
        with self._cond:
            ten = self._tenants.get(name)
            return list(ten.history) if ten is not None else []

    def flag_cache_reset(self, name: str) -> None:
        """Session.restore() hook: device-side caches that could shadow the
        restored homes must die before the tenant's next chain."""
        with self._cond:
            ten = self._tenants.get(name)
            if ten is not None:
                ten.needs_cache_reset = True

    # -- observability ----------------------------------------------------------
    def sla_estimate(self, name: str) -> Dict[str, float]:
        """A tenant's service outlook: queue depth, a queue-wait estimate
        (total predicted work waiting, spread over the lanes) and the
        oracle's prediction for its most recent chain shape."""
        with self._cond:
            ten = self._tenant(name)
            backlog = sum(j.predicted_makespan_s for j in self._waiting)
            return {
                "queued_jobs": float(len(self._waiting)),
                "predicted_queue_wait_s": backlog / max(len(self.lanes), 1),
                "predicted_makespan_s": ten.last_pred_s,
            }

    def metrics(self) -> Dict[str, Any]:
        """Snapshot of the server's :class:`~repro_torch.obs.MetricsRegistry`
        — counters (``jobs_completed`` / ``jobs_rejected`` /
        ``preemptions``), the ``queue_wait_s`` and ``achieved_modelled_s``
        histograms, and instantaneous scheduler gauges.  All timings in it
        were read from the same injected clock the tracer and :meth:`stats`
        rows use."""
        mr = self.metrics_registry
        with self._cond:
            mr.gauge("queue_depth").set(float(len(self._waiting)))
            mr.gauge("free_lanes").set(float(len(self._free)))
            mr.gauge("tenants").set(float(sum(
                1 for t in self._tenants.values() if not t.closed)))
        return mr.snapshot()

    def stats(self) -> ServerStats:
        """Snapshot of every counter the serving layer keeps."""
        with self._cond:
            tenants = {
                name: TenantStats(
                    tenant=name, priority=t.priority, state=t.state,
                    lane=t.lane, chains=t.chains, loops=t.loops,
                    queue_wait_s=t.queue_wait_s, predicted_s=t.predicted_s,
                    achieved_modelled_s=t.achieved_modelled_s,
                    preemptions=t.preemptions, rejected=t.rejected,
                    plan_hits=t.plan_hits)
                for name, t in self._tenants.items()}
            return ServerStats(
                policy=self.policy.name, lanes=len(self.lanes),
                mesh=self.mesh.spec, tenants=tenants,
                jobs_completed=self.jobs_completed,
                jobs_rejected=self.jobs_rejected,
                preemptions=self.preemptions,
                lane_busy_modelled_s=list(self._lane_busy),
                plan_cache=self.plan_cache.stats())

    # -- lifecycle --------------------------------------------------------------
    def close(self) -> None:
        """Detach every tenant, release lane resources (transfer-engine
        workers), drop the spill directory if the server created it.
        Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            for ten in self._tenants.values():
                ten.closed = True
                ten.state = "closed"
            self._cond.notify_all()
        for lane in self.lanes:
            lane.close()
        self.oracle.close()
        if self._own_spill:
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __enter__(self) -> "StencilServer":
        return self

    def __exit__(self, exc_type: object, exc: object, tb: object) -> None:
        self.close()
