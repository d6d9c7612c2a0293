"""Asynchronous transfer engine: upload/download queues on worker threads.

Algorithm 1 runs three streams — compute, upload, download — and the paper's
whole argument is that host<->device traffic must overlap compute.  The
executor previously performed every transfer synchronously inline and only
*modelled* the overlap through the ledger; this engine makes the data plane
genuinely concurrent: one background worker per direction drains a FIFO
queue of staging tasks (slice + codec + copy), double-buffered against the
slot pool, while the main thread computes.

``mode="sync"`` executes every task inline at submit time — the deterministic
fallback for tests and the default.  Both modes produce bit-identical data:
tasks touch disjoint regions and functional array updates commute, so
threading changes wall-clock behaviour only.

Tasks return ``(raw_bytes, wire_bytes)``; the engine accumulates per-direction
byte/time stats (including queue-wait: submit-to-start latency) that the
executor folds into :class:`~repro_torch.core.executor.ChainStats` and benchmarks
report as the ``transfer`` section.

Copied from ``src/repro/core/transfer/engine.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.  One change: a worker
drops its finished task before it waits for the next (the reference's worker
keeps the last one, and so the last chain's device slots, alive).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...obs.metrics import Histogram

UP = "up"
DOWN = "down"
# The third lane (tiered host storage): disk<->host traffic — FetchHome
# prefetches of tile t+2's home rows and SpillHome retirements — runs on its
# own worker so it overlaps tile t+1's host->device upload AND tile t's
# compute.  One queue serves both directions of disk I/O (a spinning or
# queued-flash store serialises them anyway).
DISK = "disk"


class TransferError(RuntimeError):
    """A transfer task failed on a worker thread (original exception chained)."""


def _task_label(direction: str) -> str:
    return {UP: "upload", DOWN: "download", DISK: "disk"}.get(direction, direction)


class TransferHandle:
    """Completion token for one submitted transfer task."""

    __slots__ = ("direction", "result", "error", "t_submit", "t_start", "t_end",
                 "_event")

    def __init__(self, direction: str):
        self.direction = direction
        self.result: Optional[Tuple[int, int]] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_start = 0.0
        self.t_end = 0.0
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.t_start - self.t_submit)

    def wait(self) -> Tuple[int, int]:
        self._event.wait()
        if self.error is not None:
            raise TransferError(
                f"{_task_label(self.direction)} task failed: {self.error}"
            ) from self.error
        return self.result


class TransferEngine:
    """Owns the upload/download queues; ``submit`` returns a handle.

    ``deps`` are handles the task must wait for before running (used for the
    rare home-copy conflict: an upload reading rows a still-pending download
    is writing back).  In sync mode deps are already complete by construction.
    """

    MODES = ("sync", "threaded")

    def __init__(self, mode: str = "sync"):
        if mode not in self.MODES:
            raise ValueError(f"unknown transfer mode {mode!r}; one of {self.MODES}")
        self.mode = mode
        self._queues: Dict[str, "queue.Queue"] = {}
        self._workers: Dict[str, threading.Thread] = {}
        self._pending: List[TransferHandle] = []
        self._lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "tasks_up": 0, "tasks_down": 0, "tasks_disk": 0,
            "bytes_up_raw": 0, "bytes_up_wire": 0,
            "bytes_down_raw": 0, "bytes_down_wire": 0,
            "bytes_disk_raw": 0, "bytes_disk_wire": 0,
            "queue_wait_s": 0.0, "busy_s": 0.0,
        }
        # Per-lane latency distributions from the handle timestamps every
        # task already records: queue-wait (submit -> start) and service
        # (start -> end).  Lazily keyed by direction on first task.
        self.lane_hist: Dict[str, Dict[str, Histogram]] = {}

    # -- submission ----------------------------------------------------------
    def submit(self, direction: str, fn: Callable[[], Tuple[int, int]],
               deps: Sequence[TransferHandle] = ()) -> TransferHandle:
        assert direction in (UP, DOWN, DISK), direction
        handle = TransferHandle(direction)
        if self.mode == "sync":
            self._run(handle, fn, deps)
            if handle.error is not None:
                raise TransferError(
                    f"{_task_label(direction)} task failed: {handle.error}"
                ) from handle.error
            return handle
        with self._lock:
            self._pending.append(handle)
        self._worker_for(direction).put((handle, fn, tuple(deps)))
        return handle

    def _worker_for(self, direction: str) -> "queue.Queue":
        q = self._queues.get(direction)
        if q is None:
            q = queue.Queue()
            self._queues[direction] = q
            t = threading.Thread(
                target=self._worker_loop, args=(q,),
                name=f"transfer-{direction}", daemon=True)
            self._workers[direction] = t
            t.start()
        return q

    def _worker_loop(self, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            handle, fn, deps = item
            self._run(handle, fn, deps)
            # Drop the finished task before waiting for the next: its closure
            # holds the chain's interpreter, and with it that chain's device
            # slots, which would otherwise stay allocated beside the next
            # chain's until another task arrived.
            del item, handle, fn, deps

    def _run(self, handle: TransferHandle, fn, deps) -> None:
        try:
            for d in deps:
                d._event.wait()  # dep *completion*, not success: the failure
                # surfaces from the dep's own handle at drain
            handle.t_start = time.perf_counter()
            raw, wire = fn()
            handle.result = (int(raw), int(wire))
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            handle.error = e
        finally:
            handle.t_end = time.perf_counter()
            self._account(handle)
            handle._event.set()

    def _account(self, handle: TransferHandle) -> None:
        with self._lock:
            st = self.stats
            st["queue_wait_s"] += handle.queue_wait_s
            st["busy_s"] += max(0.0, handle.t_end - handle.t_start)
            lh = self.lane_hist.get(handle.direction)
            if lh is None:
                lh = self.lane_hist[handle.direction] = {
                    "queue_wait": Histogram(), "service": Histogram()}
            lh["queue_wait"].observe(handle.queue_wait_s)
            lh["service"].observe(max(0.0, handle.t_end - handle.t_start))
            if handle.result is not None:
                raw, wire = handle.result
                st[f"tasks_{handle.direction}"] += 1
                st[f"bytes_{handle.direction}_raw"] += raw
                st[f"bytes_{handle.direction}_wire"] += wire

    def lane_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-lane queue-wait / service-time histogram snapshots
        (``{"up": {"queue_wait": {...}, "service": {...}}, ...}``)."""
        with self._lock:
            return {lane: {k: h.snapshot() for k, h in hists.items()}
                    for lane, hists in self.lane_hist.items()}

    # -- synchronisation -----------------------------------------------------
    def drain(self) -> None:
        """Wait for every outstanding task; re-raise the first failure."""
        if self.mode == "sync":
            return
        with self._lock:
            pending, self._pending = self._pending, []
        first_error = None
        for h in pending:
            h._event.wait()
            if h.error is not None and first_error is None:
                first_error = h
        if first_error is not None:
            raise TransferError(
                f"{_task_label(first_error.direction)} task failed: "
                f"{first_error.error}") from first_error.error

    def close(self) -> None:
        """Stop worker threads (they are daemons, so this is optional)."""
        for direction, q in list(self._queues.items()):
            q.put(None)
            self._workers[direction].join(timeout=5)
        self._queues.clear()
        self._workers.clear()

    # -- stats ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.stats)

    @staticmethod
    def delta(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
        return {k: after[k] - before.get(k, 0) for k in after}
