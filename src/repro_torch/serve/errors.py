"""Typed errors for the serving layer.

Copied from ``src/repro/serve/errors.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class AdmissionError(ServeError):
    """The admission oracle rejected a job: its predicted fast-memory
    footprint cannot fit the pool even after chain splitting down to single
    loops (``run_chain`` would die with MemoryError — the server refuses it
    up front instead of wedging a lane)."""

    def __init__(self, message: str, *, predicted_bytes: int = 0,
                 capacity_bytes: float = 0.0) -> None:
        super().__init__(message)
        self.predicted_bytes = predicted_bytes
        self.capacity_bytes = capacity_bytes


class UnknownTenantError(ServeError):
    """An operation referenced a tenant the server has never registered (or
    one already deregistered by :meth:`Session.close`)."""
