"""Pluggable scheduling policies (string-keyed registry, like
``repro_torch.core.backends``).

A policy orders the *waiting* jobs each time a lane frees up.  Priority
classes always dominate (the preemption contract depends on higher-priority
tenants being served first); within a class the policy decides:

==========  ==============================================================
``fifo``    arrival order (submission sequence number)
``sjf``     cost-aware shortest-predicted-makespan first, from the
            admission oracle's ledger prediction; ties broken by arrival
==========  ==============================================================

Register your own::

    @register_policy("my-policy")
    class MyPolicy(SchedulingPolicy):
        def select(self, waiting):
            return min(waiting, key=...)

Copied from ``src/repro/serve/policy.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple, Type


@dataclass(frozen=True)
class JobView:
    """What a policy sees of one waiting job — deliberately value-only, so
    policies cannot reach into server internals."""

    tenant: str
    seq: int                        # global submission sequence number
    priority: int                   # higher preempts/schedules first
    predicted_makespan_s: float     # oracle prediction for the pending chain


class SchedulingPolicy:
    """Base class: pick the next job to grant a lane."""

    name: str = "?"

    def select(self, waiting: Sequence[JobView]) -> JobView:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[SchedulingPolicy]] = {}


def register_policy(name: str) -> Callable[[Type[SchedulingPolicy]],
                                           Type[SchedulingPolicy]]:
    """Decorator registering a :class:`SchedulingPolicy` subclass."""
    def deco(cls: Type[SchedulingPolicy]) -> Type[SchedulingPolicy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_policy(name: str) -> SchedulingPolicy:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"available: {', '.join(available_policies())}")
    return cls()


@register_policy("fifo")
class FifoPolicy(SchedulingPolicy):
    """Arrival order within each priority class."""

    def select(self, waiting: Sequence[JobView]) -> JobView:
        return min(waiting, key=lambda j: (-j.priority, j.seq))


@register_policy("sjf")
class ShortestJobFirst(SchedulingPolicy):
    """Shortest predicted makespan (the admission oracle's ledger estimate)
    within each priority class — classic mean-queue-wait minimiser."""

    def select(self, waiting: Sequence[JobView]) -> JobView:
        return min(waiting,
                   key=lambda j: (-j.priority, j.predicted_makespan_s, j.seq))
