"""``make_session`` of the ported apps."""
from __future__ import annotations

from typing import Optional

from ..core import Session


def make_session(mesh, backend: Optional[str], overrides) -> Session:
    """An ``ooc`` Session (or ``backend``) with ``overrides`` as
    ExecutionConfig fields.  A ``mesh`` needs the sharded executor, which
    the port has not ported (ROADMAP A10): it raises rather than run
    unsharded."""
    if mesh is not None:
        raise NotImplementedError(
            f"mesh={mesh!r}: sharded execution is ROADMAP item A10 of the "
            f"port; the app will not run unsharded in its place")
    return Session(backend or "ooc", **overrides)
