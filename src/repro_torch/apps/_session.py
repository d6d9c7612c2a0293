"""``make_session`` of the ported apps."""
from __future__ import annotations

from typing import Dict, Optional

from ..core import Session


def make_session(mesh, backend: Optional[str], overrides) -> Session:
    """A Session wired for an app's ``mesh=`` knob: the ``ooc-sharded``
    backend over the configured device mesh, plain ``ooc`` when unsharded
    (or ``backend``), with ``overrides`` as ExecutionConfig fields."""
    kw: Dict[str, object] = {}
    if mesh is not None:
        kw["mesh"] = mesh
        backend = backend or "ooc-sharded"
    kw.update(overrides)
    return Session(backend or "ooc", **kw)
