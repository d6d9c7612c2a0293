"""The port's planner without the tile function's workspace charge.

The port charges what its eager tile function holds on the device
(``repro_torch/core/workspace.py``) before it picks a tile count; the JAX
package charges only the slots and the pinned residency.  So at one
capacity the two packages can tile differently.  A parity test that holds
the port's plans, makespans, oracle verdicts or tuner rows against the JAX
package's at one capacity, where the counts differ per chain or candidate
(so no one ``num_tiles`` fixes them), plans inside :func:`reference_tiles`:
the tile counts are then the reference's.  ``tests/test_torch_workspace.py``
holds the charge itself.
"""
import contextlib

import pytest


@contextlib.contextmanager
def reference_tiles():
    """Plan as the JAX package does for the ``with`` body.  Where the port
    has no charge (a package from before it), nothing changes."""
    try:
        from repro_torch.core.workspace import Workspaces
    except ImportError:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Workspaces, "charge", lambda self, *args, **kwargs: 0)
        yield
