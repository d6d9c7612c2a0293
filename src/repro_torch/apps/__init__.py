"""The paper's benchmark applications on :mod:`repro_torch.core`.

Ports of ``src/repro/apps``: the same datasets, loops, ranges, stencils and
recording order (so a chain that fits unsplit plans byte-equal to the
reference package's), with the loop kernels written in torch ops.  Kernels
that make fresh tensors make them on ``acc.device``.  The apps have no
device of their own: the :class:`~repro_torch.core.Session` they run on
decides it.

* ``cloverleaf2d`` — compressible Euler, 25 datasets, 51 loops a timestep,
  a ``min`` dt reduction every step (chain breaker), a field summary every
  ``summary_every`` steps.
* ``cloverleaf3d`` — the 3-D variant, 30 datasets.
* ``opensbli`` — 3-D Taylor–Green vortex, RK3, 29 datasets, 24 loops a
  step, no reductions in the main phase (chains span ``chain_steps``).

``mesh=`` makes ``make_session`` build an ``ooc-sharded`` Session over that
mesh (``sim:N`` or ``cuda:N``); ``store=`` accepts what
:func:`repro_torch.core.make_store` does.
"""
from .cloverleaf2d import CloverLeaf2D
from .cloverleaf3d import CloverLeaf3D
from .opensbli import OpenSBLI

__all__ = ["CloverLeaf2D", "CloverLeaf3D", "OpenSBLI"]
