"""String-keyed backend registry: how a :class:`~repro_torch.core.program.Session`
turns an :class:`~repro_torch.core.program.ExecutionConfig` into something
that can run loop chains.

Ported from ``src/repro/core/backends.py``.  A backend is any object with
``run_chain(loops) -> {reduction: value}``; optional attributes the session
surfaces when present: ``history`` (per-chain
:class:`~repro_torch.core.executor.ChainStats`), ``cfg`` (for the cyclic
flag), and ``plan_hits``/``plan_misses``/``plan_time_s``.

Built-ins:

==============  ===============================================================
``reference``   eager oracle on the session's device, program order, no
                tiling (tests)
``resident``    paper baseline: everything in fast memory, raises beyond it
``ooc``         3-slot out-of-core streaming executor (Algorithm 1)
``ooc-async``   ``ooc`` with the threaded transfer engine: staging on
                background workers overlapping compute (bit-identical output)
``ooc-cyclic``  ``ooc`` with the §4.1 unsafe-temporaries elision pre-enabled
``sim``         ``ooc`` without the data plane: the same Plan IR stream,
                interpreted by the ledger interpreter only (modelled runs)
``cuda``        eager backend routing tagged star-sweep loops through the
                hand-written CUDA kernels in :mod:`repro_torch.kernels`, with
                the reference path for every untagged loop; ``pallas`` is the
                same backend under the reference package's name
``ooc-sharded`` device-mesh execution: the grid decomposed along
                ``shard_dim`` over ``config.mesh`` (``"sim:N"`` virtual or
                ``"cuda:N"`` real devices), every shard running the full
                out-of-core machinery with one accumulated-depth halo
                exchange per chain (paper §5.2)
==============  ===============================================================

Any ``ooc``-family backend given a multi-device ``mesh=`` routes through
the sharded executor (:mod:`repro_torch.core.sharded`) — the mesh is an
orthogonal axis of the config, not a separate code path.

Register your own with::

    @register_backend("my-backend")
    def _build(config: ExecutionConfig):
        return MyExecutor(...)
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .loop import AccessMode, ParallelLoop
from .reference import (
    merge_loop_reductions,
    run_chain_reference,
    run_loop_reference,
)

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator registering ``factory(config) -> backend`` under ``name``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_backend(config):
    """Instantiate the backend ``config.backend`` names."""
    factory = _REGISTRY.get(config.backend)
    if factory is None:
        raise ValueError(
            f"unknown backend {config.backend!r}; "
            f"available: {', '.join(available_backends())}")
    return factory(config)


# -- built-in backends ------------------------------------------------------------


class ReferenceBackend:
    """Eager oracle, program order, on ``device`` (homes copied up whole
    per chain on a CUDA device; the homes themselves on the CPU)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.history: List = []

    def run_chain(self, loops: Sequence[ParallelLoop]):
        return run_chain_reference(loops, self.device)


def kernel_eligible(lp: ParallelLoop, op) -> bool:
    """Whether a tagged loop has the shape the star-sweep kernels compute:
    no reductions, a star kind, ``dst`` overwritten from a distinct ``src``
    and nothing else written, and a one-cell halo of ``src`` in bounds.
    These are the reference's ``PallasBackend._try_pallas`` conditions, so
    the two packages send the same loops to their kernels."""
    kind, src, dst, _ = op
    if lp.reductions or kind not in ("stencil2d", "stencil3d"):
        return False
    dats = {a.dat.name: a.dat for a in lp.args}
    if src not in dats or dst not in dats:
        return False
    write_args = [a for a in lp.args if a.mode.writes]
    if (src == dst or len(write_args) != 1
            or write_args[0].dat.name != dst
            or write_args[0].mode is AccessMode.INC):
        return False
    for d, (lo, hi) in enumerate(lp.range_):
        blo, bhi = dats[src].bounds(d)
        if lo - 1 < blo or hi + 1 > bhi:
            return False
    return True


class KernelBackend:
    """Eager backend with the hand-written CUDA star-sweep kernels.

    Loops whose kernel carries a ``pallas_op`` tag (built by
    :func:`repro_torch.kernels.star2d_kernel` / ``star3d_kernel``) and pass
    :func:`kernel_eligible` run through ``stencil2d``/``stencil3d`` on
    ``device``: the source box and its halo go up from the home, the kernel
    runs, and the result comes home.  Every other loop takes the reference
    path.  On a CUDA device a kernel that cannot launch raises — nothing
    falls back.  On ``device="cpu"`` the wrappers run their plain versions.
    The counters keep the reference's names: ``pallas_loops`` (kernel) and
    ``fallback_loops`` (reference path)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.history: List = []
        self.pallas_loops = 0
        self.fallback_loops = 0

    def run_chain(self, loops: Sequence[ParallelLoop]):
        merged: Dict[str, np.ndarray] = {}
        for lp in loops:
            op = getattr(lp.kernel, "pallas_op", None)
            if op is not None and kernel_eligible(lp, op):
                self._run_kernel(lp, op)
                self.pallas_loops += 1
                continue
            self.fallback_loops += 1
            merge_loop_reductions(merged, lp, run_loop_reference(lp))
        return merged

    def _run_kernel(self, lp: ParallelLoop, op) -> None:
        from .. import kernels

        kind, src, dst, coeffs = op
        dats = {a.dat.name: a.dat for a in lp.args}
        src_dat, dst_dat = dats[src], dats[dst]
        if self.device.type == "cuda":
            src_dat.pin()
            dst_dat.pin()
        box = lp.range_
        halo_box = tuple((a - 1, b + 1) for a, b in box)
        x = src_dat.box_tensor(halo_box).to(self.device, copy=True,
                                            memory_format=torch.contiguous_format)
        fn = kernels.stencil2d if kind == "stencil2d" else kernels.stencil3d
        dst_dat.write(box, fn(x, coeffs))


@register_backend("reference")
def _reference(config):
    return ReferenceBackend(device=config.device)


@register_backend("cuda")
def _cuda(config):
    return KernelBackend(device=config.device)


# The reference package's name for the same backend, so scripts written for
# it select the hand-written kernels here.
register_backend("pallas")(_cuda)


@register_backend("resident")
def _resident(config):
    from .executor import ResidentExecutor

    return ResidentExecutor(hw=config.hw, capacity_bytes=config.capacity_bytes,
                            device=config.device)


def _ooc_executor(config, shared_plans=None, **overrides):
    """The shared ooc-family factory: a plain executor, or — when the config
    carries a multi-device mesh — the sharded one wrapping a per-device
    executor per mesh entry.  ``shared_plans`` (a serving-layer
    :class:`~repro_torch.serve.SharedPlanCache`) attaches a cross-executor
    plan cache to unsharded executors; sharded executors plan per device
    and keep their caches private."""
    from .executor import OutOfCoreExecutor
    from .sharded import ShardedOutOfCoreExecutor

    ooc_cfg = config.ooc_config(**overrides)
    mesh = getattr(config, "mesh", None)
    if mesh is not None and mesh.num_devices > 1:
        return ShardedOutOfCoreExecutor(
            ooc_cfg, mesh=mesh, shard_dim=config.shard_dim,
            halo_depth=config.halo_depth)
    return OutOfCoreExecutor(ooc_cfg, shared_plans=shared_plans)


@register_backend("ooc")
def _ooc(config):
    return _ooc_executor(config)


@register_backend("ooc-cyclic")
def _ooc_cyclic(config):
    return _ooc_executor(config, cyclic=True)


@register_backend("ooc-async")
def _ooc_async(config):
    """``ooc`` with the threaded transfer engine pre-enabled: uploads and
    downloads stage on background workers and genuinely overlap compute.
    Bit-identical to ``ooc`` on the CPU and on the device: the tasks touch
    disjoint regions, and every write into a slot waits for the slot's last
    download — threading changes wall-clock behaviour only."""
    return _ooc_executor(config, transfer="threaded")


@register_backend("sim")
def _sim(config):
    return _ooc_executor(config, simulate_only=True)


@register_backend("ooc-sharded")
def _ooc_sharded(config):
    """Device-mesh execution, explicitly: always the sharded executor, even
    on a 1-device mesh (where it is bit-identical to ``ooc`` and simply
    skips decomposition and exchange)."""
    from .mesh import DeviceMesh
    from .sharded import ShardedOutOfCoreExecutor

    mesh = getattr(config, "mesh", None) or DeviceMesh.sim(1)
    return ShardedOutOfCoreExecutor(
        config.ooc_config(), mesh=mesh, shard_dim=config.shard_dim,
        halo_depth=config.halo_depth)
