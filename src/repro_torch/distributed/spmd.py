"""The pieces the models' mesh paths are built from: a DTensor's spec and
its compute layout, activation constraints, and ``local_map`` with the
gradient placements that a sharded computation implies.

The reference runs one SPMD program that XLA partitions from its sharding
constraints.  Here the activations between sublayers are DTensors with the
reference's constraints as their placements (``constrain``: a
``redistribute``), and each sublayer runs as plain torch code on local
shards under ``torch.distributed.tensor.experimental.local_map``: its
weights are gathered over the batch axes first (``compute_spec``: ZeRO-3's
all-gather on use; the backward reduce-scatters the gradients), its
``model``-sharded weights stay sharded, and the outputs that each rank
holds only a share of are ``Partial`` on ``model`` until a constraint sums
them.  Running the sublayers on local tensors keeps DTensor's sharding
propagation out of ops that have no rule for it (the chunked attention's
masks, the moe combine's ``sort``/``searchsorted`` and indexed write) and
keeps every collective visible at the constraints.

``local_map``'s ``in_grad_placements`` say what the local gradient of an
input is: ``Partial`` over every mesh axis along which the ranks computed
different shares of the work (the batch axes when the activations are
sharded there, ``model`` when the sublayer's work is split over it), else
the input's own placements.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import torch

from .sharding import Spec, _names, mesh_axes, placements, spec_of

BATCH_AXES = ("pod", "data")


def compute_spec(spec: Spec, keep: Iterable[str] = ("model",)) -> Spec:
    """``spec`` with every axis but those in ``keep`` dropped: the layout a
    weight is used in (FSDP's gather over ``data``)."""
    keep = tuple(keep)
    out = []
    for ax in spec:
        kept = tuple(a for a in _names(ax) if a in keep)
        out.append(None if not kept else (kept[0] if len(kept) == 1 else kept))
    return tuple(out)


def use_spec(w) -> Spec:
    """The compute layout of a DTensor weight: its own spec over ``model``."""
    return compute_spec(spec_of(w))


def sharded_on(spec: Spec, axis: str) -> bool:
    return any(axis in _names(ax) for ax in spec)


def pl(mesh, spec: Spec, partial: Iterable[str] = ()) -> Tuple[Any, ...]:
    """The placements of ``spec``, with ``Partial()`` on each axis of
    ``partial`` that is on the mesh and that ``spec`` leaves replicated."""
    from torch.distributed.tensor import Partial, Replicate

    out = list(placements(spec, mesh))
    names = list(mesh_axes(mesh))
    for a in partial:
        if a in names and isinstance(out[names.index(a)], Replicate):
            out[names.index(a)] = Partial()
    return tuple(out)


def bspec(mesh, batch: int):
    """Batch-axis names if they divide the batch, else None (the
    reference's ``_bspec``)."""
    if mesh is None:
        return None
    axes = mesh_axes(mesh)
    ba = tuple(a for a in axes if a in BATCH_AXES)
    if not ba:
        return None
    nb = 1
    for a in ba:
        nb *= axes[a]
    return ba if batch % nb == 0 else None


def constrain(x, mesh, spec: Spec):
    """The reference's ``with_sharding_constraint``: ``x`` (a DTensor)
    redistributed to ``spec`` on ``mesh``; ``x`` as it is without a mesh."""
    if mesh is None:
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def model_size(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


def model_rank(mesh) -> int:
    """This rank's coordinate on ``model`` (0 without that axis)."""
    if "model" not in mesh_axes(mesh):
        return 0
    return mesh.get_local_rank("model")


def spmd(fn: Callable, mesh, args: Sequence[Any], specs: Sequence[Optional[Spec]],
         grad_partial: Sequence[Iterable[str]], out_specs, out_partial=()):
    """``fn`` on the local shards of ``args`` under ``local_map``.

    ``specs[i]`` is the layout ``args[i]`` is redistributed to first (None
    for a non-tensor argument), ``grad_partial[i]`` the axes along which
    its local gradient is a partial sum.  ``out_specs`` is one spec (one
    output) or a list of specs (a tuple of outputs), ``out_partial`` the
    axes along which the output(s) are partial sums."""
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a tuple as one entry per value, a list as one value's
    # placements
    in_pl = tuple(None if s is None else list(pl(mesh, s)) for s in specs)
    grad_pl = tuple(None if s is None else list(pl(mesh, s, g))
                    for s, g in zip(specs, grad_partial))
    if isinstance(out_specs, list):
        if not isinstance(out_partial, list):
            out_partial = [out_partial] * len(out_specs)
        out_pl = tuple(list(pl(mesh, s, p)) for s, p in zip(out_specs, out_partial))
    else:
        out_pl = list(pl(mesh, out_specs, out_partial))
    args = tuple(a if s is None or not hasattr(a, "redistribute")
                 else a.redistribute(mesh, p) for a, s, p in zip(args, specs, in_pl))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` in the forward; its gradient times ``scale`` in the backward."""
    if scale == 1.0 or not x.requires_grad:
        return x
    return _ScaleGrad.apply(x, scale)


# -- functional collectives on local tensors -------------------------------------
def _funcol():
    from torch.distributed import _functional_collectives as funcol

    return funcol


def wait(t: torch.Tensor) -> torch.Tensor:
    funcol = _funcol()
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along ``dim``."""
    funcol = _funcol()
    fn = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return wait(fn(t.contiguous(), dim, group))


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced by ``op`` (``sum``, ``max``, ``avg`` where the backend has it) over ``group``."""
    return wait(_funcol().all_reduce(t, op, group))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (M, ...) after an all_to_all over ``group``: row m goes to rank
    m, and row m of the result came from rank m; differentiable where
    autograd records (the autograd op has no kernel under inference mode)."""
    funcol = _funcol()
    grad = torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
    fn = funcol.all_to_all_single_autograd if grad else funcol.all_to_all_single
    return wait(fn(t.contiguous(), None, None, group))
