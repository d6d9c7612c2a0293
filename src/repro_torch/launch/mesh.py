"""Mesh construction for the LM paths: a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.

Ported from ``src/repro/launch/mesh.py``.  Single pod: 256 ranks as
(data=16, model=16), the model axis sized to one torus dimension so the
tensor-parallel collectives stay on the fastest links.  Multi-pod: 2 pods
x 256 ranks as (pod=2, data=16, model=16); the pod axis is for coarse
parallelism only (extra data parallelism with one gradient all-reduce a
step, optionally int8-compressed).

The mesh needs a process group of as many ranks: real ones (``torchrun``),
or the ``fake`` group of the dry run (``fake_process_group``), which
communicates nothing and lets one process stand for every rank.  Which
backend a group uses is always the caller's explicit choice
(``init_ranks``); nothing here switches it.  Ranks that share a card run
on gloo (NCCL refuses two ranks on one device), whose functional
all-gather of CUDA tensors crashes in PyTorch 2.11: ``init_ranks`` routes
it through the c10d call for such a group (``route_gloo_cuda_all_gather``).
These are functions, not module constants: importing this module starts
no process group.

Not to be confused with ``repro_torch.core.mesh``, the stencil runtime's
``sim:N`` / ``cuda:N`` device meshes.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_ranks(backend: str, device_type: str = "cpu") -> int:
    """Join the process group of the ranks ``torchrun`` launched
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` in the
    environment) on ``backend``, or, without them, a group of this one
    rank; returns the world size.  Does nothing when a group exists.  A
    gloo group for CUDA tensors gets ``route_gloo_cuda_all_gather`` first
    (said on stderr by rank 0)."""
    if backend == "gloo" and device_type == "cuda":
        route_gloo_cuda_all_gather()
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if backend == "gloo" and device_type == "cuda" and dist.get_rank() == 0:
        print("gloo on CUDA tensors: the functional all-gather goes through "
              "dist.all_gather_into_tensor (PyTorch 2.11's crashes on them)",
              file=sys.stderr, flush=True)
    return dist.get_world_size()


def route_gloo_cuda_all_gather() -> None:
    """In this process, route the functional all-gather (``all_gather_tensor``
    and ``all_gather_single`` of ``torch.distributed._functional_collectives``,
    which DTensor's redistribute and ``distributed.spmd.all_gather`` call) of
    a CUDA tensor in a gloo group through ``dist.all_gather_into_tensor``,
    the same collective on the same group by the c10d API; every other call
    goes to the original.  PyTorch 2.11's functional all-gather segfaults in
    ``wait_tensor`` for gloo on CUDA tensors, where the c10d call and the
    functional all-reduce, reduce-scatter and all-to-all work.  Ranks that
    share one card need gloo: NCCL refuses two ranks on one device."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group

    for name in ("all_gather_tensor", "all_gather_single"):
        original = getattr(funcol, name, None)
        if original is None or getattr(original, "_routed", False):
            continue

        def all_gather(self, gather_dim, group, tag="", _original=original):
            pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
            if not (self.is_cuda and dist.get_backend(pg) == "gloo"):
                return _original(self, gather_dim, group, tag)
            x = self.contiguous()
            out = x.new_empty((pg.size() * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=pg)
            if gather_dim != 0:
                out = torch.cat(torch.chunk(out, pg.size(), dim=0), dim=gather_dim)
            return out
        all_gather._routed = True
        setattr(funcol, name, all_gather)


def fake_process_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks in this process, as rank
    0: collectives return at once and move nothing (the dry run's).  The
    backend is PyTorch's ``FakeProcessGroup``, registered here when no one
    has."""
    from torch._C._distributed_c10d import FakeProcessGroup

    if "fake" not in dist.Backend._plugins and "FAKE" not in dist.Backend._plugins:
        def create(common_opts, backend_opts):
            return FakeProcessGroup._create_internal(
                common_opts.group_rank, common_opts.group_size, backend_opts)
        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over the process group (256 or 512 ranks)."""
    shape, names = PRODUCTION[multi_pod]
    world = dist.get_world_size()
    if world != int(torch.tensor(shape).prod()):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{int(torch.tensor(shape).prod())} ranks; the group has {world}")
    return _mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, *, device_type: str = "cpu"):
    """(world // model, model) as (data, model) over whatever ranks were
    launched (one without ``torchrun``); ``model`` is clamped to the world
    size, as the reference clamps it to the device count."""
    world = dist.get_world_size()
    model = max(1, min(model, world))
    if world % model:
        raise ValueError(f"--model-parallel {model} does not divide the {world} ranks")
    return _mesh(device_type, (world // model, model), ("data", "model"))
