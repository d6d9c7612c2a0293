"""Sharding rules: parameter / batch / cache specs per architecture, and
their DTensor placements.

Ported from ``src/repro/distributed/sharding.py``, rule for rule.  Scheme
(Megatron-TP x ZeRO-FSDP, MaxText-style):

  * ``model`` axis — tensor parallel: attention heads, MLP hidden, vocab,
    MoE expert dim (expert parallelism), Mamba inner channels.
  * ``data`` axis  — batch data-parallel AND FSDP: every 2-D+ parameter also
    shards its non-TP major dim over ``data`` (ZeRO-3: gathered on use,
    gradients reduce-scattered).  Optimizer state inherits.
  * ``pod`` axis   — extra data parallelism across pods (one gradient
    all-reduce a step, ``distributed/compression.py``).

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of axis names (major to minor), the entries of the reference's
``PartitionSpec``.  The reference stacks a list of layers along a leading
axis and gives it ``None``; the port holds one tensor per layer
(``models/transformer.py``), so the specs here are per layer and that entry
simply goes.  A rule reads the mesh only through its axis names and sizes
(``mesh_axes``): a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or any object with ``axis_names`` and a ``shape`` mapping.

``placements`` turns a spec into DTensor placements (``Shard(d)`` on the
tensor dim that names a mesh dim, else ``Replicate()``); ``shard_params``
distributes a model's parameters in place.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# The per-layer lists of the port's Transformer (the reference stacks them).
STACKED = ("blocks", "enc_blocks")


def mesh_axes(mesh) -> Dict[str, int]:
    """The mesh's axis names and sizes, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # torch DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _div(n: int, mesh, axis: str) -> bool:
    axes = mesh_axes(mesh)
    return axis in axes and n % axes[axis] == 0 and n >= axes[axis]


def _names(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def param_spec(name: str, shape: Sequence[int], cfg, mesh, *, fsdp: bool = True,
               tp: bool = True) -> Spec:
    """The spec of one layer's parameter ``name`` (its last path component,
    such as ``wq``) of per-layer ``shape``."""
    axes = mesh_axes(mesh)
    model = "model" if (tp and "model" in axes) else None
    fs = "data" if (fsdp and "data" in axes) else None
    kv_sharded = model if _div(cfg.kv_heads, mesh, "model") else None
    q_sharded = model if _div(cfg.num_heads, mesh, "model") else None
    vocab_sharded = model if _div(cfg.vocab_size, mesh, "model") else None
    dm_fs = fs if _div(cfg.d_model, mesh, "data") else None

    def ff_div(f):
        return model if _div(f, mesh, "model") else None

    nd = len(shape)
    if name == "embed":
        parts = (vocab_sharded, dm_fs)
    elif name == "lm_head":
        parts = (dm_fs, vocab_sharded)
    elif name in ("wq", "w_q"):
        parts = (dm_fs, q_sharded, None)
    elif name in ("wk", "wv"):
        parts = (dm_fs, kv_sharded, None)
    elif name == "wo":
        parts = (q_sharded, None, dm_fs)
    elif name == "bq":
        parts = (q_sharded, None)
    elif name in ("bk", "bv"):
        parts = (kv_sharded, None)
    elif name == "w_dkv":
        parts = (dm_fs, None)
    elif name in ("w_uk", "w_uv"):
        parts = (None, q_sharded, None)
    elif name in ("w_gate", "w_up"):
        parts = (model, None, None) if nd == 3 else (dm_fs, ff_div(shape[-1]))
    elif name == "w_down":
        parts = (model, None, None) if nd == 3 else (ff_div(shape[0]), dm_fs)
    elif name == "in_proj":
        parts = (dm_fs, None)
    elif name == "out_proj":
        parts = (None, dm_fs)
    else:                    # router, norms, conv, the mixers' fp32 vectors
        parts = (None,) * nd
    parts = (tuple(parts) + (None,) * nd)[:nd]
    # drop shardings that don't divide
    return tuple(ax if ax is not None
                 and dim % int(np.prod([axes[a] for a in _names(ax)])) == 0 else None
                 for dim, ax in zip(shape, parts))


def _named(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, cfg, mesh, *, fsdp: bool = True, tp: bool = True
                ) -> Dict[str, Spec]:
    """The spec of every parameter of ``params`` (a ``Transformer`` or a
    mapping of parameter name -> tensor, meta tensors included), keyed by
    the port's parameter name (``blocks.3.attn.wq``)."""
    return {n: param_spec(n.rsplit(".", 1)[-1], tuple(p.shape), cfg, mesh,
                          fsdp=fsdp, tp=tp)
            for n, p in _named(params).items()}


def batch_specs(cfg, mesh, global_batch: int, include_model: bool = False
                ) -> Dict[str, Spec]:
    """Specs for train/prefill inputs.  ``include_model=True`` spreads the
    batch over the model axis too (pure-DP/FSDP mode for models too small
    to profit from TP)."""
    axes = mesh_axes(mesh)
    ba = _batch_axes(mesh)
    if include_model and "model" in axes:
        ba = ba + ("model",)
    nb = int(np.prod([axes[a] for a in ba])) if ba else 1
    bspec = ba if (ba and global_batch % nb == 0) else ()
    d = {"tokens": (bspec or None, None), "labels": (bspec or None, None)}
    if cfg.family == "vlm":
        d["patches"] = (bspec or None, None, None)
    if cfg.encdec:
        d["enc_inputs"] = (bspec or None, None, None)
    return d


def cache_specs(cfg, mesh, batch: int) -> Dict[str, Spec]:
    """Specs for the serving cache (the reference's stacked layout, layer
    axis first).  batch >= batch-axes size shards batch; batch == 1
    (long-context) shards the sequence dim over data instead, and the
    sequence dim also takes ``model`` when the kv-head count does not
    divide it."""
    axes = mesh_axes(mesh)
    ba = _batch_axes(mesh)
    nb = int(np.prod([axes[a] for a in ba])) if ba else 1
    batch_ok = bool(ba) and batch % nb == 0
    bspec = ba if batch_ok else None
    kv_ok = _div(cfg.kv_heads, mesh, "model")
    kv_sharded = "model" if kv_ok else None
    seq_axes = []
    if not batch_ok and "data" in axes:
        seq_axes.append("data")
    if not kv_ok and "model" in axes:
        seq_axes.append("model")
    seq_spec = tuple(seq_axes) if seq_axes else None
    h_sharded = "model" if _div(cfg.ssm_heads if cfg.ssm else 0, mesh, "model") else None

    specs: Dict[str, Spec] = {"len": ()}
    if cfg.family in ("dense", "vlm", "encdec") or (cfg.family == "moe" and not cfg.mla):
        specs["k"] = (None, bspec, seq_spec, kv_sharded, None)
        specs["v"] = (None, bspec, seq_spec, kv_sharded, None)
    if cfg.family == "encdec":
        specs["enc_k"] = (None, bspec, seq_spec, kv_sharded, None)
        specs["enc_v"] = (None, bspec, seq_spec, kv_sharded, None)
    if cfg.family == "moe" and cfg.mla:
        # MLA's compressed cache has no head dim; shard seq over model too.
        mla_seq = tuple(dict.fromkeys(("model",) + tuple(seq_axes)))
        specs["ckv"] = (None, bspec, mla_seq)
        specs["kr"] = (None, bspec, mla_seq)
    if cfg.family in ("ssm", "hybrid"):
        specs["ssm"] = (None, bspec, h_sharded, None, None)
        specs["conv"] = (None, bspec, None, None)
    if cfg.family == "hybrid":
        kvh = "model" if _div(cfg.kv_heads, mesh, "model") else None
        specs["sk"] = (None, bspec, seq_spec, kvh, None)
        specs["sv"] = (None, bspec, seq_spec, kvh, None)
    return specs


# -- placements -----------------------------------------------------------------
def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` on the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  Two mesh dims on one tensor dim (``("pod", "data")``
    on the batch) split it major to minor in mesh order, which DTensor's
    placements do by default; an entry that names them in another order
    raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    owner: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        group = _names(ax)
        if [names.index(a) for a in group] != sorted(names.index(a) for a in group):
            raise ValueError(f"spec entry {ax!r} is not in mesh order {tuple(names)}")
        for a in group:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides: the rules drop those that do not)."""
    axes = mesh_axes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, spec):
        n = int(np.prod([axes[a] for a in _names(ax)])) if ax is not None else 1
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {ax!r} ({n})")
        out.append(dim // n)
    return tuple(out)


def local_bytes(shapes: Mapping[str, Tuple[Sequence[int], torch.dtype]],
                specs: Mapping[str, Spec], mesh) -> int:
    """Bytes one device holds of tensors given as name -> (global shape,
    dtype) under ``specs``."""
    return sum(int(np.prod(local_shape(shape, specs[k], mesh), dtype=np.int64))
               * torch.empty((), dtype=dt).element_size()
               for k, (shape, dt) in shapes.items())


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t`` as a DTensor on ``mesh`` under ``spec``.  Every rank passes the
    same full tensor; each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))


@torch.no_grad()
def shard_params(model: torch.nn.Module, specs: Mapping[str, Spec], mesh
                 ) -> torch.nn.Module:
    """Replace each parameter of ``model`` in place by a DTensor parameter
    on ``mesh`` under its spec in ``specs`` (``param_specs``), keeping its
    ``requires_grad``.  Every rank holds the same full weights before the
    call; after it, each holds its shards."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        dt = distribute(p.detach(), specs[name], mesh)
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def spec_of(t) -> Optional[Spec]:
    """The spec of a DTensor (the inverse of ``placements``), or None for
    a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    names = t.device_mesh.mesh_dim_names
    parts: list = [()] * t.ndim
    for a, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            parts[pl.dim] = parts[pl.dim] + (a,)
    return tuple(None if not p else (p[0] if len(p) == 1 else p) for p in parts)


def shard_cache(cache: Mapping[str, Any], cfg, mesh) -> Dict[str, Any]:
    """``cache`` (``models.init_cache``'s, full on every rank) with each
    tensor a DTensor under ``cache_specs``; ``len`` stays a host int."""
    batch = next(v for k, v in cache.items() if k != "len").shape[1]
    specs = cache_specs(cfg, mesh, batch)
    return {k: v if k == "len" else distribute(v, specs[k], mesh) for k, v in cache.items()}


def local_shard(t: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` in the placements of the
    DTensor ``like`` (each ``Shard`` a ``torch.chunk``, in mesh-dim order,
    as DTensor splits), without communication."""
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return t
