"""Weights carried between the JAX package's parameter tree and the port's
``Transformer``.

The reference's ``init_params`` returns nested dicts whose ``blocks`` (and
encdec's ``enc_blocks``) leaves are stacked along a leading layer axis; the
port keeps one block per layer with the same per-layer layouts, so a leaf's
slice ``[li]`` is the layer's tensor as it is, with no transpose.  Every
other parameter (``embed``, the hybrid's ``shared_block``, ...) sits at its
nested path.  A moe layer of the port holds only the FFN it runs, where the
reference's tree gives every layer both ``moe`` and ``mlp`` when the config
has dense layers: the unused slices are accepted and not loaded, and
``params_to_numpy`` writes them as zeros.  Leaves are numpy arrays (the
tests pass ``np.asarray`` of JAX arrays; bfloat16 leaves, ``ml_dtypes``'
``bfloat16``, are read bit for bit) or torch tensors.

The optimizer's state crosses in the same layout: ``tensor_tree(model,
values=mu)`` and ``load_tree(model, tree, values=mu)`` carry a tensor per
parameter name (AdamW's ``mu``/``nu``) to and from the reference's stacked
tree, as ``train/checkpoint.py`` writes it.

DTensor parameters (a mesh's) come out of ``tensor_tree`` whole
(``full_tensor``: every rank must call it) and go into ``load_tree`` as
each rank's shard of the full leaf, so a tree saved on one mesh loads onto
any other, or onto none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceSpec
from ..distributed.sharding import local_shard
from .config import ModelConfig
from .transformer import Transformer

# The parameter lists whose leaves the reference stacks along a layer axis.
_STACKED = ("blocks", "enc_blocks")


def _tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:           # JAX's arrays; torch wants writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(tree: Dict[str, Any], path, name: str) -> Any:
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise ValueError(f"{name}: the tree has no leaf {'/'.join(path)}")
        tree = tree[key]
    return tree


def _leaf_paths(tree: Dict[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _slices(model: Transformer):
    """(name, parameter, tree path, layer) of every parameter: ``layer`` is
    its index in a stacked list (``blocks``, ``enc_blocks``), else None."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in _STACKED:
            yield name, p, (parts[0],) + tuple(parts[2:]), int(parts[1])
        else:
            yield name, p, tuple(parts), None


@torch.no_grad()
def load_tree(model: Transformer, tree: Dict[str, Any],
              values: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Copy the reference-layout ``tree`` (numpy or torch leaves; ``blocks``
    and ``enc_blocks`` stacked over the layers) into ``model``'s parameters,
    or, given ``values`` (parameter name -> tensor, such as the optimizer's
    ``mu``), into those tensors; each is cast to its target's dtype.  The
    slice of a leaf that a layer does not hold (a moe layer's unused ``mlp``
    or ``moe``) is skipped.  Raises ``ValueError`` when a leaf is missing,
    extra or of another shape."""
    seen = set()
    for name, p, path, layer in _slices(model):
        if layer is not None:
            stacked = _leaf(tree, path, name)
            if not isinstance(stacked, torch.Tensor):
                stacked = np.asarray(stacked)
            layers = len(getattr(model, path[0]))
            if tuple(stacked.shape[:1]) != (layers,):
                raise ValueError(f"{name}: tree leaf of shape {tuple(stacked.shape)}, "
                                 f"the model wants {layers} stacked layers")
            arr = stacked[layer]
        else:
            arr = _leaf(tree, path, name)
        seen.add(path)
        t = arr if isinstance(arr, torch.Tensor) else _tensor(arr)
        target = p if values is None else values[name]
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(f"{name}: tree leaf of shape {tuple(t.shape)}, "
                             f"the model wants {tuple(target.shape)}")
        if hasattr(target, "placements"):           # a DTensor: this rank's shard
            target.to_local().copy_(local_shard(t.to(target.device), target))
        else:
            target.copy_(t)
    extra = set(_leaf_paths(tree)) - seen
    if extra:
        raise ValueError(f"tree leaves the model does not have: {sorted(extra)}")


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                      device: DeviceSpec = "cuda") -> Transformer:
    """The ``Transformer`` on ``device`` holding the weights of ``tree``, the
    reference's parameter tree, each cast to its parameter's dtype (the
    config's, and fp32 for a MoE router and a Mamba-2 mixer's ``dt_bias``,
    ``a_log`` and ``d_skip``).  Raises ``ValueError`` when a leaf is missing,
    extra or of another shape."""
    model = Transformer(cfg, device=device)
    load_tree(model, tree)
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree: Dict[str, Any], path, value: Any) -> None:
    """Set ``tree``'s leaf at ``path``, making the dicts on the way."""
    *path, last = path
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = value


@torch.no_grad()
def tensor_tree(model: Transformer,
                values: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The reference-layout tree of ``model``'s parameters, or of ``values``
    (parameter name -> tensor, such as the optimizer's ``mu``): host copies
    in their own dtypes, ``blocks`` and ``enc_blocks`` stacked along a
    leading layer axis, every other tensor at its nested path.  A layer's
    slice of a leaf its block does not hold (the reference's unused ``moe``
    or ``mlp``) is zeros."""
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, p, path, layer in _slices(model):
        t = (p if values is None else values[name]).detach()
        if hasattr(t, "full_tensor"):               # a DTensor: gathered whole
            t = t.full_tensor()
        t = t.to("cpu", copy=True)
        if layer is None:
            _put(tree, path, t)
        else:
            stacked.setdefault(path, {})[layer] = t
    for path, held in stacked.items():
        zeros = torch.zeros_like(next(iter(held.values())))
        layers = len(getattr(model, path[0]))
        _put(tree, path, torch.stack([held.get(li, zeros) for li in range(layers)]))
    return tree


def _map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The reference's parameter tree of ``model``'s weights
    (``tensor_tree`` as numpy); bfloat16 comes back as float32, exactly
    (numpy has no bfloat16).  A layer's slice of a leaf its block does not
    hold (the reference's unused ``moe`` or ``mlp``) is zeros."""
    return _map(tensor_tree(model), _numpy)
