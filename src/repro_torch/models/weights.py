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
``bfloat16``, are read bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.device import DeviceSpec
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


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                      device: DeviceSpec = "cuda") -> Transformer:
    """The ``Transformer`` on ``device`` holding the weights of ``tree``, the
    reference's parameter tree, each cast to its parameter's dtype (the
    config's, and fp32 for a MoE router and a Mamba-2 mixer's ``dt_bias``,
    ``a_log`` and ``d_skip``).  Raises ``ValueError`` when a leaf is missing,
    extra or of another shape."""
    model = Transformer(cfg, device=device)
    seen = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in _STACKED:
            path = (parts[0],) + tuple(parts[2:])
            stacked = np.asarray(_leaf(tree, path, name))
            layers = len(getattr(model, parts[0]))
            if stacked.shape[:1] != (layers,):
                raise ValueError(f"{name}: tree leaf of shape {stacked.shape}, the "
                                 f"model wants {layers} stacked layers")
            arr = stacked[int(parts[1])]
        else:
            path = tuple(parts)
            arr = _leaf(tree, path, name)
        seen.add(path)
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree leaf of shape {tuple(t.shape)}, "
                             f"the model wants {tuple(p.shape)}")
        p.copy_(t)
    extra = set(_leaf_paths(tree)) - seen
    if extra:
        raise ValueError(f"tree leaves the model does not have: {sorted(extra)}")
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree: Dict[str, Any], name: str, value: Any) -> None:
    """Set ``tree``'s leaf at the dotted ``name``, making the dicts on the way."""
    *path, last = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = value


def _stack(blocks) -> Dict[str, Any]:
    """One nested tree of ``blocks``' parameters, each stacked over the
    layers; a layer's slice of a leaf its block does not hold is zeros."""
    layers = [dict(blk.named_parameters()) for blk in blocks]
    first: Dict[str, torch.Tensor] = {}
    for held in layers:
        for name, p in held.items():
            first.setdefault(name, p)
    tree: Dict[str, Any] = {}
    for name, p in first.items():
        zeros = np.zeros_like(_numpy(p))
        _put(tree, name, np.stack([_numpy(held[name]) if name in held else zeros
                                   for held in layers]))
    return tree


@torch.no_grad()
def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The reference's parameter tree of ``model``'s weights (``blocks`` and
    ``enc_blocks`` stacked along a leading layer axis, every other parameter
    at its nested path); bfloat16 comes back as float32, exactly (numpy has
    no bfloat16).  A layer's slice of a leaf its block does not hold (the
    reference's unused ``moe`` or ``mlp``) is zeros."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        if name.split(".")[0] not in _STACKED:
            _put(tree, name, _numpy(p))
    for key in _STACKED:
        if hasattr(model, key):
            tree[key] = _stack(getattr(model, key))
    return tree
