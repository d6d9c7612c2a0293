"""Checkpointing: save/restore with atomic commits, async writing and
retention, in the reference's format.

Ported from ``src/repro/train/checkpoint.py``.  Format: one directory per
step, ``step_XXXXXXXX/``, holding ``arrays.npz`` (leaves keyed by their tree
path joined with ``::``, e.g. ``params::blocks::attn::wq`` or
``opt::mu::embed``) and ``manifest.json`` (step, each leaf's shape and
dtype).  Writes go to ``.tmp_step_N`` and ``os.replace`` in, so a killed
process never leaves a half-valid checkpoint.  Trees are nested dicts whose
leaves are torch tensors (any device), numpy arrays or Python scalars; the
launcher builds them in the reference's stacked layout
(``models/weights.py::tensor_tree``), so either package restores the
other's checkpoints.  A DTensor leaf is saved whole (``full_tensor``, a
collective every rank of its mesh joins), so a run saved on one mesh
restores onto another: the reference's "restore to any mesh".

One difference on purpose (ROADMAP fault C6): the reference writes a
bfloat16 leaf as ``np.asarray`` of it, which ``np.savez`` stores as raw
``|V2`` bytes, and its own ``restore_checkpoint`` then fails to cast them
back (``ValueError: No cast function available``).  Here a bfloat16 leaf is
written as its exact float32 widening, with ``bfloat16`` in the manifest, so
the reference's restore reads it (``float32.astype(bfloat16)`` is exact);
and a ``|V2`` leaf that the reference wrote is read back as its uint16 bits
viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "::"


def _leaves(tree: Dict[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy (bfloat16 widened to float32) and
    the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):               # a DTensor: gathered whole
            t = t.full_tensor()
        t = t.to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any], *, keep: int = 3,
                    async_write: bool = False) -> Optional[threading.Thread]:
    """Atomically write ``step``'s checkpoint of ``tree``; prune to the
    ``keep`` newest.  The leaves are copied to the host before this returns,
    so with ``async_write`` (a writer thread, returned for the caller to
    join) the caller may go on updating them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, dtypes = {}, {}
    for path, leaf in _leaves(tree):
        key = _SEP.join(path)
        flat[key], dtypes[key] = _host(leaf)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _prune(ckpt_dir, keep)

    if async_write:
        t = threading.Thread(target=_write, daemon=False)
        t.start()
        return t
    _write()
    return None


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = list_checkpoints(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{8})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _restored(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor in the dtype the manifest names."""
    if dtype_name == "bfloat16":
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # raw bits (JAX)
            return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()
                                    ).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(ckpt_dir: str, step: int, like_tree: Dict[str, Any]
                       ) -> Tuple[int, Dict[str, Any]]:
    """Restore into the structure of ``like_tree`` (nested dicts of torch
    tensors or numpy arrays): the same tree with each leaf a CPU tensor (a
    numpy array where ``like_tree``'s is one) in that leaf's dtype.  Raises
    ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for one of
    another shape."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for keys, leaf in _leaves(like_tree):
            key = _SEP.join(keys)
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _restored(arrays[key], manifest["leaves"][key]["dtype"])
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(t.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != model {want}")
            if isinstance(leaf, torch.Tensor):
                value = t.to(leaf.dtype)
            else:
                value = (t.float() if t.dtype == torch.bfloat16 else t).numpy().astype(
                    np.asarray(leaf).dtype)
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
    return manifest["step"], out
