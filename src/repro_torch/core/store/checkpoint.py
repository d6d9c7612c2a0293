"""Checkpoint files: atomic save/restore of dataset home copies.

One checkpoint is a single ``.npz`` holding every dataset's *materialised*
padded array plus a JSON manifest (versions, dtypes, shapes, the session's
chain counter and the plan-cache signature hashes for provenance).  The file
is written to a temp path and ``os.replace``d into place, so a crash mid-save
leaves either the old checkpoint or the new one — never a torn file.  This is
what lets a multi-hour out-of-core run be killed and resumed bit-identically
(:meth:`Session.checkpoint` / :meth:`Session.restore` are thin wrappers).

RAM note: the npz format holds one dataset's *uncompressed* padded array in
memory while writing (chunked stores fill a preallocated buffer chunk by
chunk, so the peak is one array + the chunk-cache budget, not the whole
working set).  Checkpoint when the largest single dataset fits host RAM;
a per-chunk streaming format is the escape hatch if that ever stops holding.

Copied from ``src/repro/core/store/checkpoint.py`` (the same format, so a
checkpoint written by either package loads in the other).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

import numpy as np

CHECKPOINT_FORMAT = 1


def save_checkpoint(path: str, datasets: Iterable, *,
                    chains_flushed: int = 0,
                    plan_signatures: Iterable[str] = ()) -> Dict:
    """Write ``datasets`` (any iterable of :class:`Dataset`) to ``path``
    atomically; returns the manifest that was embedded."""
    datasets = list(datasets)
    if not datasets:
        raise ValueError("nothing to checkpoint: no datasets given")
    names = [d.name for d in datasets]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate dataset names in checkpoint: {names}")
    manifest: Dict = {
        "format": CHECKPOINT_FORMAT,
        "chains_flushed": int(chains_flushed),
        "plan_signatures": sorted(set(plan_signatures)),
        "datasets": {},
    }
    arrays: Dict[str, np.ndarray] = {}
    for d in datasets:
        arrays[f"dat::{d.name}"] = np.asarray(d.materialize())
        manifest["datasets"][d.name] = {
            "version": int(d.version),
            "dtype": d.dtype.str,
            "shape": list(d.padded_shape),
        }
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def load_checkpoint(path: str, datasets: Iterable) -> Dict:
    """Restore a checkpoint into ``datasets`` (matched by name; shapes and
    dtypes validated).  Every dataset recorded in the checkpoint must be
    present; extra live datasets are left untouched.  Returns the manifest."""
    by_name = {d.name: d for d in datasets}
    with np.load(path) as z:
        manifest = json.loads(bytes(np.asarray(z["manifest"]).tobytes()))
        if manifest.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(
                f"unsupported checkpoint format {manifest.get('format')!r} "
                f"(expected {CHECKPOINT_FORMAT})")
        missing: List[str] = [
            n for n in manifest["datasets"] if n not in by_name]
        if missing:
            raise KeyError(
                f"checkpoint has dataset(s) {missing} not present here; "
                f"pass matching datasets= to restore()")
        for name, meta in manifest["datasets"].items():
            d = by_name[name]
            arr = z[f"dat::{name}"]
            if tuple(arr.shape) != tuple(d.padded_shape) or \
                    np.dtype(meta["dtype"]) != d.dtype:
                raise ValueError(
                    f"checkpoint dataset {name!r} is {arr.shape} "
                    f"{meta['dtype']}, live dataset is {d.padded_shape} "
                    f"{d.dtype.str}")
            d.write_region(tuple(slice(None) for _ in range(d.ndim)), arr)
            d.version = int(meta["version"])
    return manifest
