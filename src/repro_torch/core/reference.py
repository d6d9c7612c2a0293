"""Reference executor: direct, eager, no tiling, no staging.

Ported from ``src/repro/core/reference.py``.  The oracle every other
execution strategy is validated against: loops run in program order, and
their reads and writes hit whole padded arrays.  On the CPU those arrays are
the homes themselves (the accessor hands kernels views of them) where every
home gives live tensor views (``ram`` and ``mmap``).  On a CUDA device, and
for ``chunked`` homes (whose tensors are copies), a chain first copies every
dataset it touches up whole, runs there, and copies the datasets it wrote
back home at its end — so the oracle of a CUDA session runs on the card, not
on a hidden host path.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataset import Dataset, torch_dtype
from .loop import AccessMode, Accessor, ParallelLoop


def _whole(dat: Dataset) -> Tuple[slice, ...]:
    return (slice(None),) * dat.ndim


def _live(dats: Iterable[Dataset]) -> bool:
    """Whether every home's tensor form is a live view (``ram``/``mmap``)."""
    return all(d.store.tensor_views for d in dats)


class _TensorAccessor(Accessor):
    def __init__(self, loop: ParallelLoop, arrays: Dict[str, torch.Tensor],
                 device: torch.device):
        self._loop = loop
        self._dats = {a.dat.name: a.dat for a in loop.args}
        self._arrays = arrays
        self.shape = tuple(b - a for a, b in loop.range_)
        self.device = device

    def coords(self):
        lp = self._loop
        nd = lp.block.ndim
        out = []
        for d in range(nd):
            ar = torch.arange(lp.range_[d][0], lp.range_[d][1], dtype=torch.int32,
                              device=self.device)
            shape = [1] * nd
            shape[d] = ar.numel()
            out.append(ar.reshape(shape).expand(self.shape))
        return tuple(out)

    def __call__(self, name: str, offset: Tuple[int, ...] = None):
        lp = self._loop
        nd = lp.block.ndim
        if offset is None:
            offset = (0,) * nd
        dat = self._dats[name]
        idx = tuple(
            slice(lp.range_[d][0] + offset[d] + dat.halo[d][0],
                  lp.range_[d][1] + offset[d] + dat.halo[d][0])
            for d in range(nd)
        )
        return self._arrays[name][idx]


def run_loop_reference(lp: ParallelLoop,
                       arrays: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, np.ndarray]:
    """Execute one loop eagerly over ``arrays`` (whole padded tensors by
    dataset name, all on one device; default: the home tensors, or copies
    written back for homes without live views); returns reduction results
    (if any) as NumPy."""
    if arrays is None:
        dats = {a.dat.name: a.dat for a in lp.args}
        if not _live(dats.values()):
            return run_chain_reference([lp])
        arrays = {n: d.region_tensor(_whole(d)) for n, d in dats.items()}
    device = (next(iter(arrays.values())).device if arrays
              else torch.device("cpu"))
    acc = _TensorAccessor(lp, arrays, device)
    out = lp.kernel(acc)
    writes = {}
    for arg in lp.args:
        if not arg.mode.writes:
            continue
        # Copy: kernels may return views of the very arrays we are about to
        # mutate (e.g. pure copy loops) — overlapping-view assignment corrupts.
        vals = torch.as_tensor(out[arg.dat.name], dtype=torch_dtype(arg.dat.dtype),
                               device=device).clone()
        writes[arg.dat.name] = (arg, vals)
    # Two-phase commit so RW loops read pre-loop values (parallel semantics).
    for name, (arg, vals) in writes.items():
        dat = arg.dat
        idx = tuple(
            slice(lp.range_[d][0] + dat.halo[d][0], lp.range_[d][1] + dat.halo[d][0])
            for d in range(lp.block.ndim)
        )
        view = arrays[name][idx]
        if arg.mode is AccessMode.INC:
            view.add_(vals)
        else:
            view.copy_(vals)
    reds = {}
    for rspec in lp.reductions:
        reds[rspec.name] = np.asarray(torch.as_tensor(out[rspec.name]).cpu())
    return reds


def merge_loop_reductions(
    merged: Dict[str, np.ndarray], lp: ParallelLoop, reds: Dict[str, np.ndarray]
) -> None:
    """Fold one loop's reduction results into ``merged`` via each spec's op."""
    for name, val in reds.items():
        spec = next(r for r in lp.reductions if r.name == name)
        if name in merged:
            merged[name] = np.asarray(spec.combine(merged[name], val))
        else:
            merged[name] = val


def run_chain_reference(loops: Sequence[ParallelLoop],
                        device: torch.device = torch.device("cpu")
                        ) -> Dict[str, np.ndarray]:
    """Execute a chain eagerly in program order on ``device``; merge
    reductions.  Off the CPU (or with a home that has no live tensor views),
    every dataset the chain touches is copied up whole first and every
    dataset it wrote is copied home at the end."""
    merged: Dict[str, np.ndarray] = {}
    dats = {a.dat.name: a.dat for lp in loops for a in lp.args}
    if device.type == "cpu" and _live(dats.values()):
        for lp in loops:
            merge_loop_reductions(merged, lp, run_loop_reference(lp))
        return merged
    arrays = {n: d.region_tensor(_whole(d)).to(device) for n, d in dats.items()}
    written = set()
    for lp in loops:
        merge_loop_reductions(merged, lp, run_loop_reference(
            lp, {a.dat.name: arrays[a.dat.name] for a in lp.args}))
        written.update(a.dat.name for a in lp.args if a.mode.writes)
    for name in written:
        dats[name].write_region(_whole(dats[name]), arrays[name])
    return merged
