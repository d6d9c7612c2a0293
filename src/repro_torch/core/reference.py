"""Reference executor: direct, eager, no tiling, no staging.

Ported from ``src/repro/core/reference.py``.  The oracle every other
execution strategy is validated against: loops run in program order on the
CPU, reads and writes hit the home arrays directly.  The accessor hands
kernels torch CPU tensors that are views of the homes.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .dataset import torch_dtype
from .loop import AccessMode, Accessor, ParallelLoop


class _TensorAccessor(Accessor):
    def __init__(self, loop: ParallelLoop):
        self._loop = loop
        self._dats = {a.dat.name: a.dat for a in loop.args}
        self.shape = tuple(b - a for a, b in loop.range_)

    def coords(self):
        lp = self._loop
        nd = lp.block.ndim
        out = []
        for d in range(nd):
            ar = torch.arange(lp.range_[d][0], lp.range_[d][1], dtype=torch.int32)
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
        return dat.region_tensor(idx)


def run_loop_reference(lp: ParallelLoop) -> Dict[str, np.ndarray]:
    """Execute one loop eagerly; returns reduction results (if any)."""
    acc = _TensorAccessor(lp)
    out = lp.kernel(acc)
    writes = {}
    for arg in lp.args:
        if not arg.mode.writes:
            continue
        # Copy: kernels may return views of the very arrays we are about to
        # mutate (e.g. pure copy loops) — overlapping-view assignment corrupts.
        vals = torch.as_tensor(out[arg.dat.name],
                               dtype=torch_dtype(arg.dat.dtype)).clone()
        writes[arg.dat.name] = (arg, vals)
    # Two-phase commit so RW loops read pre-loop values (parallel semantics).
    for name, (arg, vals) in writes.items():
        dat = arg.dat
        idx = tuple(
            slice(lp.range_[d][0] + dat.halo[d][0], lp.range_[d][1] + dat.halo[d][0])
            for d in range(lp.block.ndim)
        )
        if arg.mode is AccessMode.INC:
            dat.region_tensor(idx).add_(vals)
        else:
            dat.write_region(idx, vals)
    reds = {}
    for rspec in lp.reductions:
        reds[rspec.name] = np.asarray(torch.as_tensor(out[rspec.name]))
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


def run_chain_reference(loops: Sequence[ParallelLoop]) -> Dict[str, np.ndarray]:
    """Execute a chain eagerly in program order; merge reductions."""
    merged: Dict[str, np.ndarray] = {}
    for lp in loops:
        merge_loop_reductions(merged, lp, run_loop_reference(lp))
    return merged
