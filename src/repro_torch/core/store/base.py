"""Backing stores: where a dataset's slow-memory *home copy* actually lives.

Ported from ``src/repro/core/store/base.py`` with ``ram`` as the only kind;
the reference's ``mmap`` and ``chunked`` homes and checkpoints are ROADMAP
item A8.

A :class:`RamStore` home is a host ``torch.Tensor``.  The NumPy API the
planner, the reference oracle and ``fetch`` use reaches it through
``tensor.numpy()``, which shares memory, so both views always agree.  The
data plane copies between the home tensor and device slots without going
through NumPy.  :meth:`RamStore.pin` moves the home into page-locked host
memory, so that host-to-device and device-to-host copies are truly
asynchronous; the out-of-core executor and the kernel backend pin every home
they touch when their device is CUDA.

The store works in *array index* space (padded-array indices); grid-coordinate
translation stays in :class:`~repro_torch.core.dataset.Dataset`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

Index = Tuple[slice, ...]


class StoreError(RuntimeError):
    """A backing-store operation is invalid (wrong shape, unknown kind)."""


class BackingStore:
    """One dataset home copy: an n-d array of ``shape``/``dtype`` somewhere.

    ``read`` may return a view; callers must not rely on mutating the result.
    ``write`` broadcasts ``values`` over the indexed region.  ``prefetch`` and
    ``spill`` are the disk-tier hooks the executor's FetchHome/SpillHome ops
    drive: no-ops for RAM-resident stores.
    """

    kind: str = "?"

    def __init__(self, shape: Tuple[int, ...], dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.stats: Dict[str, int] = {
            "disk_bytes_read": 0, "disk_bytes_written": 0,
            "cache_hits": 0, "cache_misses": 0, "chunk_evictions": 0,
        }

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Logical (uncompressed) size of the stored array."""
        n = self.dtype.itemsize
        for s in self.shape:
            n *= s
        return int(n)

    def read(self, index: Index) -> np.ndarray:
        raise NotImplementedError

    def write(self, index: Index, values) -> None:
        raise NotImplementedError

    def as_array(self) -> np.ndarray:
        raise NotImplementedError

    def materialize(self) -> np.ndarray:
        raise NotImplementedError

    def prefetch(self, index: Index) -> int:
        """Make the indexed region RAM-resident; returns disk bytes read."""
        return 0

    def spill(self, index: Index) -> int:
        """Push the indexed region's dirty state to disk; returns disk bytes
        written."""
        return 0

    def flush(self) -> int:
        """Persist everything dirty; returns disk bytes written."""
        return 0

    def close(self) -> None:
        self.flush()


class RamStore(BackingStore):
    """The home copy is a host tensor, shared with a NumPy view of it.

    Wraps the given array *without copying* (``torch.from_numpy``) so code
    holding the array keeps seeing every update — until :meth:`pin` moves
    the home into page-locked memory, which is a copy: after it, use
    ``Dataset.data`` (the new view), not the array passed in."""

    kind = "ram"

    def __init__(self, array: Union[np.ndarray, torch.Tensor]):
        if isinstance(array, torch.Tensor):
            tensor = array
        else:
            tensor = torch.from_numpy(np.asarray(array))
        if tensor.device.type != "cpu":
            raise StoreError("a RamStore home lives in host memory")
        self._tensor = tensor
        self._arr = tensor.numpy()
        super().__init__(self._arr.shape, self._arr.dtype)

    def read(self, index: Index) -> np.ndarray:
        return self._arr[index]

    def write(self, index: Index, values) -> None:
        if isinstance(values, torch.Tensor):
            self._tensor[index].copy_(values)
        else:
            self._arr[index] = values

    def as_array(self) -> np.ndarray:
        return self._arr

    def materialize(self) -> np.ndarray:
        return self._arr

    def tensor(self, index: Optional[Index] = None) -> torch.Tensor:
        """The home tensor (or a view of ``index``), for tensor-to-tensor
        copies that skip NumPy."""
        return self._tensor if index is None else self._tensor[index]

    def pin(self) -> None:
        """Move the home into page-locked host memory (a copy; idempotent)."""
        if not self._tensor.is_pinned():
            self._tensor = self._tensor.pin_memory()
            self._arr = self._tensor.numpy()


# -- construction ---------------------------------------------------------------

StoreSpec = Union[None, str, BackingStore]


def make_store(spec: StoreSpec, *, name: str, shape: Tuple[int, ...], dtype,
               data: Optional[np.ndarray] = None) -> BackingStore:
    """Materialise a backing store from a spec: ``None``/``"ram"``, or a ready
    :class:`BackingStore` (shape/dtype checked).  ``data``, when given,
    becomes the initial contents (adopted without a copy by ``ram``)."""
    if isinstance(spec, BackingStore):
        if spec.shape != tuple(shape) or spec.dtype != np.dtype(dtype):
            raise StoreError(
                f"store for {name!r} has shape {spec.shape}/{spec.dtype}, "
                f"dataset needs {tuple(shape)}/{np.dtype(dtype)}")
        if data is not None:
            spec.write(tuple(slice(None) for _ in shape), data)
        return spec
    if spec not in (None, "ram"):
        raise StoreError(
            f"unknown store kind {spec!r}; the port has only 'ram' (mmap and "
            f"chunked homes are ROADMAP A8)")
    return RamStore(data if data is not None else np.zeros(shape, dtype=dtype))
