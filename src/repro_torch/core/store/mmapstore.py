"""``mmap`` backing store: the home copy is an ``np.memmap`` over a file.

The OS page cache becomes the host tier: rows the executor stages are read
and written *in place* in the mapped file, cold pages fault in from disk,
and dirty pages drain back under kernel control (``flush`` forces it).
Datasets survive the process — :meth:`MmapStore.open` (or
``StoreConfig(kind="mmap", mode="r+")``) reattaches to an existing file,
which is what makes mmap homes restartable without a checkpoint.

Copied from ``src/repro/core/store/mmapstore.py`` with its imports rewired to
``repro_torch``.  The port adds :meth:`MmapStore.tensor`, a ``torch`` view of
the mapped rows (pageable memory: the data plane stages it through a pinned
buffer on its way to a CUDA slot), and ``write`` of a tensor on any device.

``stats`` counts the bytes moved through the read/write API as disk traffic;
the page cache makes true device I/O unobservable from user space, so these
are upper bounds (a hot page costs no real I/O).
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .base import BackingStore, Index, StoreConfig, StoreError, register_store


class MmapStore(BackingStore):
    kind = "mmap"
    tensor_views = True

    def __init__(self, path: str, shape: Tuple[int, ...], dtype,
                 mode: str = "w+"):
        super().__init__(shape, dtype)
        if mode not in ("w+", "r+"):
            raise StoreError(f"mmap store mode must be 'w+' or 'r+', got {mode!r}")
        self.path = path
        if mode == "r+":
            if not os.path.exists(path):
                raise StoreError(f"mmap reopen: {path!r} does not exist")
            actual = os.path.getsize(path)
            if actual != self.nbytes:
                raise StoreError(
                    f"mmap reopen: {path!r} is {actual}B, expected "
                    f"{self.nbytes}B for shape {self.shape} {self.dtype}")
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        # "w+" creates (zero-filled, sparse where the FS supports it).
        self._mm = np.memmap(path, dtype=self.dtype, mode=mode,
                             shape=self.shape)
        # The upload and download workers hit one store concurrently; the
        # memmap regions they touch are disjoint, but the stats counters are
        # shared read-modify-writes and would drop increments unlocked.
        self._stats_lock = threading.Lock()

    @classmethod
    def open(cls, path: str, shape: Tuple[int, ...], dtype) -> "MmapStore":
        """Reattach to an existing spill file (persistence across runs)."""
        return cls(path, shape, dtype, mode="r+")

    def read(self, index: Index) -> np.ndarray:
        region = self._mm[index]
        with self._stats_lock:
            self.stats["disk_bytes_read"] += int(region.nbytes)
        return region

    def tensor(self, index: Optional[Index] = None) -> torch.Tensor:
        """A live tensor view of the mapped region (counted as a read)."""
        return torch.from_numpy(self.read(
            self._full_index() if index is None else index))

    def write(self, index: Index, values) -> None:
        region = self._mm[index]
        if isinstance(values, torch.Tensor):
            torch.from_numpy(region).copy_(values)
        else:
            region[...] = values
        with self._stats_lock:
            self.stats["disk_bytes_written"] += int(region.nbytes)

    def as_array(self) -> np.ndarray:
        return self._mm

    def materialize(self) -> np.ndarray:
        return self._mm

    def flush(self) -> int:
        self._mm.flush()
        return 0

    def close(self) -> None:
        self.flush()


@register_store("mmap")
def _mmap(config: StoreConfig, name: str, shape, dtype,
          data=None) -> MmapStore:
    directory = config.resolved_directory("mmap")
    store = MmapStore(os.path.join(directory, f"{name}.mmap"), shape, dtype,
                      mode=config.mode)
    if data is not None:
        store.write(tuple(slice(None) for _ in shape), data)
    return store
