"""Backing stores: where a dataset's slow-memory *home copy* actually lives.

Ported from ``src/repro/core/store/base.py``.  A home copy is an object
behind one interface, so the hierarchy does not stop at host RAM:

==============  ===============================================================
``ram``         a host ``torch.Tensor`` with a shared NumPy view (default);
                pinned when a CUDA session stages it
``mmap``        ``np.memmap`` over a file in a spill directory; tile rows are
                read/written in place, the OS page cache is the host tier
``chunked``     fixed-size row chunks compressed with the codec registry on
                disk, an LRU *decompressed-chunk* cache with a byte budget in
                RAM, per-chunk dirty tracking
==============  ===============================================================

The NumPy API (``read``/``write``/``materialize``) is the reference's and
serves the planner, the reference oracle and ``fetch``.  The port adds
:meth:`BackingStore.tensor`, the form the data plane copies from:
``ram`` and ``mmap`` homes give a live view (``tensor_views``), ``chunked``
homes a fresh tensor of the rows read through the chunk cache.  ``write``
also takes a tensor on any device.  Only a :class:`RamStore` is ever pinned
(:meth:`RamStore.pin`): pinning copies the whole home into page-locked RAM,
which would defeat a disk tier, so the data plane stages disk-backed rows
through pinned buffers instead.

The store works in *array index* space (padded-array indices); grid-coordinate
translation stays in :class:`~repro_torch.core.dataset.Dataset`.  All stores
are thread-safe where it matters: the transfer engine's upload, download and
disk workers may touch one store concurrently.

``stats`` counts disk traffic (``disk_bytes_read`` / ``disk_bytes_written``
are the payload bytes that crossed the disk boundary — for ``mmap``, the
bytes moved through the API, since the page cache makes true device I/O
unobservable) plus chunk-cache behaviour for ``chunked``.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

Index = Tuple[slice, ...]


class StoreError(RuntimeError):
    """A backing-store operation is invalid (wrong shape, closed store, or an
    operation the store kind cannot support, like ``.data`` on ``chunked``)."""


def host_values(values):
    """``values`` as something NumPy can assign from: a tensor on any device
    comes to the host (a view when it already is a CPU tensor)."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return values


class BackingStore:
    """One dataset home copy: an n-d array of ``shape``/``dtype`` somewhere.

    ``read`` may return a view (``ram``/``mmap``) or a fresh array
    (``chunked``); callers must not rely on mutating the result.  ``write``
    broadcasts ``values`` over the indexed region.  ``prefetch``/``spill``
    are the disk-tier hooks the executor's FetchHome/SpillHome ops drive:
    no-ops for RAM-resident stores, real traffic for ``chunked``.
    """

    kind: str = "?"
    # Whether :meth:`tensor` returns a live view that in-place writes reach.
    tensor_views: bool = False

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

    def _full_index(self) -> Index:
        return tuple(slice(0, s) for s in self.shape)

    # -- data access ----------------------------------------------------------
    def read(self, index: Index) -> np.ndarray:
        raise NotImplementedError

    def write(self, index: Index, values) -> None:
        raise NotImplementedError

    def tensor(self, index: Optional[Index] = None) -> torch.Tensor:
        """The indexed region (default: all of it) as a host tensor: a live
        view where ``tensor_views`` holds, else a fresh copy."""
        idx = self._full_index() if index is None else index
        return torch.from_numpy(np.array(self.read(idx), copy=True))

    def as_array(self) -> np.ndarray:
        """The live backing array, for stores that have one (``ram``/``mmap``).

        Raises :class:`StoreError` otherwise — code that must work with every
        store kind uses ``read``/``write``/``materialize`` instead."""
        raise StoreError(
            f"{self.kind!r} store has no single in-RAM backing array; "
            f"use read()/write()/materialize()")

    def materialize(self) -> np.ndarray:
        """The whole array (a view for RAM-resident stores, assembled fresh
        for ``chunked``) — what checkpointing and ``fetch_raw`` consume."""
        return np.asarray(self.read(self._full_index()))

    # -- disk-tier hooks ------------------------------------------------------
    def prefetch(self, index: Index) -> int:
        """Make the indexed region RAM-resident; returns disk bytes read."""
        return 0

    def spill(self, index: Index) -> int:
        """Push the indexed region's dirty state to disk (and release RAM
        where the store can); returns disk bytes written."""
        return 0

    def flush(self) -> int:
        """Persist everything dirty; returns disk bytes written."""
        return 0

    def close(self) -> None:
        """Flush and release resources; the store is unusable afterwards."""
        self.flush()


class RamStore(BackingStore):
    """The home copy is a host tensor, shared with a NumPy view of it.

    Wraps the given array *without copying* (``torch.from_numpy``) so code
    holding the array keeps seeing every update — until :meth:`pin` moves
    the home into page-locked memory, which is a copy: after it, use
    ``Dataset.data`` (the new view), not the array passed in."""

    kind = "ram"
    tensor_views = True

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


# -- configuration + registry -----------------------------------------------------


@dataclass(frozen=True)
class StoreConfig:
    """Declarative store selection for :func:`make_store` /
    ``make_dataset(store=...)``.

    ``directory`` is the spill directory for disk-backed kinds; when ``None``
    a fresh ``tempfile.mkdtemp`` directory is created per dataset (temp
    spill dirs are *not* auto-deleted so ``mmap`` homes survive reopen).
    ``codec`` names a codec from the :mod:`repro_torch.core.transfer.codecs`
    registry; the ``chunked`` default is the lossless ``shuffle-rle`` (lossy
    codecs silently degrade the *home copy*, not just the wire — opt in
    knowingly).  ``mode`` is ``"w+"`` (create) or ``"r+"`` (reopen existing
    ``mmap`` files in place).
    """

    kind: str = "ram"
    directory: Optional[str] = None
    chunk_bytes: int = 1 << 20          # chunked: target compressed-unit size
    cache_bytes: int = 64 << 20         # chunked: decompressed-cache budget
    codec: str = "shuffle-rle"          # chunked: at-rest compression
    mode: str = "w+"                    # mmap: "w+" create | "r+" reopen

    def resolved_directory(self, prefix: str) -> str:
        if self.directory is not None:
            os.makedirs(self.directory, exist_ok=True)
            return self.directory
        return tempfile.mkdtemp(prefix=f"repro-{prefix}-")


StoreSpec = Union[None, str, StoreConfig, BackingStore]

_STORES: Dict[str, Callable] = {}


def register_store(kind: str):
    """Decorator registering ``factory(config, name, shape, dtype,
    data=None) -> store`` under ``kind`` (mirrors the backend/codec
    registries).  ``data`` is the initial contents; a factory may adopt the
    array in place (``ram`` does, preserving aliasing) or copy it in."""
    def deco(factory):
        _STORES[kind] = factory
        return factory
    return deco


def available_stores() -> Tuple[str, ...]:
    return tuple(sorted(_STORES))


@register_store("ram")
def _ram(config: StoreConfig, name: str, shape, dtype, data=None) -> RamStore:
    # Wrap user data without copying: Dataset(data=arr) keeps aliasing arr.
    return RamStore(data if data is not None
                    else np.zeros(shape, dtype=dtype))


def make_store(spec: StoreSpec, *, name: str, shape: Tuple[int, ...], dtype,
               data: Optional[np.ndarray] = None) -> BackingStore:
    """Materialise a backing store from a spec.

    ``spec`` is ``None``/``"ram"`` (default), a kind name, a
    :class:`StoreConfig`, or a ready :class:`BackingStore` (shape/dtype
    checked).  ``data``, when given, becomes the initial contents.
    """
    if isinstance(spec, BackingStore):
        if spec.shape != tuple(shape) or spec.dtype != np.dtype(dtype):
            raise StoreError(
                f"store for {name!r} has shape {spec.shape}/{spec.dtype}, "
                f"dataset needs {tuple(shape)}/{np.dtype(dtype)}")
        if data is not None:
            spec.write(tuple(slice(None) for _ in shape), data)
        return spec
    if spec is None:
        spec = StoreConfig()
    elif isinstance(spec, str):
        spec = StoreConfig(kind=spec)
    factory = _STORES.get(spec.kind)
    if factory is None:
        raise StoreError(
            f"unknown store kind {spec.kind!r}; "
            f"available: {', '.join(available_stores())}")
    return factory(spec, name, tuple(shape), np.dtype(dtype), data=data)
