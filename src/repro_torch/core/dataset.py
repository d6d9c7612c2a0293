"""Datasets — grid-resident arrays owned by the runtime (``ops_dat``).

Ported from ``src/repro/core/dataset.py``.  A dataset lives in *slow memory*
as its home location; the out-of-core executor stages footprints of it into
*fast memory* (device slots) per tile.  The home is a pluggable
:class:`~repro_torch.core.store.BackingStore`: a host tensor with a shared
NumPy view (``ram``, the default), an ``np.memmap`` over a spill directory
(``mmap``), or codec-compressed chunks on disk behind an LRU cache
(``chunked``).  The NumPy forms (``read``/``write``/``read_rows``/
``write_rows``) serve the planner, the reference oracle and ``fetch``; the
tensor forms (``rows_tensor``/``region_tensor``/``box_tensor``, and
``write``/``write_rows`` given a tensor) let the data plane copy between a
home and CUDA slots without going through NumPy.  The tensor forms are live
views of ``ram`` and ``mmap`` homes (``store.tensor_views``) and fresh
copies of rows read through the cache of ``chunked`` ones.

:func:`datasets_from_numpy` and :meth:`Dataset.to_numpy` carry state across
from and back to the JAX package's padded home arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .block import Block
from .store import BackingStore, RamStore, StoreConfig, make_store

Halo = Union[int, Tuple[Tuple[int, int], ...]]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (float32 -> torch.float32, ...)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class Dataset:
    """An array defined over a block, with per-dimension halo padding.

    The backing store spans ``[-halo[d][0], size[d] + halo[d][1])`` per dim.
    Index convention throughout the runtime: *grid coordinates* (interior
    starts at 0); array index = grid index + halo_lo.

    ``version`` is bumped on every user-space ``write``; device-side caches
    (pinned arrays, speculative-prefetch captures) key on it to notice a
    changed home copy.
    """

    def __init__(self, block: Block, name: str, dtype,
                 halo: Tuple[Tuple[int, int], ...],
                 data: Optional[np.ndarray] = None, version: int = 0,
                 store: Union[None, str, StoreConfig, BackingStore] = None):
        self.block = block
        self.name = name
        self.dtype = np.dtype(dtype)
        self.halo = tuple(tuple(int(x) for x in h) for h in halo)
        self.version = version
        if len(self.halo) != block.ndim:
            raise ValueError(f"dat {self.name!r}: halo arity mismatch")
        shape = self.padded_shape
        if data is not None:
            if isinstance(store, BackingStore):
                raise ValueError(
                    f"dat {self.name!r}: pass data= or a ready store, not both")
            data = np.asarray(data, dtype=self.dtype)
            if data.shape != shape:
                raise ValueError(
                    f"dat {self.name!r}: data shape {data.shape} != padded {shape}"
                )
        self._store = make_store(store, name=name, shape=shape,
                                 dtype=self.dtype, data=data)

    @classmethod
    def from_store(cls, block: Block, name: str, store: BackingStore,
                   halo: Halo = 1, dtype=None) -> "Dataset":
        """Wrap an existing backing store (e.g. a reopened ``MmapStore``) as
        a dataset; shape/dtype are validated against block + halo."""
        return cls(block=block, name=name,
                   dtype=store.dtype if dtype is None else dtype,
                   halo=_halo_pairs(halo, block.ndim), store=store)

    def __repr__(self) -> str:
        return (f"Dataset(name={self.name!r}, block={self.block.name!r}, "
                f"dtype={self.dtype.str}, halo={self.halo}, "
                f"store={self._store.kind!r}, version={self.version})")

    # -- the backing store ---------------------------------------------------
    @property
    def store(self) -> BackingStore:
        return self._store

    @property
    def data(self) -> np.ndarray:
        """The live home array (``ram``/``mmap``); raises for ``chunked``."""
        return self._store.as_array()

    def materialize(self) -> np.ndarray:
        """The whole padded array — a live view for RAM-resident stores, a
        fresh assembly for ``chunked`` (checkpointing / ``fetch_raw``)."""
        return self._store.materialize()

    def to_numpy(self) -> np.ndarray:
        """A copy of the whole padded array — the way back to the JAX
        package (its ``Dataset.materialize()`` layout)."""
        return np.array(self._store.materialize(), copy=True)

    def pin(self) -> None:
        """Move a ``ram`` home into page-locked host memory (CUDA sessions do
        this for every RAM home they stage; idempotent).  A disk-backed home
        is never pinned: that would copy all of it into RAM and defeat the
        tier; the data plane stages its rows through pinned buffers."""
        if isinstance(self._store, RamStore):
            self._store.pin()

    def flush_store(self) -> int:
        """Persist dirty home state to disk; returns disk bytes written."""
        return self._store.flush()

    def store_stats(self) -> dict:
        return dict(self._store.stats)

    def close(self) -> None:
        self._store.close()

    # -- geometry -----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.block.ndim

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(
            self.block.size[d] + self.halo[d][0] + self.halo[d][1]
            for d in range(self.block.ndim)
        )

    def bounds(self, dim: int) -> Tuple[int, int]:
        """Grid-coordinate extent of the backing array along ``dim``."""
        return -self.halo[dim][0], self.block.size[dim] + self.halo[dim][1]

    @property
    def nbytes(self) -> int:
        """Logical home-copy size; what capacity planning counts."""
        return self._store.nbytes

    # -- host-side access (grid coordinates) --------------------------------
    def _to_index(self, grid_box: Tuple[Tuple[int, int], ...]) -> Tuple[slice, ...]:
        return tuple(slice(a + self.halo[d][0], b + self.halo[d][0])
                     for d, (a, b) in enumerate(grid_box))

    def _rows_index(self, dim: int, lo: int, hi: int) -> Tuple[slice, ...]:
        idx = [slice(None)] * self.ndim
        idx[dim] = slice(lo + self.halo[dim][0], hi + self.halo[dim][0])
        return tuple(idx)

    def read(self, grid_box: Tuple[Tuple[int, int], ...]) -> np.ndarray:
        """Read a grid-coordinate box from the slow-memory home copy."""
        return self._store.read(self._to_index(tuple(grid_box)))

    def write(self, grid_box: Tuple[Tuple[int, int], ...], values) -> None:
        """User-space write of a NumPy array or a tensor (any device): bumps
        ``version`` so device-side caches notice.  An empty box is a no-op
        and does NOT bump the version."""
        grid_box = tuple(grid_box)
        if any(b <= a for a, b in grid_box):
            return
        self._store.write(self._to_index(grid_box), values)
        self.version += 1

    def box_tensor(self, grid_box: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
        """A grid-coordinate box of the home copy as a tensor (a view where
        ``store.tensor_views``, else a copy)."""
        return self._store.tensor(self._to_index(tuple(grid_box)))

    # -- runtime-internal access (no version bump) ---------------------------
    def read_region(self, index: Tuple[slice, ...]) -> np.ndarray:
        """Array-index-space read (a view)."""
        return self._store.read(tuple(index))

    def region_tensor(self, index: Tuple[slice, ...]) -> torch.Tensor:
        """Array-index-space region of the home copy as a tensor (a view
        where ``store.tensor_views``, else a copy)."""
        return self._store.tensor(tuple(index))

    def write_region(self, index: Tuple[slice, ...], values) -> None:
        """Array-index-space write.  Runtime-internal: executor downloads
        land home without a version bump (the device copy was the truth)."""
        self._store.write(tuple(index), values)

    def read_rows(self, dim: int, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` (grid coords) along ``dim``, full other dims —
        the staging-slab shape the out-of-core executor moves."""
        return self._store.read(self._rows_index(dim, lo, hi))

    def rows_tensor(self, dim: int, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` as a tensor — the staging slab as a view of a
        ``ram`` or ``mmap`` home, a copy of a ``chunked`` one's rows."""
        return self._store.tensor(self._rows_index(dim, lo, hi))

    def write_rows(self, dim: int, lo: int, hi: int, values) -> None:
        self._store.write(self._rows_index(dim, lo, hi), values)

    def prefetch_rows(self, dim: int, lo: int, hi: int) -> int:
        """Disk→host fetch of rows ``[lo, hi)`` (0 for RAM homes)."""
        return self._store.prefetch(self._rows_index(dim, lo, hi))

    def spill_rows(self, dim: int, lo: int, hi: int) -> int:
        """Host→disk retirement of rows ``[lo, hi)`` (0 for RAM homes)."""
        return self._store.spill(self._rows_index(dim, lo, hi))

    def interior(self) -> np.ndarray:
        """Interior view (no halos) — the usual thing users fetch."""
        return self.read(self.block.full_range())


def _halo_pairs(halo: Halo, ndim: int) -> Tuple[Tuple[int, int], ...]:
    if isinstance(halo, int):
        return tuple((halo, halo) for _ in range(ndim))
    return tuple(tuple(h) for h in halo)


def make_dataset(
    block: Block,
    name: str,
    halo: Halo = 1,
    dtype=np.float32,
    init: Optional[np.ndarray] = None,
    store: Union[None, str, StoreConfig, BackingStore] = None,
) -> Dataset:
    """Convenience constructor; scalar halo means the same pad on every face.
    ``init`` is either the padded array or the interior.

    ``store`` selects the home tier: ``None``/``"ram"`` (default), ``"mmap"``,
    ``"chunked"``, a :class:`~repro_torch.core.store.StoreConfig`, or a ready
    :class:`~repro_torch.core.store.BackingStore`."""
    dat = Dataset(block=block, name=name, dtype=np.dtype(dtype),
                  halo=_halo_pairs(halo, block.ndim), store=store)
    if init is not None:
        init = np.asarray(init, dtype=dat.dtype)
        if init.shape == dat.padded_shape:
            dat.write_region(tuple(slice(None) for _ in range(dat.ndim)), init)
        elif init.shape == block.size:
            dat.write(block.full_range(), init)
        else:
            raise ValueError(
                f"init shape {init.shape} matches neither padded {dat.padded_shape} "
                f"nor interior {block.size}"
            )
    return dat


def datasets_from_numpy(
    block: Block,
    arrays: Mapping[str, np.ndarray],
    halo: Union[Halo, Mapping[str, Halo]] = 1,
) -> Dict[str, Dataset]:
    """Port datasets from padded home arrays given as NumPy — what the JAX
    package's ``Dataset.materialize()`` returns.  Names, halos and dtypes
    carry over; each array is copied, so the two packages never share a
    buffer.  ``halo`` is one spec for every array or a ``{name: halo}``
    map."""
    out: Dict[str, Dataset] = {}
    for name, arr in arrays.items():
        h = halo[name] if isinstance(halo, Mapping) else halo
        arr = np.asarray(arr)
        dat = Dataset(block=block, name=name, dtype=arr.dtype,
                      halo=_halo_pairs(h, block.ndim),
                      data=np.array(arr, copy=True))
        out[name] = dat
    return out
