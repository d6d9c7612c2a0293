"""``chunked`` backing store: compressed fixed-size chunks on disk + an LRU
decompressed-chunk cache with a byte budget in RAM.

This is the tier that makes problems *larger than host RAM* representable
(Shen et al. 2022's compressed out-of-core design applied one level down):
the array is split into slabs of whole rows along axis 0, each slab lives on
disk as one codec-compressed payload, and only the chunks the executor is
currently staging are held decompressed in RAM.  The cache budget is the
host-RAM working-set bound — touch more rows than fit and the LRU end is
compressed back out (dirty chunks only; clean ones are simply dropped).

Compression uses the :mod:`repro_torch.core.transfer.codecs` registry.  The default
is the lossless ``shuffle-rle``; a lossy codec (``fp16``/``bf16``) degrades
the *home copy itself* on every evict/reload cycle, not just the wire — the
README's safety note applies doubly here.

Chunk files are written atomically (write-to-temp + ``os.replace``) so a
killed run never leaves a torn chunk behind; together with
``Session.checkpoint``'s atomic manifest this is what makes multi-hour
out-of-core runs restartable.

Thread safety: one re-entrant lock serialises all public operations — the
transfer engine's upload, download and disk-fetch workers share a store.

Copied from ``src/repro/core/store/chunked.py`` with its imports rewired to
``repro_torch``; ``write`` also takes a tensor on any device (it comes to the
host first).  :meth:`~repro_torch.core.store.base.BackingStore.tensor` gives a
fresh tensor of the rows read through the cache, never a view.
"""
from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Set, Tuple

import numpy as np

from .base import (
    BackingStore,
    Index,
    StoreConfig,
    StoreError,
    host_values,
    register_store,
)


def _get_codec(name: str):
    # Function-level: the transfer package reaches back into dataset.py via
    # the residency/dependency modules, so importing it at module scope would
    # close an import cycle (store <- dataset <- dependency <- transfer).
    from ..transfer.codecs import get_codec

    return get_codec(name)


class ChunkedStore(BackingStore):
    kind = "chunked"

    def __init__(self, directory: str, shape: Tuple[int, ...], dtype, *,
                 chunk_bytes: int = 1 << 20, cache_bytes: int = 64 << 20,
                 codec: str = "shuffle-rle"):
        super().__init__(shape, dtype)
        if not shape:
            raise StoreError("chunked store needs at least one dimension")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.codec = _get_codec(codec) if isinstance(codec, str) else codec
        row_nbytes = self.dtype.itemsize
        for s in shape[1:]:
            row_nbytes *= s
        self.chunk_rows = max(1, int(chunk_bytes) // max(1, row_nbytes))
        self.num_chunks = -(-self.shape[0] // self.chunk_rows)
        self.cache_bytes = int(cache_bytes)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cached_bytes = 0
        self._dirty: Set[int] = set()
        self._on_disk: Set[int] = {
            i for i in range(self.num_chunks)
            if os.path.exists(self._chunk_path(i))
        }
        self._lock = threading.RLock()

    # -- chunk geometry -------------------------------------------------------
    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.directory, f"chunk_{i:06d}.npz")

    def _chunk_shape(self, i: int) -> Tuple[int, ...]:
        rows = min(self.chunk_rows, self.shape[0] - i * self.chunk_rows)
        return (rows,) + self.shape[1:]

    def _norm(self, index: Index) -> Tuple[slice, ...]:
        index = tuple(index)
        if len(index) > self.ndim:
            raise StoreError(f"index arity {len(index)} > ndim {self.ndim}")
        index = index + tuple(slice(None) for _ in range(self.ndim - len(index)))
        out = []
        for d, sl in enumerate(index):
            if not isinstance(sl, slice):
                raise StoreError("chunked stores accept slice indices only")
            lo, hi, step = sl.indices(self.shape[d])
            if step != 1:
                raise StoreError("chunked stores accept unit-step slices only")
            out.append(slice(lo, hi))
        return tuple(out)

    # -- disk round-trip ------------------------------------------------------
    def _load_chunk(self, i: int) -> np.ndarray:
        if i in self._on_disk:
            with open(self._chunk_path(i), "rb") as f:
                with np.load(f) as z:
                    meta = json.loads(bytes(z["meta"].tobytes()))
                    payload = z["payload"]
                    self.stats["disk_bytes_read"] += int(payload.nbytes)
            codec = _get_codec(meta.pop("codec"))
            # Fresh writable array: shuffle-rle decodes via frombuffer views.
            arr = np.array(codec.decode(payload, meta), dtype=self.dtype,
                           copy=True)
            # A reopened spill dir written under different geometry (other
            # chunk_bytes / array shape / dtype) must fail loudly, not feed
            # wrong-shaped slabs into read()'s concatenation.
            expect = self._chunk_shape(i)
            if arr.shape != expect or np.dtype(meta.get("dtype", self.dtype)) \
                    != self.dtype:
                raise StoreError(
                    f"chunk {i} in {self.directory!r} is {arr.shape} "
                    f"{meta.get('dtype')}, store geometry expects {expect} "
                    f"{self.dtype.str} — was this directory written with "
                    f"different chunk_bytes/shape/dtype?")
            return arr
        return np.zeros(self._chunk_shape(i), dtype=self.dtype)

    def _store_chunk(self, i: int, arr: np.ndarray) -> int:
        payload, meta = self.codec.encode(arr)
        payload = np.asarray(payload)
        meta = {**meta, "codec": self.codec.name,
                "dtype": self.dtype.str, "shape": list(arr.shape)}
        meta_u8 = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        path = self._chunk_path(i)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, payload=payload, meta=meta_u8)
        os.replace(tmp, path)
        self._on_disk.add(i)
        written = int(payload.nbytes)
        self.stats["disk_bytes_written"] += written
        return written

    # -- the LRU cache --------------------------------------------------------
    def _get(self, i: int) -> np.ndarray:
        arr = self._cache.get(i)
        if arr is not None:
            self._cache.move_to_end(i)
            self.stats["cache_hits"] += 1
            return arr
        self.stats["cache_misses"] += 1
        arr = self._load_chunk(i)
        self._cache[i] = arr
        self._cached_bytes += arr.nbytes
        self._shrink(keep=i)
        return arr

    def _shrink(self, keep: int) -> None:
        """Evict LRU chunks until the cache fits its byte budget (the chunk
        just touched is never evicted, so a budget smaller than one chunk
        degrades to exactly-one-resident rather than thrashing forever)."""
        while self._cached_bytes > self.cache_bytes and len(self._cache) > 1:
            i, arr = next(iter(self._cache.items()))
            if i == keep:
                self._cache.move_to_end(i)
                continue
            self._evict(i)

    def _evict(self, i: int) -> int:
        arr = self._cache.pop(i)
        self._cached_bytes -= arr.nbytes
        self.stats["chunk_evictions"] += 1
        if i in self._dirty:
            self._dirty.discard(i)
            return self._store_chunk(i, arr)
        return 0

    def _overlapping(self, lo: int, hi: int) -> range:
        if hi <= lo:
            return range(0)
        return range(lo // self.chunk_rows, (hi - 1) // self.chunk_rows + 1)

    # -- data access ----------------------------------------------------------
    def read(self, index: Index) -> np.ndarray:
        index = self._norm(index)
        lo, hi = index[0].start, index[0].stop
        rest = index[1:]
        out_shape = (max(0, hi - lo),) + tuple(s.stop - s.start for s in rest)
        if out_shape[0] <= 0:
            return np.empty(out_shape, dtype=self.dtype)
        with self._lock:
            chunks = self._overlapping(lo, hi)
            if len(chunks) == 1:
                i = chunks[0]
                base = i * self.chunk_rows
                return np.array(self._get(i)[(slice(lo - base, hi - base),)
                                             + rest], copy=True)
            # Preallocate and fill chunk-by-chunk: a full-array read (e.g.
            # materialize() for a checkpoint) then peaks at one uncompressed
            # copy plus the cache budget, not two copies — and the LRU keeps
            # shrinking behind the scan instead of pinning every chunk in a
            # parts list.
            out = np.empty(out_shape, dtype=self.dtype)
            for i in chunks:
                base = i * self.chunk_rows
                rows = self._chunk_shape(i)[0]
                clo, chi = max(lo, base), min(hi, base + rows)
                out[clo - lo:chi - lo] = \
                    self._get(i)[(slice(clo - base, chi - base),) + rest]
            return out

    def write(self, index: Index, values) -> None:
        index = self._norm(index)
        lo, hi = index[0].start, index[0].stop
        rest = index[1:]
        tshape = (max(0, hi - lo),) + tuple(s.stop - s.start for s in rest)
        if tshape[0] <= 0:
            return
        vals = np.broadcast_to(np.asarray(host_values(values), dtype=self.dtype),
                               tshape)
        with self._lock:
            for i in self._overlapping(lo, hi):
                base = i * self.chunk_rows
                rows = self._chunk_shape(i)[0]
                clo, chi = max(lo, base), min(hi, base + rows)
                arr = self._get(i)
                arr[(slice(clo - base, chi - base),) + rest] = \
                    vals[clo - lo:chi - lo]
                self._dirty.add(i)
                self._cache.move_to_end(i)
            self._shrink(keep=(hi - 1) // self.chunk_rows)

    # -- disk-tier hooks ------------------------------------------------------
    def prefetch(self, index: Index) -> int:
        """Decompress the indexed rows' chunks into the cache ahead of the
        staging read; returns disk bytes actually read (0 on full cache hit)."""
        index = self._norm(index)
        lo, hi = index[0].start, index[0].stop
        with self._lock:
            before = self.stats["disk_bytes_read"]
            for i in self._overlapping(lo, hi):
                self._get(i)
            return self.stats["disk_bytes_read"] - before

    def spill(self, index: Index) -> int:
        """Retire the indexed rows to disk: dirty overlapping chunks are
        compressed out; chunks *fully* covered by the row range are also
        dropped from the cache (their rows are done for this chain), which is
        what keeps the resident set inside the budget on oversubscribed
        runs.  Returns disk bytes written."""
        index = self._norm(index)
        lo, hi = index[0].start, index[0].stop
        written = 0
        with self._lock:
            for i in self._overlapping(lo, hi):
                base = i * self.chunk_rows
                rows = self._chunk_shape(i)[0]
                fully = lo <= base and base + rows <= hi
                if i in self._cache and fully:
                    written += self._evict(i)
                elif i in self._dirty:
                    written += self._store_chunk(i, self._cache[i])
                    self._dirty.discard(i)
        return written

    def flush(self) -> int:
        with self._lock:
            written = 0
            for i in sorted(self._dirty):
                written += self._store_chunk(i, self._cache[i])
            self._dirty.clear()
            return written

    def close(self) -> None:
        with self._lock:
            self.flush()
            self._cache.clear()
            self._cached_bytes = 0

    # -- introspection --------------------------------------------------------
    def cache_keys(self) -> Tuple[int, ...]:
        """Resident chunk ids, LRU-first (tests assert eviction ordering)."""
        with self._lock:
            return tuple(self._cache)

    def cache_resident_bytes(self) -> int:
        with self._lock:
            return self._cached_bytes


@register_store("chunked")
def _chunked(config: StoreConfig, name: str, shape, dtype,
             data=None) -> ChunkedStore:
    directory = os.path.join(config.resolved_directory("chunked"), name)
    store = ChunkedStore(directory, shape, dtype,
                         chunk_bytes=config.chunk_bytes,
                         cache_bytes=config.cache_bytes, codec=config.codec)
    if data is not None:
        store.write(tuple(slice(None) for _ in shape), data)
    return store
