"""repro_torch.core.store — tiered host storage for dataset home copies:
``ram`` (a host tensor with a shared NumPy view, pinned when a CUDA session
stages it; the default), ``mmap`` (np.memmap over a spill directory), and
``chunked`` (codec-compressed fixed-size chunks on disk behind an LRU
decompressed-chunk cache), plus atomic checkpoint save/restore.  Ported from
``src/repro/core/store/``."""
from .base import (
    BackingStore,
    RamStore,
    StoreConfig,
    StoreError,
    available_stores,
    make_store,
    register_store,
)
from .checkpoint import CHECKPOINT_FORMAT, load_checkpoint, save_checkpoint
from .chunked import ChunkedStore
from .mmapstore import MmapStore

__all__ = [
    "BackingStore", "RamStore", "MmapStore", "ChunkedStore",
    "StoreConfig", "StoreError",
    "make_store", "register_store", "available_stores",
    "save_checkpoint", "load_checkpoint", "CHECKPOINT_FORMAT",
]
