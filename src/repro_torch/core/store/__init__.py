"""repro_torch.core.store — dataset home copies (``ram``: a host tensor with a
shared NumPy view, pinned when a CUDA session uses it).  Ported from
``src/repro/core/store/``; ``mmap``, ``chunked`` and checkpoints are
ROADMAP A8."""
from .base import BackingStore, RamStore, StoreError, make_store

__all__ = ["BackingStore", "RamStore", "StoreError", "make_store"]
