"""repro_torch.core.transfer — asynchronous transfer engine, residency management,
and pluggable compression codecs for the out-of-core data plane.

Copied from ``src/repro/core/transfer/__init__.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from .codecs import (
    Codec,
    DowncastCodec,
    IdentityCodec,
    ShuffleRLECodec,
    available_codecs,
    get_codec,
    register_codec,
    resolve_codecs,
)
from .engine import TransferEngine, TransferError, TransferHandle
from .residency import ResidencyError, ResidencyManager, Slot

__all__ = [
    "Codec", "IdentityCodec", "DowncastCodec", "ShuffleRLECodec",
    "register_codec", "get_codec", "available_codecs", "resolve_codecs",
    "TransferEngine", "TransferError", "TransferHandle",
    "ResidencyManager", "ResidencyError", "Slot",
]
