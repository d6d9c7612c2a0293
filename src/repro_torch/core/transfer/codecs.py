"""Pluggable compression codecs for the host<->device transfer path.

Following "Compression-Based Optimizations for Out-of-Core GPU Stencil
Computation" (Shen et al., 2022), every staged footprint can be encoded
before it crosses the slow link and decoded on the other side; the *wire*
bytes (encoded size) are what the transfer ledger charges, so modelled
makespans reflect compressed traffic while the data plane stays real.

Built-ins:

===============  ==============================================================
``identity``     no-op; wire bytes == raw bytes (the default, bit-exact)
``fp16``         lossy IEEE half down-cast of float data (2x on fp32)
``bf16``         lossy bfloat16 down-cast via round-to-nearest-even bit
                 truncation (2x on fp32, keeps fp32's exponent range)
``shuffle-rle``  lossless byte-shuffle (group bytes by significance plane)
                 + run-length coding; wins on smooth fields, can expand on
                 noise — the achieved ratio is reported either way
===============  ==============================================================

Codecs are stateless singletons in a string-keyed registry mirroring the
backend registry: ``register_codec`` / ``get_codec`` / ``available_codecs``.
Non-float arrays pass through the lossy down-cast codecs unchanged.

Copied from ``src/repro/core/transfer/codecs.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np


class Codec:
    """Encode/decode one staged array region.

    ``encode`` returns ``(payload, meta)``; ``decode(payload, meta)`` must
    return an array of the original dtype/shape.  ``wire_bytes`` is the size
    the link actually carries.  ``nominal_ratio`` is the dtype-level estimate
    used by ``simulate_only`` runs, where there is no data to compress.
    """

    name: str = "?"
    lossless: bool = True

    def encode(self, arr: np.ndarray) -> Tuple[Any, Dict]:
        raise NotImplementedError

    def decode(self, payload: Any, meta: Dict) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def wire_bytes(payload: Any) -> int:
        return int(payload.nbytes if hasattr(payload, "nbytes") else len(payload))

    def nominal_ratio(self, dtype: np.dtype) -> float:
        return 1.0

    def roundtrip(self, arr: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Encode+decode ``arr``; returns ``(decoded, raw_bytes, wire_bytes)``.

        This is what the transfer engine runs on the staging path: the decoded
        array is what lands on the far side, so lossy codecs really lose bits.
        """
        arr = np.asarray(arr)
        payload, meta = self.encode(arr)
        return self.decode(payload, meta), int(arr.nbytes), self.wire_bytes(payload)


class IdentityCodec(Codec):
    name = "identity"
    lossless = True

    def encode(self, arr):
        return arr, {}

    def decode(self, payload, meta):
        return payload

    def roundtrip(self, arr):
        arr = np.asarray(arr)
        return arr, int(arr.nbytes), int(arr.nbytes)


def _bf16_encode(f32: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of fp32 to its top 16 bits.

    NaNs are special-cased: the rounding add would carry a NaN mantissa into
    the exponent (0x7FFFFFFF -> 0x8000, i.e. -0.0), silently swallowing a
    diverged simulation.  They map to the signed quiet NaN instead.
    """
    f32 = np.ascontiguousarray(f32, dtype=np.float32)
    u = f32.view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    enc = ((u + rounding) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(f32)
    if nan.any():
        qnan = ((u >> np.uint32(16)) & np.uint16(0x8000)) | np.uint16(0x7FC0)
        enc = np.where(nan, qnan.astype(np.uint16), enc)
    return enc


def _bf16_decode(enc: np.ndarray) -> np.ndarray:
    return (enc.astype(np.uint32) << np.uint32(16)).view(np.float32)


class DowncastCodec(Codec):
    """Lossy float down-cast (``fp16`` / ``bf16``); non-floats pass through."""

    lossless = False

    def __init__(self, name: str):
        self.name = name

    def encode(self, arr):
        meta = {"dtype": arr.dtype.str, "shape": arr.shape}
        if arr.dtype.kind != "f" or arr.dtype.itemsize <= 2:
            return arr, {**meta, "passthrough": True}
        if self.name == "fp16":
            return arr.astype(np.float16), meta
        return _bf16_encode(arr.astype(np.float32)), meta

    def decode(self, payload, meta):
        if meta.get("passthrough"):
            return payload
        dtype = np.dtype(meta["dtype"])
        if self.name == "fp16":
            return payload.astype(dtype)
        return _bf16_decode(payload).astype(dtype)

    def nominal_ratio(self, dtype):
        dtype = np.dtype(dtype)
        if dtype.kind != "f" or dtype.itemsize <= 2:
            return 1.0
        return dtype.itemsize / 2.0


class ShuffleRLECodec(Codec):
    """Byte-shuffle + run-length coding, lossless.

    The shuffle transposes the (n_elements, itemsize) byte matrix so each
    significance plane is contiguous; smooth fields then expose long runs in
    the exponent/high-mantissa planes.  Runs are stored as (length, value)
    uint8 pairs (long runs split at 255), so the worst case doubles the size —
    the achieved ratio is whatever it is, and is reported honestly.
    """

    name = "shuffle-rle"
    lossless = True

    def encode(self, arr):
        arr = np.ascontiguousarray(arr)
        meta = {"dtype": arr.dtype.str, "shape": arr.shape}
        itemsize = arr.dtype.itemsize
        flat = np.frombuffer(arr.tobytes(), dtype=np.uint8)
        if flat.size == 0:
            return np.zeros(0, np.uint8), meta
        shuffled = flat.reshape(-1, itemsize).T.ravel()
        # Vectorised RLE over the shuffled byte stream.
        change = np.flatnonzero(shuffled[1:] != shuffled[:-1]) + 1
        starts = np.concatenate(([0], change))
        lengths = np.diff(np.concatenate((starts, [shuffled.size])))
        values = shuffled[starts]
        # Split runs longer than 255 into full chunks + remainder in [1, 255].
        reps = (lengths + 254) // 255
        out_values = np.repeat(values, reps).astype(np.uint8)
        out_lengths = np.full(out_values.size, 255, dtype=np.uint8)
        last = np.cumsum(reps) - 1
        out_lengths[last] = (lengths - (reps - 1) * 255).astype(np.uint8)
        return np.concatenate((out_lengths, out_values)), meta

    def decode(self, payload, meta):
        dtype = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        n = payload.size // 2
        lengths = payload[:n].astype(np.intp)
        values = payload[n:]
        flat = np.repeat(values, lengths)
        itemsize = dtype.itemsize
        unshuffled = flat.reshape(itemsize, -1).T.reshape(-1)
        return np.frombuffer(unshuffled.tobytes(), dtype=dtype).reshape(shape)


# -- registry ---------------------------------------------------------------------

_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Register a codec instance under its ``name``."""
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    codec = _CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown codec {name!r}; available: {', '.join(available_codecs())}")
    return codec


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


register_codec(IdentityCodec())
register_codec(DowncastCodec("fp16"))
register_codec(DowncastCodec("bf16"))
register_codec(ShuffleRLECodec())


CodecSpec = Union[str, Dict[str, str], None]


def resolve_codecs(spec: CodecSpec, dat_names: Sequence[str]) -> Dict[str, Codec]:
    """Materialise a per-dataset codec map from a config spec.

    ``spec`` is a codec name applied to every dataset, or a ``{dat: name}``
    dict with an optional ``"*"`` default (identity if absent), or ``None``
    (identity everywhere).  Dict entries naming datasets a particular chain
    does not touch are simply unused (one spec serves every chain of an app).
    """
    if spec is None:
        spec = "identity"
    if isinstance(spec, str):
        codec = get_codec(spec)
        return {nm: codec for nm in dat_names}
    default = get_codec(spec.get("*", "identity"))
    return {nm: get_codec(spec[nm]) if nm in spec else default for nm in dat_names}
