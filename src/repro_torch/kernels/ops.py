"""Public wrappers for the hand-written CUDA kernels, and the declarative
star-sweep loop kernels the ``cuda`` backend routes through them.

Ported from ``src/repro/kernels/ops.py``.  The reference's TPU block sizing,
row padding and interpret-mode switch (``block_rows``, ``block_z``,
``interpret``) have no counterpart: a CUDA kernel masks its ragged edges.

Each wrapper checks device, dtype (fp32 or bf16), rank, shape and
contiguity, allocates its output with ``torch.empty`` and launches on the
current stream.  On a CPU tensor — and only there — it returns the plain
version from :mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches (a plain
integer; set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import build
from .ref import chain2d_ref, stencil2d_ref, stencil3d_ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _symbol(name: str, types: str, nint: int, nfloat: int):
    """The C entry point ``<name>_<types>`` (``types`` as in ``_DTYPES``),
    looked up and typed once: every launch pays only the call."""
    fn = getattr(build.load(name), f"{name}_{types}")
    fn.argtypes = [_P, _P] + [_I] * nint + [_F] * nfloat + [_P]
    fn.restype = ctypes.c_int
    return fn


def _coeffs(coeffs, n: int) -> Tuple[float, ...]:
    vals = tuple(float(c) for c in coeffs)
    if len(vals) != n:
        raise ValueError(f"expected {n} coefficients, got {len(vals)}")
    return vals


def _check(x: torch.Tensor, rank: int, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() != rank:
        raise ValueError(f"{what}: expected a rank-{rank} padded input, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    if any(s < 2 for s in x.shape):
        raise ValueError(f"{what}: padded shape {tuple(x.shape)} has no interior")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous input")


def _launch(fn, what: str, x: torch.Tensor, out: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), *args,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")


def stencil2d(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """5-point stencil sweep. x: (H+2, W+2) padded; coeffs (c0, cx, cy) as
    floats; returns (H, W) in x's dtype."""
    _check(x, 2, "stencil2d")
    c = _coeffs(coeffs, 3)
    if x.device.type == "cpu":
        return stencil2d_ref(x, c)
    H, W = x.shape[0] - 2, x.shape[1] - 2
    out = torch.empty((H, W), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch(_symbol("stencil2d", _DTYPES[x.dtype], 2, 3), "stencil2d", x, out,
                H, W, *c)
        stencil2d.launches += 1
    return out


def stencil3d(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """7-point stencil sweep. x: (D+2, H+2, W+2) padded; coeffs
    (c0, cz, cx, cy) as floats; returns (D, H, W) in x's dtype."""
    _check(x, 3, "stencil3d")
    c = _coeffs(coeffs, 4)
    if x.device.type == "cpu":
        return stencil3d_ref(x, c)
    D, H, W = x.shape[0] - 2, x.shape[1] - 2, x.shape[2] - 2
    out = torch.empty((D, H, W), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch(_symbol("stencil3d", _DTYPES[x.dtype], 3, 4), "stencil3d", x, out,
                D, H, W, *c)
        stencil3d.launches += 1
    return out


def split_steps(steps: int, limit: int) -> List[int]:
    """``steps`` sweeps as the fewest passes of at most ``limit`` sweeps,
    balanced so that every pass carries the same halo overhead."""
    n = -(-steps // limit)
    return [steps // n + (1 if p < steps % n else 0) for p in range(n)]


@functools.lru_cache(maxsize=None)
def chain2d_max_steps() -> int:
    """The most sweeps one launch of the CUDA kernel runs.  Builds the
    kernel."""
    fn = build.load("chain2d").chain2d_max_steps
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def chain2d(x: torch.Tensor, coeffs: Sequence[float], steps: int) -> torch.Tensor:
    """K fused 5-point sweeps. x: (H+2K, W+2K) padded; coeffs (c0, cx, cy) as
    floats; returns (H, W) in x's dtype, computed in fp32 throughout.

    On CUDA a chain deeper than :func:`chain2d_max_steps` runs in
    :func:`split_steps` passes through fp32 intermediates;
    ``chain2d.launches`` counts every pass."""
    _check(x, 2, "chain2d")
    c = _coeffs(coeffs, 3)
    if isinstance(steps, bool):
        raise TypeError("chain2d: steps must be an int, got a bool")
    steps = operator.index(steps)
    if steps < 1:
        raise ValueError(f"chain2d: steps must be positive, got {steps}")
    if x.shape[0] <= 2 * steps or x.shape[1] <= 2 * steps:
        raise ValueError(f"chain2d: padded shape {tuple(x.shape)} has no interior "
                         f"after {steps} sweeps")
    if x.device.type == "cpu":
        return chain2d_ref(x, c, steps)
    u = x
    parts = split_steps(steps, chain2d_max_steps())
    for p, k in enumerate(parts):
        dtype = x.dtype if p == len(parts) - 1 else torch.float32
        src, dst = _DTYPES[u.dtype], _DTYPES[dtype]
        out = torch.empty((u.shape[0] - 2 * k, u.shape[1] - 2 * k), dtype=dtype,
                          device=x.device)
        _launch(_symbol("chain2d", src if src == dst else f"{src}_{dst}", 3, 3),
                "chain2d", u, out, out.shape[0], out.shape[1], k, *c)
        chain2d.launches += 1
        u = out
    return u


def _tiling(name: str, arg: int) -> Optional[Dict[str, int]]:
    """``<name>_tile(arg, &rows, &cols, &threads, &smem_bytes)`` of the
    kernel ``name`` as a dict, or None if the kernel refuses ``arg``.
    Builds the kernel."""
    vals = [ctypes.c_int() for _ in range(4)]
    fn = getattr(build.load(name), f"{name}_tile")
    fn.argtypes = [_I] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    if fn(arg, *(ctypes.byref(v) for v in vals)) != 0:
        return None
    return dict(zip(("rows", "cols", "threads", "smem_bytes"),
                    (v.value for v in vals)))


def chain2d_tiling(steps: int) -> Dict[str, int]:
    """The CUDA kernel's tiling for one launch of ``steps`` sweeps (at most
    :func:`chain2d_max_steps`): output tile ``rows`` x ``cols``, ``threads``
    per block, ``smem_bytes`` of shared memory per block.  Builds the
    kernel."""
    tiling = _tiling("chain2d", int(steps))
    if tiling is None:
        raise ValueError(f"chain2d: no single launch runs {steps} sweeps")
    return tiling


def stencil2d_tiling(dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """The CUDA kernel's tiling for an input of ``dtype``: the output
    ``rows`` and ``cols`` a warp owns, ``threads`` per block and
    ``smem_bytes`` of shared memory per block.  Builds the kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"stencil2d: dtype {dtype} not supported (float32, bfloat16)")
    return _tiling("stencil2d", torch.empty((), dtype=dtype).element_size())


def stencil3d_tiling(dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """The CUDA kernel's tiling for an input of ``dtype``: the output
    ``rows`` and ``cols`` of a block's tile in the xy plane, the z-``planes``
    a block sweeps, ``threads`` per block and ``smem_bytes`` of shared
    memory per block.  Builds the kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"stencil3d: dtype {dtype} not supported (float32, bfloat16)")
    elem = torch.empty((), dtype=dtype).element_size()
    tiling = _tiling("stencil3d", elem)
    segment = build.load("stencil3d").stencil3d_segment
    segment.argtypes, segment.restype = [_I], ctypes.c_int
    return dict(tiling, planes=segment(elem))


stencil2d.launches = 0
stencil3d.launches = 0
chain2d.launches = 0


# -- declarative star-sweep kernels (the "cuda" backend's fast path) -------------
#
# Accessor-kernels for the runtime DSL that also *declare* what they compute
# through a ``pallas_op`` tag (the reference's name, kept so that both
# packages tag loops alike): the ``cuda`` backend routes tagged loops through
# the kernels above; every other backend runs the accessor formula.
# Coefficients are baked in as Python floats so the kernel fingerprint (and
# hence the chain-plan cache) sees coefficient changes.


def star2d_kernel(src: str, dst: str, coeffs):
    """5-point star sweep kernel: dst = c0*src + cx*(±dim0) + cy*(±dim1)."""
    c0, cx, cy = (float(c) for c in coeffs)

    def kernel(acc):
        return {dst: c0 * acc(src)
                + cx * (acc(src, (1, 0)) + acc(src, (-1, 0)))
                + cy * (acc(src, (0, 1)) + acc(src, (0, -1)))}

    kernel.pallas_op = ("stencil2d", src, dst, (c0, cx, cy))
    return kernel


def star3d_kernel(src: str, dst: str, coeffs):
    """7-point star sweep kernel: dst = c0*src + cz/cx/cy * (±each dim)."""
    c0, cz, cx, cy = (float(c) for c in coeffs)

    def kernel(acc):
        return {dst: c0 * acc(src)
                + cz * (acc(src, (1, 0, 0)) + acc(src, (-1, 0, 0)))
                + cx * (acc(src, (0, 1, 0)) + acc(src, (0, -1, 0)))
                + cy * (acc(src, (0, 0, 1)) + acc(src, (0, 0, -1)))}

    kernel.pallas_op = ("stencil3d", src, dst, (c0, cz, cx, cy))
    return kernel
