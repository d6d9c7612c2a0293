"""Dependency analysis over lazy loop chains.

This is the runtime analysis at the heart of the paper (§3): given the
recorded chain of parallel loops — iteration ranges, datasets, stencils,
access modes — classify every dataset and derive the skew slope that makes
left-to-right tile execution legal.

Classification (drives the transfer-elision optimisations of §4.1):
  * ``read_only``   — never written in the chain: never downloaded.
  * ``write_first`` — first access is a pure WRITE: never uploaded, and under
    the (unsafe, opt-in) Cyclic optimisation not downloaded either.
  * ``modified``    — written at least once: must be downloaded (unless
    write_first ∧ cyclic).

Skew slope: a single conservative slope σ = max over all (loop, read-arg)
stencil extents along the tiled dimension.  With per-loop shifts
``shift_k = (n-1-k)·σ`` both flow (RAW) and anti (WAR) dependencies between
any pair of loops in the chain are satisfied for left-to-right tiles — see
the inline proof in :mod:`repro_torch.core.tiling`.

Ported from ``src/repro/core/dependency.py``: the plan-cache fingerprint
content-hashes captured ``torch.Tensor``s (where the reference hashes jax
arrays), so a kernel whose captured tensor changed is re-planned instead of
replaying a stale plan.  :func:`split_chain` is the one MemoryError split
policy of the executor and the planner preview; unlike the reference's, it
keeps the whole chain's read-first datasets live in both halves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from .dataset import Dataset
from .loop import AccessMode, ParallelLoop


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge a list of half-open (lo, hi) intervals."""
    ivs = sorted((lo, hi) for lo, hi in intervals if hi > lo)
    out: List[Tuple[int, int]] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _subtract(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """a \\ b for merged interval lists."""
    out: List[Tuple[int, int]] = []
    for lo, hi in a:
        cur = lo
        for blo, bhi in b:
            if bhi <= cur or blo >= hi:
                continue
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


@dataclass
class ChainInfo:
    """Everything the tiler/executor needs to know about one loop chain."""

    loops: List[ParallelLoop]
    datasets: Dict[str, Dataset]
    read_only: Set[str]
    write_first: Set[str]
    modified: Set[str]
    skew_slope: int
    tiled_dim: int
    # Per-dat merged interval lists along the tiled dim (grid coords):
    #   written[d] — rows some loop writes during the chain (downloads are
    #     clipped to this: never ship unwritten rows home);
    #   cold[d]    — rows READ before any write reaches them (program order):
    #     for write-first dats these still must upload (halo skirts etc.).
    written: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    cold: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    # Per-loop max |read offset| along the tiled dim — drives the per-loop
    # skew (loops that don't read along the tiled dim add no skew; on 3-D
    # chains where 2/3 of the sweeps are y/z this shrinks the chain's total
    # skew by ~4x vs the uniform n*sigma slope).
    loop_extents: List[int] = field(default_factory=list)

    @property
    def num_loops(self) -> int:
        return len(self.loops)

    def accessed_bytes(self) -> int:
        """Home-copy bytes of every dataset the chain touches (for capacity
        decisions: this is what would have to be resident without tiling)."""
        return sum(d.nbytes for d in self.datasets.values())

    def loop_bytes(self) -> int:
        """Paper's 'useful bytes' metric summed over the chain."""
        return sum(lp.bytes_moved() for lp in self.loops)


def analyze_chain(loops: Sequence[ParallelLoop], tiled_dim: int = 0) -> ChainInfo:
    """Classify datasets and compute the skew slope for ``loops``."""
    if not loops:
        raise ValueError("empty chain")
    block = loops[0].block
    for lp in loops:
        if lp.block is not block:
            raise ValueError(
                f"chain mixes blocks ({lp.block.name!r} vs {block.name!r}); "
                "multi-block chains must be split per block"
            )

    datasets: Dict[str, Dataset] = {}
    first_mode: Dict[str, AccessMode] = {}
    modified: Set[str] = set()
    ever_read: Set[str] = set()
    slope = 0
    loop_extents: List[int] = []

    for lp in loops:
        ext = 0
        for arg in lp.args:
            nm = arg.dat.name
            datasets.setdefault(nm, arg.dat)
            if nm not in first_mode:
                first_mode[nm] = arg.mode
            if arg.mode.writes:
                modified.add(nm)
            if arg.mode.reads:
                ever_read.add(nm)
                e = arg.stencil.max_abs_extent(tiled_dim)
                slope = max(slope, e)
                ext = max(ext, e)
        loop_extents.append(ext)

    read_only = {nm for nm in datasets if nm not in modified}
    write_first = {nm for nm, m in first_mode.items() if m is AccessMode.WRITE}

    # Order-aware row analysis along the tiled dim.  The skewed schedule
    # preserves producer-before-consumer, so untiled program order is the
    # right order to decide "read before written" (cold) per row.
    written: Dict[str, List[Tuple[int, int]]] = {nm: [] for nm in datasets}
    cold: Dict[str, List[Tuple[int, int]]] = {nm: [] for nm in datasets}
    for lp in loops:
        lo_r, hi_r = lp.range_[tiled_dim]
        for arg in lp.args:
            if not arg.mode.reads:
                continue
            nm = arg.dat.name
            mn, mx = arg.stencil.extent(tiled_dim)
            blo, bhi = arg.dat.bounds(tiled_dim)
            read_iv = [(max(lo_r + mn, blo), min(hi_r + mx, bhi))]
            cold[nm] = _merge(cold[nm] + _subtract(read_iv, written[nm]))
        for arg in lp.args:
            if arg.mode.writes:
                written[arg.dat.name] = _merge(written[arg.dat.name] + [(lo_r, hi_r)])

    return ChainInfo(
        loops=list(loops),
        datasets=datasets,
        read_only=read_only,
        write_first=write_first,
        modified=modified,
        skew_slope=slope,
        tiled_dim=tiled_dim,
        written=written,
        cold=cold,
        loop_extents=loop_extents,
    )


def read_first(loops: Sequence[ParallelLoop]) -> frozenset:
    """Datasets whose first access in ``loops`` (program order, argument
    order) reads — the complement of ``ChainInfo.write_first``."""
    first: Dict[str, bool] = {}
    for lp in loops:
        for a in lp.args:
            first.setdefault(a.dat.name, a.mode.reads)
    return frozenset(n for n, reads in first.items() if reads)


def split_chain(loops: Sequence[ParallelLoop], keep_live: frozenset,
                warm: frozenset):
    """The MemoryError split of a chain that no tile count fits: halves
    ``(head, head_keep_live, head_warm)`` and ``(tail, ...)``.

    ``OutOfCoreExecutor.run_chain`` runs the halves and
    ``Session._plan_split`` plans them; both call this, so they cannot
    drift apart.

    * The head keeps live whatever the tail reads: a write-first dataset of
      the head is no dead temporary if the tail consumes it.
    * The tail warm-stages whatever the head wrote: the head's downloads
      landed real data that the tail's write-first upload elision would let
      its download clobber.
    * Both halves keep live every dataset the *whole* chain reads before it
      writes.  Such a dataset carries state into the next chain; a half that
      happens to write it first would otherwise treat it as a dead
      temporary under Cyclic and elide its download (the heat program's
      ``u``, CloverLeaf's velocities).  The reference package's split lacks
      this rule, so split Cyclic plans differ from its plans on purpose;
      chains that fit unsplit plan byte-equal to the reference's.
    """
    mid = len(loops) // 2
    head, tail = loops[:mid], loops[mid:]
    live = keep_live | read_first(loops)
    tail_reads = frozenset(
        a.dat.name for lp in tail for a in lp.args if a.mode.reads)
    head_writes = frozenset(
        a.dat.name for lp in head for a in lp.args if a.mode.writes)
    return (head, live | tail_reads, warm), (tail, live, warm | head_writes)


def chain_signature(info: ChainInfo) -> Tuple:
    """A structural fingerprint of a chain: used by speculative prefetching
    (§4.1) to guess whether the next chain 'looks like' the previous one."""
    return tuple(
        (
            lp.name,
            lp.range_,
            tuple((a.dat.name, a.stencil.name, a.mode.value) for a in lp.args),
        )
        for lp in info.loops
    )


# -- plan-cache keys -------------------------------------------------------------
#
# ``chain_signature`` is structural only — good enough for the prefetch guess,
# but NOT for replaying a cached plan: the cached tile engine closes over
# the chain's kernel callables, and applications re-record kernels every
# timestep as fresh closures whose captured constants (dt, RK coefficients,
# sweep direction strings) may change.  ``kernel_fingerprint`` hashes the code
# object plus captured/default values so a changed constant forces a re-plan;
# captured values that aren't plain data (datasets, app objects) hash by type —
# the documented kernel contract is that such captures are static config.

_PRIMITIVES = (bool, int, float, str, bytes, type(None))


def _digest(arr) -> object:
    """Content key of an array: its bytes when small, else their SHA-1."""
    import numpy as _np

    raw = _np.ascontiguousarray(arr).tobytes()
    if len(raw) <= 4096:
        return raw
    import hashlib
    return hashlib.sha1(raw).hexdigest()


def _fp_value(v, depth: int = 0) -> Tuple:
    if depth > 6:
        # Past the recursion cap, fail toward *identity*: equality here would
        # let two distinct deep values share a cached plan (stale replay).
        return ("deep", id(v))
    if isinstance(v, _PRIMITIVES):
        return ("v", v)
    if isinstance(v, (tuple, list)):
        return ("t", tuple(_fp_value(x, depth + 1) for x in v))
    if isinstance(v, dict):
        return ("d", tuple(sorted(
            (repr(k), _fp_value(x, depth + 1)) for k, x in v.items())))
    try:
        import numpy as _np
        if isinstance(v, _np.generic):
            return ("v", v.item())
        import torch as _torch

        # Content-hash captured arrays and tensors: hashing by type alone
        # would let the plan cache replay a kernel whose coefficients changed.
        if isinstance(v, _np.ndarray):
            return ("a", v.dtype.str, v.shape, _digest(v))
        if isinstance(v, _torch.Tensor):
            # Hash the raw bytes under the torch dtype's name (bf16 has no
            # NumPy dtype); a CUDA capture is copied back to hash it.
            t = v.detach().cpu().contiguous().reshape(-1)
            return ("a", str(v.dtype), tuple(v.shape),
                    _digest(t.view(_torch.uint8).numpy()))
    except Exception:  # pragma: no cover
        pass
    if callable(v) and hasattr(v, "__code__"):
        return ("f", kernel_fingerprint(v, depth + 1))
    try:  # frozen dataclasses (Stencil, HardwareModel), enums, etc.
        return ("h", hash(v), type(v).__qualname__)
    except TypeError:
        # Unhashable object: identity-fingerprint.  id() is stable while the
        # object lives (apps capture `self` once, so steps still cache-hit);
        # a *different* instance forces a re-plan — the safe direction.
        return ("o", f"{type(v).__module__}.{type(v).__qualname__}", id(v))


def _code_fp(code, depth: int = 0) -> Tuple:
    """Fingerprint a code object by value.  ``co_code`` references constants
    and globals by *index*, so co_consts/co_names must be hashed too — two
    lambdas on one source line differing only in a literal would otherwise
    collide.  Nested code objects (inner functions) recurse."""
    consts = tuple(
        _code_fp(c, depth + 1) if hasattr(c, "co_code") else _fp_value(c, depth + 1)
        for c in code.co_consts)
    return (code.co_filename, code.co_firstlineno, code.co_code,
            code.co_names, consts)


def kernel_fingerprint(fn, depth: int = 0) -> Tuple:
    """Value-level identity of a kernel callable (code + captured constants)."""
    import functools as _functools

    if isinstance(fn, _functools.partial):
        return ("p", kernel_fingerprint(fn.func, depth + 1),
                _fp_value(tuple(fn.args), depth), _fp_value(fn.keywords or {}, depth))
    code = getattr(fn, "__code__", None)
    if code is None:  # callable object: type + instance identity (stateful
        # callables with different state must not share a cached plan)
        return ("o", f"{type(fn).__module__}.{type(fn).__qualname__}", id(fn))
    cells = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            cells.append(_fp_value(cell.cell_contents, depth))
        except ValueError:  # unassigned cell
            cells.append(("unset",))
    defaults = tuple(_fp_value(v, depth)
                     for v in (getattr(fn, "__defaults__", None) or ()))
    kwdefaults = _fp_value(getattr(fn, "__kwdefaults__", None) or {}, depth)
    return ("k", _code_fp(code, depth), tuple(cells), defaults, kwdefaults)


def loop_kernel_fingerprint(lp: ParallelLoop) -> Tuple:
    """Kernel fingerprint memoised on the loop object — each recorded loop's
    kernel is walked once, not once per flush plus once per inference."""
    fp = lp.__dict__.get("_kernel_fp")
    if fp is None:
        fp = kernel_fingerprint(lp.kernel)
        lp.__dict__["_kernel_fp"] = fp
    return fp


def plan_signature(loops: Sequence[ParallelLoop], tiled_dim: int = 0) -> Tuple:
    """Replay-safe fingerprint of a chain: structure + dataset identity +
    kernel fingerprints.  Two chains with equal plan signatures execute
    identically through a cached plan (analysis, schedule, tile engine)."""
    return (tiled_dim,) + tuple(
        (
            lp.name,
            lp.range_,
            tuple((a.dat.name, id(a.dat), a.stencil.points, a.mode.value)
                  for a in lp.args),
            tuple((r.name, r.op) for r in lp.reductions),
            loop_kernel_fingerprint(lp),
        )
        for lp in loops
    )


def shared_plan_signature(loops: Sequence[ParallelLoop], tiled_dim: int = 0) -> Tuple:
    """Tenant-neutral variant of ``plan_signature`` for cross-session plan
    sharing (the serving layer's shared cache).

    ``plan_signature`` keys dataset identity by ``id(a.dat)`` — correct for a
    single session (the same Dataset object means the same buffer), but it
    makes two tenants running the *same* app on *separate* datasets miss each
    other's plans by construction.  Here datasets are keyed structurally
    (name, block extents, halo, dtype): two chains with equal shared
    signatures have isomorphic data layouts and value-identical kernels, so
    one chain's plan replays soundly for the other once its ``ChainInfo`` is
    rebound to the new tenant's datasets (the engine and Plan IR reference
    datasets by name only).

    Kernels that capture non-data objects (app instances, other sessions'
    state) fingerprint by identity inside ``loop_kernel_fingerprint`` and so
    never match across tenants — the safe direction.  Captured tensors are
    content-hashed (a CUDA capture through a host copy)."""
    return (tiled_dim,) + tuple(
        (
            lp.name,
            lp.range_,
            tuple((a.dat.name, tuple(a.dat.block.size), tuple(a.dat.halo),
                   a.dat.dtype.str, a.stencil.points, a.mode.value)
                  for a in lp.args),
            tuple((r.name, r.op) for r in lp.reductions),
            loop_kernel_fingerprint(lp),
        )
        for lp in loops
    )
