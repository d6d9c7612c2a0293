"""The unified ``StencilProgram``/``Session`` frontend.

This is the user-facing API of the runtime (the load-bearing seam every
backend plugs into):

* **Declarative kernel registration with inferred stencils** — instead of
  hand-building ``Arg(dat, stencil, mode)`` lists, users pass the datasets a
  loop touches and the runtime *traces* the kernel's :class:`Accessor` offset
  calls against abstract data to derive each READ stencil and every access
  mode.  ``explicit_stencil=`` is the escape hatch (e.g. to preserve a wider
  paper-fidelity footprint than the kernel formula reads), and
  ``validate_stencils=True`` cross-checks hand-declared ``Arg`` lists against
  the trace.
* **String-keyed backend registry** — ``Session("ooc")``,
  ``Session("reference")``, ... select execution strategies registered in
  :mod:`repro_torch.core.backends`; one :class:`ExecutionConfig` absorbs the old
  ``OOCConfig`` + ``HardwareModel`` preset plumbing.
* **Memoised chain plans** — the executor caches the full
  ``analyze_chain`` → ``make_tile_schedule`` → engine pipeline keyed by a
  replay-safe chain signature, so cyclic applications (the 28-loop CloverLeaf
  timestep) pay analysis/scheduling once and replay it every following step;
  ``Session.plan_stats()`` reports the hit rate.

The lazy-recording contract is unchanged from OPS: loops queue up; data
returning to user space (``fetch``, reading a reduction) flushes the chain.
Ported from ``src/repro/core/program.py``.  ``ExecutionConfig`` gains
``device`` (``"cuda"`` by default; it raises where there is no CUDA, and the
CPU must be asked for).  Stencil inference traces kernels against torch CPU
tensors.  ``fetch``/``reduction`` still return NumPy, like the reference's
public API.  ``mesh=`` runs the sharded executor (``sim:N`` virtual or
``cuda:N`` real devices, :mod:`repro_torch.core.sharded`).
``Session(backend=ServerClient)`` is a tenant of a
:class:`repro_torch.serve.StencilServer`.  The reference's deprecated
``Runtime`` shims are not carried over.  ``close()`` also flushes and closes
the disk-backed homes (``mmap``/``chunked``) the session has seen.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .backends import make_backend
from .block import Block
from .dataset import Dataset, torch_dtype
from .dependency import kernel_fingerprint, split_chain
from .loop import AccessMode, Accessor, Arg, Kernel, ParallelLoop, ReductionSpec
from .device import resolve_device
from .memory import H100, PRESETS, HardwareModel
from .stencil import Stencil, offset_stencil, point_stencil


class StencilValidationError(ValueError):
    """Declared stencils/modes disagree with what the kernel actually does."""


class SessionClosedError(RuntimeError):
    """Work was submitted to a Session after :meth:`Session.close`.

    ``close()`` itself is idempotent, and reads of already-materialised data
    (``fetch`` with an empty queue, ``reduction`` of a retained result) stay
    legal after close — only *new work* (``par_loop``, a flush with loops
    still queued) raises: this error is what a use-after-close gets instead
    of an AttributeError from a torn-down backend."""


@dataclass
class ExecutionConfig:
    """One config object selecting and parameterising a backend.

    ``hw`` accepts a :class:`HardwareModel` or a preset name from
    ``repro_torch.core.memory.PRESETS`` (``"h100-sxm"``, the default,
    ``"p100-pcie"``, ``"p100-nvlink"``, ``"knl-7210"``).  ``device`` is
    where slots and kernel inputs live: ``"cuda"`` (the default) raises on
    a machine without CUDA — there is no silent fallback — and ``"cpu"``
    must be passed explicitly.
    """

    backend: str = "ooc"
    hw: Union[HardwareModel, str] = H100
    capacity_bytes: Optional[float] = None   # default: hw.fast_capacity
    num_slots: int = 3
    num_tiles: Optional[int] = None          # default: smallest that fits
    tiled_dim: int = 0
    cyclic: bool = False                     # §4.1 unsafe temporaries opt
    prefetch: bool = False                   # §4.1 speculative prefetch
    flops_per_point: Optional[int] = None
    simulate_only: bool = False              # schedule/ledger only
    validate_stencils: bool = False          # cross-check declared Args vs trace
    # -- transfer subsystem (repro_torch.core.transfer) -----------------------------
    transfer: str = "sync"                   # "sync" | "threaded" workers
    codec: Union[str, Dict[str, str]] = "identity"   # per-dat: {"dat": name, "*": ...}
    pinned: Tuple[str, ...] = ()             # datasets kept device-resident
    # -- host tier (repro_torch.core.store) -----------------------------------------
    # Host-RAM budget for dataset home copies; chains whose working set
    # exceeds it plan FetchHome/SpillHome ops against the disk-backed stores.
    host_capacity: Optional[float] = None    # default: hw.host_capacity
    # -- device mesh (repro_torch.core.mesh / repro_torch.core.sharded) -------
    # Grid decomposition along ``shard_dim``: a DeviceMesh, an int (virtual
    # sim:N mesh) or a "sim:N"/"cuda:N" spec.  Any ooc-family backend with a
    # multi-device mesh routes through the sharded executor; ``halo_depth``
    # bounds the redundant-compute skirt (rows per interior side; default:
    # auto from the shard width).
    mesh: Union[None, int, str, "DeviceMesh"] = None  # noqa: F821
    shard_dim: int = 1
    halo_depth: Optional[int] = None
    # -- static verification (repro_torch.core.verify) ----------------------
    # Verify every plan before interpreting it; error-severity diagnostics
    # raise PlanVerificationError instead of executing a corrupting stream.
    debug: bool = False
    # -- observability (repro_torch.obs) ---------------------------------------------
    # ``trace=True`` mints a span Tracer shared by every executor this config
    # builds (per-chain / per-op / transfer-lane spans, Chrome-trace export,
    # drift audit); pass an existing ``repro_torch.obs.Tracer`` to share one spine
    # across sessions.  ``Session.trace()`` returns it.  Off by default.
    trace: object = None                     # None/False | True | obs.Tracer
    # -- where the data plane and the kernels run ------------------------------
    device: str = "cuda"

    def __post_init__(self) -> None:
        self.device = str(resolve_device(self.device))
        if isinstance(self.hw, str):
            if self.hw not in PRESETS:
                raise ValueError(
                    f"unknown hardware preset {self.hw!r}; "
                    f"available: {sorted(PRESETS)}")
            self.hw = PRESETS[self.hw]
        from .mesh import parse_mesh

        self.mesh = parse_mesh(self.mesh)

    def ooc_config(self, **overrides):
        """Materialise the executor-level :class:`OOCConfig`."""
        from .executor import OOCConfig

        kw = dict(
            hw=self.hw, capacity_bytes=self.capacity_bytes,
            num_slots=self.num_slots, num_tiles=self.num_tiles,
            tiled_dim=self.tiled_dim, cyclic=self.cyclic,
            prefetch=self.prefetch, flops_per_point=self.flops_per_point,
            simulate_only=self.simulate_only,
            transfer=self.transfer, codec=self.codec,
            pinned=tuple(self.pinned),
            host_capacity=self.host_capacity,
            debug=self.debug,
            trace=self.trace,
            device=self.device,
        )
        kw.update(overrides)
        return OOCConfig(**kw)


# -- stencil inference ------------------------------------------------------------


class _TracingAccessor(Accessor):
    """Records every ``acc(name, offset)`` call against abstract data.

    The trace runs over a shrunken box (offsets are static Python tuples, so
    the access pattern is shape-independent); values are all-ones so kernels
    with divisions/sqrt trace cleanly.  Kernels must be pure array functions
    of their reads — the core OPS contract — which is exactly what makes this
    sound: one eager evaluation visits every access site.
    """

    def __init__(self, block: Block, range_: Tuple[Tuple[int, int], ...],
                 dats: Dict[str, Dataset]):
        self._block = block
        self._range = range_
        self._dats = dats
        self.shape = tuple(min(b - a, 3) for a, b in range_)
        self.device = torch.device("cpu")
        self.reads: Dict[str, Set[Tuple[int, ...]]] = {}

    def coords(self):
        nd = self._block.ndim
        out = []
        for d in range(nd):
            lo = self._range[d][0]
            ar = torch.arange(lo, lo + self.shape[d], dtype=torch.int32)
            shape = [1] * nd
            shape[d] = self.shape[d]
            out.append(ar.reshape(shape).expand(self.shape))
        return tuple(out)

    def __call__(self, name: str, offset: Tuple[int, ...] = None):
        if name not in self._dats:
            raise KeyError(
                f"kernel reads dataset {name!r} which was not passed to "
                f"par_loop (known: {sorted(self._dats)})")
        nd = self._block.ndim
        if offset is None:
            offset = (0,) * nd
        offset = tuple(int(o) for o in offset)
        if len(offset) != nd:
            raise ValueError(
                f"kernel reads {name!r} with offset {offset} of arity "
                f"{len(offset)} != block ndim {nd}")
        self.reads.setdefault(name, set()).add(offset)
        return torch.ones(self.shape, dtype=torch_dtype(self._dats[name].dtype))


@dataclass(frozen=True)
class KernelTrace:
    """What one abstract evaluation of a kernel revealed."""

    reads: Dict[str, Tuple[Tuple[int, ...], ...]]   # name -> sorted offsets
    writes: Tuple[str, ...]                          # dat names produced


def trace_kernel(
    kernel: Kernel,
    block: Block,
    range_: Tuple[Tuple[int, int], ...],
    dats: Dict[str, Dataset],
    reductions: Sequence[ReductionSpec] = (),
) -> KernelTrace:
    """Run ``kernel`` once against abstract data and classify its accesses."""
    acc = _TracingAccessor(block, range_, dats)
    out = kernel(acc)
    if not isinstance(out, dict):
        raise TypeError(
            f"kernel must return a dict of written-dat/reduction arrays, "
            f"got {type(out).__name__}")
    red_names = {r.name for r in reductions}
    writes = []
    for name in out:
        if name in red_names:
            continue
        if name not in dats:
            raise KeyError(
                f"kernel produced {name!r} which is neither a dataset passed "
                f"to par_loop nor a declared reduction "
                f"(datasets: {sorted(dats)}; reductions: {sorted(red_names)})")
        writes.append(name)
    missing = red_names - set(out)
    if missing:
        raise KeyError(f"kernel did not produce reduction(s) {sorted(missing)}")
    return KernelTrace(
        reads={n: tuple(sorted(offs)) for n, offs in acc.reads.items()},
        writes=tuple(writes),
    )


def infer_args(
    kernel: Kernel,
    block: Block,
    range_: Tuple[Tuple[int, int], ...],
    dats: Sequence[Dataset],
    reductions: Sequence[ReductionSpec] = (),
    inc: Sequence[str] = (),
    explicit_stencil: Optional[Dict[str, Stencil]] = None,
    extra: Sequence[Arg] = (),
) -> Tuple[Arg, ...]:
    """Build the ``Arg`` list for ``dats`` from a kernel trace.

    ``extra`` are hand-declared args for additional datasets (mixed style);
    they participate in the trace's name resolution but are not re-derived.
    ``inc`` names datasets whose writes accumulate (INC) — accumulation is a
    semantic choice the trace cannot observe, so it stays an explicit hint.
    """
    explicit_stencil = explicit_stencil or {}
    by_name = {d.name: d for d in dats}
    for a in extra:
        by_name.setdefault(a.dat.name, a.dat)
    trace = trace_kernel(kernel, block, range_, by_name, reductions)
    nd = block.ndim
    zero = point_stencil(nd)
    written = set(trace.writes)
    inc = set(inc)
    inferred_names = {d.name for d in dats}
    unknown_inc = inc - inferred_names
    if unknown_inc:
        raise ValueError(f"inc= names not among the inferred datasets: "
                         f"{sorted(unknown_inc)}")
    unknown_sten = set(explicit_stencil) - inferred_names
    if unknown_sten:
        # A typo here would silently drop a declared-wider footprint.
        raise ValueError(f"explicit_stencil= names not among the inferred "
                         f"datasets: {sorted(unknown_sten)}")

    args: List[Arg] = []
    for dat in dats:
        nm = dat.name
        offs = trace.reads.get(nm, ())
        w = nm in written
        if not offs and not w:
            raise ValueError(
                f"dataset {nm!r} was passed to par_loop but the kernel "
                f"neither reads nor writes it")
        sten = explicit_stencil.get(nm)
        if sten is not None and offs:
            # The override exists to *widen* footprints; a stencil narrower
            # than the traced reads would silently mis-size tile halos.
            uncovered = set(offs) - set(sten.points)
            if uncovered:
                raise StencilValidationError(
                    f"explicit_stencil for {nm!r} does not cover traced read "
                    f"offsets {sorted(uncovered)}")
        if sten is None and offs:
            sten = offset_stencil(*offs)
        if w and offs:
            if all(all(o == 0 for o in p) for p in offs) and nm not in explicit_stencil:
                mode = AccessMode.INC if nm in inc else AccessMode.RW
                args.append(Arg(dat, zero, mode))
            else:
                # Offset reads of a written dat: split into READ(stencil) +
                # WRITE(zero) args — legal only when the regions are disjoint
                # (halo-mirror loops); ParallelLoop validates that.
                if nm in inc:
                    raise ValueError(
                        f"inc={nm!r}: accumulation cannot combine with "
                        f"non-zero-offset reads of the same dataset — split "
                        f"the loop")
                args.append(Arg(dat, sten, AccessMode.READ))
                args.append(Arg(dat, zero, AccessMode.WRITE))
        elif w:
            mode = AccessMode.INC if nm in inc else AccessMode.WRITE
            args.append(Arg(dat, zero, mode))
        else:
            args.append(Arg(dat, sten, AccessMode.READ))
    return tuple(args)


def validate_declared_args(
    kernel: Kernel,
    block: Block,
    range_: Tuple[Tuple[int, int], ...],
    declared: Sequence[Arg],
    reductions: Sequence[ReductionSpec] = (),
    loop_name: str = "?",
    extra_dats: Sequence[Dataset] = (),
) -> None:
    """Check hand-declared ``Arg`` lists against the kernel trace.

    Declared READ stencils must *cover* the traced offsets (wider is fine —
    structural-fidelity footprints are legitimate); declared writes must
    exactly match the names the kernel produces.  ``extra_dats`` are
    inference-covered datasets of a mixed-style loop: they participate in
    the trace's name resolution but their accesses are not checked here
    (inference derives them exactly).
    """
    by_name = {a.dat.name: a.dat for a in declared}
    declared_names = set(by_name)
    for d in extra_dats:
        by_name.setdefault(d.name, d)
    trace = trace_kernel(kernel, block, range_, by_name, reductions)
    problems: List[str] = []
    declared_reads: Dict[str, Set[Tuple[int, ...]]] = {}
    declared_writes: Set[str] = set()
    for a in declared:
        if a.mode.reads:
            declared_reads.setdefault(a.dat.name, set()).update(a.stencil.points)
        if a.mode.writes:
            declared_writes.add(a.dat.name)
    for nm, offs in trace.reads.items():
        if nm not in declared_names:
            continue  # inference-covered
        missing = set(offs) - declared_reads.get(nm, set())
        if missing:
            problems.append(
                f"read of {nm!r} at offsets {sorted(missing)} not covered by "
                f"declared stencil(s) {sorted(declared_reads.get(nm, set()))}")
    traced_writes = set(trace.writes) & declared_names
    if traced_writes != declared_writes:
        only_decl = declared_writes - traced_writes
        only_trace = traced_writes - declared_writes
        if only_decl:
            problems.append(f"declared writes never produced: {sorted(only_decl)}")
        if only_trace:
            problems.append(f"kernel writes undeclared dats: {sorted(only_trace)}")
    if problems:
        raise StencilValidationError(
            f"loop {loop_name!r}: " + "; ".join(problems))


# -- the session ------------------------------------------------------------------


class Session:
    """One lazy-execution context over a registry-selected backend.

    Construction::

        Session()                      # default out-of-core backend
        Session("reference")           # by backend name
        Session("ooc", hw="p100-nvlink", prefetch=True)   # name + overrides
        Session(ExecutionConfig(backend="sim", num_tiles=8))
        Session(backend=my_executor)   # power users: a ready run_chain object

    Loops record via :meth:`par_loop`; chains flush when data returns to user
    space (:meth:`fetch`, :meth:`reduction`), exactly as in OPS.
    """

    def __init__(self, config: Union[ExecutionConfig, str, None] = None, *,
                 backend=None, **overrides):
        if backend is not None:
            if config is not None or overrides:
                raise ValueError("pass either a config/name or a backend object")
            self.config: Optional[ExecutionConfig] = None
            self.backend = backend
        else:
            if isinstance(config, str):
                config = ExecutionConfig(backend=config, **overrides)
            elif config is None:
                config = ExecutionConfig(**overrides)
            elif overrides:
                config = replace(config, **overrides)
            self.config = config
            self.backend = make_backend(config)
        # Old name, kept so code written against Runtime keeps working.
        self.executor = self.backend
        self.queue: List[ParallelLoop] = []
        self._red_results: Dict[str, np.ndarray] = {}
        self.chains_flushed = 0
        # Every dataset any recorded loop has touched, by name — what
        # checkpoint()/restore() cover when no explicit list is given.
        self.datasets: Dict[str, Dataset] = {}
        # LRU-bounded like the executor's plan cache: kernels capturing a
        # per-step constant mint a new fingerprint every step.
        self._arg_cache: "OrderedDict[Tuple, Tuple[Arg, ...]]" = OrderedDict()
        self._max_arg_cache = 512
        self._closed = False

    # -- recording -------------------------------------------------------------
    def par_loop(
        self,
        name: str,
        block: Block,
        range_: Sequence[Tuple[int, int]],
        args: Sequence[Union[Arg, Dataset]],
        kernel: Kernel,
        reductions: Sequence[ReductionSpec] = (),
        *,
        inc: Sequence[str] = (),
        explicit_stencil: Optional[Dict[str, Stencil]] = None,
    ) -> None:
        """Record one parallel loop.

        ``args`` entries are either bare :class:`Dataset` handles — access
        modes and READ stencils are then *inferred* by tracing ``kernel`` —
        or fully-explicit :class:`Arg` declarations (the two styles mix).
        ``explicit_stencil={name: stencil}`` overrides the inferred READ
        stencil for that dataset; ``inc=[name]`` marks accumulating writes.
        """
        if self._closed:
            raise SessionClosedError(
                f"par_loop({name!r}) on a closed Session")
        range_t = tuple((int(a), int(b)) for a, b in range_)
        declared: List[Arg] = []
        inferred_dats: List[Dataset] = []
        for a in args:
            if isinstance(a, Arg):
                declared.append(a)
            elif isinstance(a, Dataset):
                inferred_dats.append(a)
            else:
                raise TypeError(
                    f"loop {name!r}: args entries must be Arg or Dataset, "
                    f"got {type(a).__name__}")
        validate = self.config is not None and self.config.validate_stencils
        kernel_fp = None
        if inferred_dats:
            kernel_fp = kernel_fingerprint(kernel)
            inferred = self._infer_cached(
                kernel_fp, block, range_t, inferred_dats, kernel,
                tuple(reductions), tuple(inc), explicit_stencil,
                tuple(declared))
            all_args = tuple(declared) + inferred
            if validate and declared:
                validate_declared_args(
                    kernel, block, range_t, declared, reductions, name,
                    extra_dats=inferred_dats)
        else:
            # inc/explicit_stencil only shape *inference* — with an all-Arg
            # loop they would be silently dropped, so reject them loudly.
            if inc or explicit_stencil:
                raise ValueError(
                    f"loop {name!r}: inc=/explicit_stencil= given but every "
                    f"args entry is an explicit Arg — nothing to infer")
            all_args = tuple(declared)
            if validate:
                validate_declared_args(
                    kernel, block, range_t, declared, reductions, name)
        lp = ParallelLoop(
            name=name, block=block, range_=range_t, args=all_args,
            kernel=kernel, reductions=tuple(reductions),
        )
        for a in all_args:
            self.datasets[a.dat.name] = a.dat
        if kernel_fp is not None:
            lp.__dict__["_kernel_fp"] = kernel_fp  # reused by plan_signature
        self.queue.append(lp)

    def _infer_cached(self, kernel_fp, block, range_t, dats, kernel,
                      reductions, inc, explicit_stencil, declared
                      ) -> Tuple[Arg, ...]:
        key = (
            kernel_fp,
            tuple((d.name, id(d), d.dtype.str) for d in dats),
            tuple((a.dat.name, id(a.dat), a.stencil.points, a.mode.value)
                  for a in declared),
            tuple((r.name, r.op) for r in reductions),
            inc,
            tuple(sorted((n, s.points) for n, s in (explicit_stencil or {}).items())),
        )
        cached = self._arg_cache.get(key)
        if cached is None:
            cached = infer_args(
                kernel, block, range_t, dats, reductions, inc,
                explicit_stencil, extra=declared)
            self._arg_cache[key] = cached
            if len(self._arg_cache) > self._max_arg_cache:
                self._arg_cache.popitem(last=False)
        else:
            self._arg_cache.move_to_end(key)
        return cached

    # -- the cyclic flag (paper §4.1) -------------------------------------------
    @property
    def cyclic(self) -> bool:
        cfg = getattr(self.backend, "cfg", None)
        return bool(cfg and cfg.cyclic)

    @cyclic.setter
    def cyclic(self, value: bool) -> None:
        cfg = getattr(self.backend, "cfg", None)
        if cfg is not None:
            cfg.cyclic = bool(value)

    # -- flushing ---------------------------------------------------------------
    def flush(self) -> None:
        """Execute every queued loop, splitting chains at block boundaries.

        Reduction results from *previous* flushes are dropped here: a
        reduction stays readable (any number of times) until the next flush
        that actually executes loops replaces it."""
        if not self.queue:
            return
        if self._closed:
            # Unreachable through the public API (par_loop refuses to record
            # after close), but a queue mutated by hand must not silently run
            # on a torn-down backend.
            raise SessionClosedError("flush() of queued loops on a closed Session")
        self._red_results.clear()
        queue, self.queue = self.queue, []
        chain: List[ParallelLoop] = []
        for lp in queue:
            if chain and lp.block is not chain[0].block:
                self._run(chain)
                chain = []
            chain.append(lp)
        if chain:
            self._run(chain)

    def _run(self, chain: List[ParallelLoop]) -> None:
        reds = self.backend.run_chain(chain)
        self._red_results.update(reds)
        self.chains_flushed += 1

    # -- data return (chain breakers) --------------------------------------------
    def fetch(self, dat: Dataset) -> np.ndarray:
        self.flush()
        return dat.interior().copy()

    def fetch_raw(self, dat: Dataset) -> np.ndarray:
        self.flush()
        return np.array(dat.materialize(), copy=True)

    def reduction(self, name: str) -> np.ndarray:
        """Flush and return reduction ``name``.  Results are *retained* until
        the next flush, so reading the same reduction twice is legal (it used
        to raise ``KeyError`` on the second read)."""
        self.flush()
        if name not in self._red_results:
            raise KeyError(f"no reduction {name!r} has been produced")
        return self._red_results[name]

    # -- plans: inspect before you execute -----------------------------------------
    def _planning_executor(self):
        """The OOC executor that builds Plan IRs for this session's backend."""
        from .executor import OutOfCoreExecutor, ResidentExecutor
        from .sharded import ShardedOutOfCoreExecutor

        be = self.backend
        if isinstance(be, (OutOfCoreExecutor, ShardedOutOfCoreExecutor)):
            return be
        if isinstance(be, ResidentExecutor):
            return be._inner
        raise ValueError(
            f"backend {type(be).__name__} does not build plans; use an "
            f"ooc/ooc-async/ooc-cyclic/ooc-sharded/sim/resident session")

    def plan(self, loops=None):
        """Lower the queued loops (or ``loops``) to their Plan IRs *without*
        executing anything — the queue is untouched.  Returns one
        :class:`~repro_torch.core.plan.Plan` per chain, in execution order,
        including the chains a MemoryError split would produce."""
        loops = list(self.queue) if loops is None else list(loops)
        if not loops:
            return []
        ex = self._planning_executor()
        plans = []
        chain: List[ParallelLoop] = []
        for lp in loops:
            if chain and lp.block is not chain[0].block:
                plans.extend(self._plan_split(ex, chain, frozenset()))
                chain = []
            chain.append(lp)
        if chain:
            plans.extend(self._plan_split(ex, chain, frozenset()))
        return plans

    def _plan_split(self, ex, loops, keep_live, warm=frozenset()):
        """Mirror ``run_chain``'s MemoryError chain splitting, plans only.
        Both take their halves from :func:`~repro_torch.core.dependency.
        split_chain`, which keeps the whole chain's read-first datasets live
        in both halves; the reference package's split does not, so split
        Cyclic plans differ from its plans on purpose (unsplit chains plan
        byte-equal).  Sharded backends plan per device (segments x shards,
        splitting each shard's segment the same way): their chain plans
        carry a tuple of device-annotated Plan IRs, flattened here."""
        try:
            ir = ex.plan_chain(loops, keep_live, warm=warm).ir
            return list(ir) if isinstance(ir, tuple) else [ir]
        except MemoryError:
            if len(loops) <= 1:
                raise
            (head, h_live, h_warm), (tail, t_live, t_warm) = split_chain(
                loops, keep_live, warm)
            return (self._plan_split(ex, head, h_live, h_warm)
                    + self._plan_split(ex, tail, t_live, t_warm))

    def verify(self, loops=None):
        """Statically verify the plans for the queued loops (or ``loops``)
        without executing anything.  Returns a
        :class:`~repro_torch.core.verify.VerifyResult` — every chain's stream
        is abstract-interpreted for residency/dirty-loss/halo soundness and
        transfer-lane ordering, and on a sharded session the per-device
        plans are cross-checked for exchange consistency.
        ``session.verify().ok`` is the machine-checkable answer to "will
        this step's plans corrupt data"."""
        from .verify import verify_plans

        return verify_plans(self.plan(loops))

    def explain(self, loops=None, *, verify: bool = False) -> str:
        """Human-readable per-tile op listing for the queued loops (or
        ``loops``): staging/compute/carry/download per tile with modelled
        bytes, op totals, and the ledger-modelled makespan per chain —
        the same text the reference prints for the same plans.  On a
        sharded session every device's stream is listed (with its halo ops
        and per-device makespan), followed by a mesh summary line.  With
        ``verify=True`` the static verifier's diagnostic summary is
        appended."""
        from .plan import format_plan

        plans = self.plan(loops)
        if not plans:
            return "(nothing queued: record loops before explain())"
        hw = self.config.hw if self.config is not None else getattr(
            getattr(self.backend, "cfg", None), "hw", None)
        from .interp import simulate_plan

        per_dev: Dict[int, float] = {}
        msgs = nbytes = 0
        blocks = []
        for i, p in enumerate(plans):
            title = (f"chain {i}/{len(plans)}"
                     + (f" · device {p.device}/{p.mesh_devices}"
                        if p.mesh_devices > 1 else ""))
            if p.mesh_devices > 1 and hw is not None:
                # Simulate once: the per-plan makespan line and the mesh
                # summary share the same result.
                res = simulate_plan(p, hw)
                bw = (p.loop_bytes / res.makespan / 1e9
                      if res.makespan else 0.0)
                blocks.append(
                    format_plan(p, None, title=title)
                    + f"\n  modelled makespan (device {p.device}, "
                    f"{hw.name}): {res.makespan * 1e3:.3f} ms"
                    f"  ({bw:.1f} GB/s avg)")
                per_dev[p.device] = per_dev.get(p.device, 0.0) + res.makespan
                tot = p.totals()
                msgs += tot["halo_messages"]
                nbytes += tot["halo_bytes"]
            else:
                blocks.append(format_plan(p, hw, title=title))
        if per_dev:
            devs = " ".join(f"d{d}={t * 1e3:.3f}ms"
                            for d, t in sorted(per_dev.items()))
            blocks.append(
                f"mesh summary: per-device makespans {devs}; critical "
                f"device {max(per_dev.values()) * 1e3:.3f} ms; halo "
                f"{msgs} msgs / {nbytes / 1e6:.3f} MB")
        if verify:
            from .verify import verify_plans

            blocks.append(verify_plans(plans).summary())
        return "\n\n".join(blocks)

    def tune(self, loops=None, *, apply: bool = False, repeats: int = 2,
             **grids):
        """Enumerate candidate configs (``num_tiles`` × ``tiled_dim`` ×
        ``num_slots`` × codec), cost each on the queued loops (or ``loops``)
        via the sim interpreter, and return the best as a
        :class:`~repro_torch.core.tune.TuneResult` — modelled makespan never
        worse than this session's config, which is always a candidate.  With
        ``apply=True`` the session's backend is rebuilt around the winner
        (the queue survives: loops reference datasets, not the backend).  A
        ``meshes=`` grid costs sharded candidates with their per-device
        streams and halo ops."""
        from .tune import tune_configs

        loops = list(self.queue) if loops is None else list(loops)
        if self.config is None:
            raise ValueError(
                "sessions over a hand-built backend object have no "
                "ExecutionConfig to tune")
        result = tune_configs(loops, self.config, repeats=repeats, **grids)
        if apply:
            old = getattr(self.backend, "close", None)
            if old is not None:
                old()
            self.config = result.best
            self.backend = make_backend(result.best)
            self.executor = self.backend
        return result

    # -- checkpoint / restart -----------------------------------------------------
    def checkpoint(self, path: str, datasets=None) -> Dict:
        """Write a restartable snapshot to ``path`` (atomic write-then-rename),
        in the reference package's npz + JSON manifest format.

        Flushes pending loops first, then captures every dataset this session
        has seen (or the explicit ``datasets``) — materialised home copies,
        versions — plus the plan-cache signature hashes for provenance.  A
        run killed after this call resumes bit-identically via
        :meth:`restore`.  Returns the manifest.

        App-level *scalars* (a CFL ``dt``, a step counter steering sweep
        direction) live outside the runtime; persist and restore those
        alongside the checkpoint yourself."""
        from .store import save_checkpoint

        self.flush()
        dats = list(datasets) if datasets is not None else list(
            self.datasets.values())
        # Sharded backends keep their plan caches on the per-device inner
        # executors — aggregate so multi-device checkpoints carry the same
        # plan-signature provenance as unsharded ones.
        plans = list(getattr(self.backend, "_plans", {}).values())
        for ex in getattr(self.backend, "inner", ()):
            plans.extend(getattr(ex, "_plans", {}).values())
        sigs = [cp.ir.sig_hash for cp in plans
                if getattr(cp, "ir", None) is not None]
        return save_checkpoint(path, dats,
                               chains_flushed=self.chains_flushed,
                               plan_signatures=sigs)

    def restore(self, path: str, datasets=None) -> Dict:
        """Load a :meth:`checkpoint` back into live datasets (matched by
        name; shapes/dtypes validated) and reset device-side data caches so
        nothing stale survives from before the snapshot: pinned device
        copies and prefetch captures are dropped.  In a fresh process the
        session has not seen any loops yet — pass the new app's datasets
        explicitly.  Pending queued loops are dropped (they reference
        pre-restore state).  Returns the manifest."""
        from .store import load_checkpoint

        dats = list(datasets) if datasets is not None else list(
            self.datasets.values())
        manifest = load_checkpoint(path, dats)
        for d in dats:
            self.datasets[d.name] = d
        self.queue.clear()
        self._red_results.clear()
        reset = getattr(self.backend, "reset_data_caches", None)
        if reset is not None:
            reset()
        return manifest

    # -- introspection -----------------------------------------------------------
    @property
    def history(self):
        """Per-chain :class:`ChainStats` from the backend (empty if eager)."""
        return getattr(self.backend, "history", [])

    def plan_stats(self) -> Dict[str, float]:
        """Chain-plan cache counters (zeros for backends that don't plan)."""
        hits = getattr(self.backend, "plan_hits", 0)
        misses = getattr(self.backend, "plan_misses", 0)
        tot = hits + misses
        return {
            "plan_hits": hits,
            "plan_misses": misses,
            "plan_hit_rate": hits / tot if tot else 0.0,
            "plan_time_s": getattr(self.backend, "plan_time_s", 0.0),
        }

    def close(self) -> None:
        """Flush pending loops, release backend resources (the threaded
        transfer engine's worker threads, for ``ooc``-family backends), then
        flush and close the homes this session has seen (a no-op for RAM
        homes; ``mmap``/``chunked`` data stays on disk and readable).
        Idempotent: the second and later calls are no-ops."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        fn = getattr(self.backend, "close", None)
        if fn is not None:
            fn()
        for dat in self.datasets.values():
            dat.close()

    # -- context manager: worker threads must not outlive the with-block ------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # The body died mid-recording: executing a half-recorded queue
            # during unwinding would mutate dataset homes the user never
            # asked for (and could mask the original exception).  Drop the
            # queue, release backend resources, let the exception propagate.
            self.queue.clear()
            if not self._closed:
                self._closed = True
                fn = getattr(self.backend, "close", None)
                if fn is not None:
                    fn()
            return
        self.close()

    def trace(self):
        """The observability spine's span buffer (:class:`repro_torch.obs.Tracer`)
        when this session was built with ``trace=``, else ``None``.  Use
        ``trace().save(path)`` for a Perfetto-viewable Chrome trace, or feed
        it with a backend ledger to :func:`repro_torch.obs.audit.compare`."""
        tr = getattr(self.backend, "tracer", None)
        if tr is not None and getattr(tr, "enabled", False):
            return tr
        return None

    def transfer_stats(self) -> Dict[str, float]:
        """Transfer-subsystem counters: raw vs post-codec wire bytes, the
        achieved compression ratio, queue-wait time, and per-lane queue-wait
        / service-time histograms under ``"lanes"`` (zeros/defaults for
        backends without a transfer engine)."""
        fn = getattr(self.backend, "transfer_stats", None)
        if fn is not None:
            return fn()
        return {
            "mode": "none", "bytes_up_raw": 0, "bytes_down_raw": 0,
            "bytes_up_wire": 0, "bytes_down_wire": 0, "bytes_moved_wire": 0,
            "compression_ratio": 1.0, "queue_wait_s": 0.0,
            "elided_rows": 0, "evictions": 0, "pinned_hits": 0,
            "bytes_disk_read": 0, "bytes_disk_written": 0,
            "halo_messages": 0, "halo_bytes": 0, "lanes": {},
        }


# ``StencilProgram`` is the declarative-frontend name from the redesign;
# ``Session`` emphasises the execution-context role.  Same object.
StencilProgram = Session
