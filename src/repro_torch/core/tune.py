"""Sim-driven autotuning over the Plan IR.

The planner made execution configuration an explicit, costable object: every
candidate ``ExecutionConfig`` lowers to an instruction stream whose modelled
makespan the ledger interpreter computes without touching real data.  The
tuner enumerates candidates over ``num_tiles`` × ``tiled_dim`` ×
``num_slots`` × codec, costs each by interpreting the recorded chains in a
throwaway ``simulate_only`` executor (so pinned caching, prefetch guessing
and chain splitting all behave exactly as they would for real), and returns
the best config.  The base config is always a candidate, so the winner's
modelled makespan is never worse than the default's.

Lossy codecs (``fp16``/``bf16``) change results, not just traffic, so they
are only enumerated with ``allow_lossy=True``; the achieved ratio of the
lossless ``shuffle-rle`` codec is data-dependent (nominal 1.0), which the
byte-level model cannot see — pick it from a real :func:`transfer_bench`
measurement instead.

Ported from ``src/repro/core/tune.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

from .loop import ParallelLoop

_SIM_EXCLUDED = {"reference", "pallas"}   # backends with no planner to tune


@dataclass
class TuneResult:
    """Outcome of one tuning sweep (``rows`` holds every candidate tried)."""

    best: "ExecutionConfig"              # noqa: F821 - see repro_torch.core.program
    best_makespan: float                 # modelled seconds, all chains
    baseline_makespan: float             # the base config's modelled seconds
    rows: List[Dict]

    @property
    def speedup(self) -> float:
        """Modelled baseline/best ratio (1.0 = the default already wins)."""
        return (self.baseline_makespan / self.best_makespan
                if self.best_makespan else 1.0)

    def summary(self) -> str:
        b = self.best
        feas = sum(1 for r in self.rows if r["feasible"])
        mesh = getattr(b, "mesh", None)
        return (
            f"tune: {len(self.rows)} candidates ({feas} feasible); best "
            f"num_tiles={b.num_tiles} tiled_dim={b.tiled_dim} "
            f"num_slots={b.num_slots} codec={b.codec!r}"
            + (f" mesh={mesh.spec}" if mesh is not None else "") + ": "
            f"{self.best_makespan * 1e3:.3f} ms modelled vs baseline "
            f"{self.baseline_makespan * 1e3:.3f} ms ({self.speedup:.2f}x)")


def split_chains(loops: Sequence[ParallelLoop]) -> List[List[ParallelLoop]]:
    """Chain boundaries exactly as ``Session.flush`` draws them (per block)."""
    chains: List[List[ParallelLoop]] = []
    cur: List[ParallelLoop] = []
    for lp in loops:
        if cur and lp.block is not cur[0].block:
            chains.append(cur)
            cur = []
        cur.append(lp)
    if cur:
        chains.append(cur)
    return chains


def make_sim_executor(config, *, shared_plans=None):
    """A throwaway ledger-only executor for ``config`` — sharded when the
    config carries a multi-device mesh, so the tuner's shard-count
    candidates are costed with their per-device streams and halo ops.
    Delegates to the backend registry's factory so the tuner can never cost
    a different executor shape than ``make_backend`` would construct.
    ``shared_plans`` lets the serving layer's admission oracle plan through
    (and feed) the cross-tenant cache, so admission checks are cheap for
    chains the server has already planned."""
    from .backends import _ooc_executor

    return _ooc_executor(config, shared_plans=shared_plans,
                         simulate_only=True, transfer="sync")


def modelled_makespan(config, chains: Sequence[Sequence[ParallelLoop]],
                      repeats: int = 1) -> float:
    """Total modelled seconds for ``chains`` under ``config`` (sim only).

    ``repeats`` replays the chain sequence (cyclic apps): steady-state
    effects — pinned-cache hits, speculative-prefetch hits — only appear
    from the second pass on, so tuning for a long run should cost more than
    one.  Raises ``MemoryError`` only if a single loop cannot fit (the
    executor splits chains exactly as a real run would)."""
    ex = make_sim_executor(config)
    for _ in range(max(1, repeats)):
        for chain in chains:
            ex.run_chain(list(chain))
    return sum(c.modelled_s for c in ex.history)


def candidate_configs(
    base,
    ndim: int,
    num_tiles: Optional[Sequence[Optional[int]]] = None,
    num_slots: Optional[Sequence[int]] = None,
    tiled_dims: Optional[Sequence[int]] = None,
    codecs: Optional[Sequence] = None,
    allow_lossy: bool = False,
    meshes: Optional[Sequence] = None,
) -> List:
    """The candidate grid, base config first (ties resolve to the default).

    ``meshes`` (optional) enumerates device-mesh shard counts — entries are
    anything :func:`repro_torch.core.mesh.parse_mesh` accepts (ints, "sim:N",
    DeviceMesh); the base config's mesh stays the first candidate."""
    from .mesh import parse_mesh

    if num_tiles is None:
        num_tiles = (None, 2, 4, 8, 16, 32)
    if num_slots is None:
        num_slots = (2, 3)
    if tiled_dims is None:
        tiled_dims = tuple(range(ndim))
    if codecs is None:
        codecs = ("identity",) + (("fp16", "bf16") if allow_lossy else ())
    nt = list(dict.fromkeys([base.num_tiles, *num_tiles]))
    ns = list(dict.fromkeys([base.num_slots, *num_slots]))
    td = [d for d in dict.fromkeys([base.tiled_dim, *tiled_dims])
          if 0 <= d < ndim]
    base_codec = base.codec if isinstance(base.codec, str) else None
    cs = list(dict.fromkeys(([base_codec] if base_codec else []) + list(codecs)))
    if not isinstance(base.codec, str):
        cs.insert(0, base.codec)   # per-dat dict spec: keep as-is candidate
    # A 1-device mesh builds the identical unsharded executor as mesh=None
    # (_ooc_executor only shards when num_devices > 1) — canonicalise so the
    # grid doesn't cost the same candidate twice.
    def canon(m):
        m = parse_mesh(m)
        return None if m is not None and m.num_devices == 1 else m

    ms = list(dict.fromkeys(
        [canon(getattr(base, "mesh", None))]
        + [canon(m) for m in (meshes or ())]))
    out = []
    seen = set()
    for t in nt:
        for s in ns:
            for d in td:
                for c in cs:
                    for m in ms:
                        key = (t, s, d, c if isinstance(c, str)
                               else tuple(sorted(c.items())), m)
                        if key in seen:
                            continue
                        seen.add(key)
                        out.append(replace(base, num_tiles=t, num_slots=s,
                                           tiled_dim=d, codec=c, mesh=m))
    return out


def tune_configs(
    loops: Sequence[ParallelLoop],
    base,
    *,
    num_tiles: Optional[Sequence[Optional[int]]] = None,
    num_slots: Optional[Sequence[int]] = None,
    tiled_dims: Optional[Sequence[int]] = None,
    codecs: Optional[Sequence] = None,
    allow_lossy: bool = False,
    meshes: Optional[Sequence] = None,
    repeats: int = 2,
) -> TuneResult:
    """Cost every candidate config on ``loops`` via the sim interpreter and
    return the best (modelled makespan, infeasible candidates excluded).
    ``meshes=[1, 2, 4]`` additionally enumerates device-mesh shard counts
    (costed per device, halo exchanges included)."""
    if not loops:
        raise ValueError("nothing to tune: record loops first")
    if base.backend in _SIM_EXCLUDED:
        raise ValueError(
            f"backend {base.backend!r} has no planner to tune; use an "
            f"ooc/ooc-async/sim session")
    chains = split_chains(loops)
    ndim = loops[0].block.ndim
    cands = candidate_configs(base, ndim, num_tiles, num_slots, tiled_dims,
                              codecs, allow_lossy, meshes)
    rows: List[Dict] = []
    best_cfg = None
    best_t = float("inf")
    baseline_t = float("inf")
    from .mesh import MeshError

    for i, cand in enumerate(cands):
        try:
            t = modelled_makespan(cand, chains, repeats=repeats)
            feasible = True
        except (MemoryError, MeshError):
            # MemoryError: no tile count fits fast memory.  MeshError: the
            # grid cannot be decomposed that way (too many devices, skirt
            # exceeding the shard width).
            t = float("inf")
            feasible = False
        rows.append({
            "num_tiles": cand.num_tiles, "num_slots": cand.num_slots,
            "tiled_dim": cand.tiled_dim,
            "codec": (cand.codec if isinstance(cand.codec, str)
                      else dict(cand.codec)),
            "mesh": cand.mesh.spec if getattr(cand, "mesh", None) else None,
            # None, not inf: rows land in JSON reports and bare Infinity
            # is not valid strict JSON.
            "modelled_s": t if feasible else None, "feasible": feasible,
        })
        if i == 0:
            baseline_t = t
        if feasible and t < best_t:
            best_cfg = cand
            best_t = t
    if best_cfg is None:
        raise MemoryError("no candidate configuration fits fast memory")
    return TuneResult(best=best_cfg, best_makespan=best_t,
                      baseline_makespan=baseline_t, rows=rows)
