"""Plan fuzzer: mutate valid plans, assert the verifier flags every one.

The verifier (:mod:`repro_torch.core.verify`) is only a safety net if it has no
false negatives over the corruption classes it claims to catch.  This
module enumerates *targeted* mutations of a valid plan — drop an op,
shrink a staging interval, reorder a dependency, skew a slot assignment,
misdeclare the §4.1 contract — each gated by an applicability predicate
strong enough to *guarantee* the mutant is unsound.  Every
:class:`Mutation` records the diagnostic categories the verifier must
emit (`expect`) and at what severity, so a test can assert zero false
negatives mechanically:

    for m in enumerate_mutations(plan):
        result = verify_plan(m.plan)
        assert any(d.category in m.expect for d in result.diagnostics)

With `hypothesis` installed, tests additionally sample random mutation
*pairs* and assert the verifier still fires (mutations only add
corruption, never cancel); without it, a fixed-seed subset runs.

Copied from ``src/repro/core/fuzz.py`` with its imports rewired to
``repro_torch``; it imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .plan import (
    CarryEdge,
    Compute,
    Download,
    Elide,
    FetchHome,
    HaloExchange,
    HaloUnpack,
    Plan,
    PlanOp,
    SpillHome,
    Upload,
)
from .verify import ERROR, WARN, Ivs, _add, _inter, _sub


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One corrupted variant of a valid plan.

    ``expect`` lists diagnostic categories, *any one* of which counts as
    the verifier catching this mutant; ``severity`` is the minimum
    severity the finding must carry."""

    name: str
    plan: Plan
    expect: Tuple[str, ...]
    severity: str = ERROR

    def caught_by(self, diagnostics: Tuple) -> bool:
        sev_ok = (ERROR,) if self.severity == ERROR else (ERROR, WARN)
        return any(d.category in self.expect and d.severity in sev_ok
                   for d in diagnostics)


def _with_ops(plan: Plan, ops: List[PlanOp]) -> Plan:
    return dataclasses.replace(plan, ops=tuple(ops))


def _drop(plan: Plan, idx: int) -> Plan:
    return _with_ops(plan, [op for i, op in enumerate(plan.ops) if i != idx])


def _tile_writes(plan: Plan, tile: int, name: str) -> Ivs:
    """Rows of ``name`` written by ``tile``'s compute (dirty in its slot)."""
    out: Ivs = ()
    for op in plan.ops:
        if isinstance(op, Compute) and op.tile == tile:
            for wname, rows in op.writes:
                if wname == name:
                    for lo, hi in rows:
                        out = _add(out, lo, hi)
    return out


def _tile_retired_elsewhere(plan: Plan, tile: int, name: str) -> Ivs:
    """Rows of ``name`` that leave ``tile``'s slot by carry or elision —
    dropping the tile's download cannot orphan these."""
    out: Ivs = ()
    for op in plan.ops:
        if isinstance(op, CarryEdge) and op.tile == tile:
            for iname, lo, hi in op.items:
                if iname == name:
                    out = _add(out, lo, hi)
        elif isinstance(op, Elide) and op.tile == tile:
            for iname, lo, hi in op.items:
                if iname == name:
                    out = _add(out, lo, hi)
    return out


def _carried_into(plan: Plan, tile: int, name: str) -> Ivs:
    """Rows of ``name`` carried INTO ``tile``'s slot (from tile-1)."""
    out: Ivs = ()
    for op in plan.ops:
        if isinstance(op, CarryEdge) and op.tile == tile - 1:
            for iname, lo, hi in op.items:
                if iname == name:
                    out = _add(out, lo, hi)
    return out


def enumerate_mutations(plan: Plan) -> List[Mutation]:
    """Every targeted corruption of ``plan`` whose detection is guaranteed.

    Mutation classes (drop an op, shrink an interval, reorder a dep, plus
    the slot/contract skews the mesh redesign's hazards suggest):

    * drop a tile's Upload / Compute            -> ``missing-op``
    * drop a Download owing dirty rows          -> ``dirty-loss``
    * drop an Elide (its rows stay dirty)       -> ``dirty-loss``
    * drop a CarryEdge (edge rows orphaned)     -> ``dirty-loss`` or
      ``uninit-download`` in the next tile
    * shrink a Download interval by one row     -> ``dirty-loss``
    * shrink an Upload interval by one row      -> ``uninit-download``
    * move a Download before its Compute        -> ``missing-dep``
    * swap HaloExchange and HaloUnpack          -> ``halo-order``
    * skew an Upload's slot by one              -> ``slot-conflict``
    * clear ``cyclic`` while Elides remain      -> ``illegal-elide``
    * add an elided dataset to ``keep_live``    -> ``illegal-elide``
      (the mesh redesign's stale cross-segment elision)
    * shrink HaloExchange depth below the skirt -> ``halo-depth``
    * drop HaloUnpack / FetchHome / SpillHome   -> warn-severity
      ``unreachable-handle`` / ``disk-unfetched`` / ``disk-unspilled``
    """
    muts: List[Mutation] = []
    ops = plan.ops
    ns = max(1, plan.num_slots)

    for idx, op in enumerate(ops):
        if isinstance(op, Upload):
            t = op.tile
            muts.append(Mutation(
                name=f"drop-upload[{idx}]", plan=_drop(plan, idx),
                expect=("missing-op",)))
            if ns > 1:
                skew = dataclasses.replace(op, slot=(op.slot + 1) % ns)
                muts.append(Mutation(
                    name=f"skew-upload-slot[{idx}]",
                    plan=_with_ops(plan, [skew if i == idx else o
                                          for i, o in enumerate(ops)]),
                    expect=("slot-conflict",)))
            # Shrink: a staged row the download ships but nothing writes.
            for j, (name, lo, hi) in enumerate(op.items):
                if hi - lo < 2:
                    continue
                row = (hi - 1, hi)
                dl = next((d for d in ops if isinstance(d, Download)
                           and d.tile == t), None)
                if dl is None or not any(
                        n == name and _inter(((dlo, dhi),), *row)
                        for n, dlo, dhi in dl.items):
                    continue
                if _inter(_tile_writes(plan, t, name), *row):
                    continue
                if _inter(_carried_into(plan, t, name), *row):
                    continue
                items = list(op.items)
                items[j] = (name, lo, hi - 1)
                new = dataclasses.replace(op, items=tuple(items))
                muts.append(Mutation(
                    name=f"shrink-upload[{idx}].{name}",
                    plan=_with_ops(plan, [new if i == idx else o
                                          for i, o in enumerate(ops)]),
                    expect=("uninit-download",)))
                break
        elif isinstance(op, Compute):
            muts.append(Mutation(
                name=f"drop-compute[{idx}]", plan=_drop(plan, idx),
                expect=("missing-op",)))
        elif isinstance(op, Download):
            t = op.tile
            owed = False
            for name, lo, hi in op.items:
                # Rows this download retires that nothing else retires:
                # tile-written, minus carried/elided away.
                left = _inter(_tile_writes(plan, t, name), lo, hi)
                for elo, ehi in _tile_retired_elsewhere(plan, t, name):
                    left = _sub(left, elo, ehi)
                if not left:
                    continue
                owed = True
                # Shrink by one row, only when the dropped row is owed
                # (the last row of the item must sit in the owed region).
                _rlo, rhi = left[-1]
                for j, (iname, ilo, ihi) in enumerate(op.items):
                    if iname == name and ihi == rhi and ihi - ilo >= 2:
                        items = list(op.items)
                        items[j] = (iname, ilo, ihi - 1)
                        new = dataclasses.replace(op, items=tuple(items))
                        muts.append(Mutation(
                            name=f"shrink-download[{idx}].{name}",
                            plan=_with_ops(plan,
                                           [new if i == idx else o
                                            for i, o in enumerate(ops)]),
                            expect=("dirty-loss",)))
                        break
            if owed:
                muts.append(Mutation(
                    name=f"drop-download[{idx}]", plan=_drop(plan, idx),
                    expect=("dirty-loss",)))
            # Reorder: hoist the download above its tile's compute.
            cm_idx = next((i for i, o in enumerate(ops)
                           if isinstance(o, Compute) and o.tile == t), None)
            if cm_idx is not None and cm_idx < idx:
                moved = [o for i, o in enumerate(ops) if i != idx]
                moved.insert(cm_idx, op)
                muts.append(Mutation(
                    name=f"hoist-download[{idx}]",
                    plan=_with_ops(plan, moved),
                    expect=("missing-dep",)))
        elif isinstance(op, CarryEdge):
            # A carry of purely read-only skew edge rows (the consumer's
            # *reads* are not in the IR) is undetectable if the next tile's
            # download doesn't need them; only emit the mutant when its
            # detection is guaranteed.
            if op.items and _carry_drop_detectable(plan, op):
                muts.append(Mutation(
                    name=f"drop-carry[{idx}]", plan=_drop(plan, idx),
                    expect=("dirty-loss", "uninit-download", "uninit-read")))
        elif isinstance(op, Elide):
            if op.items:
                muts.append(Mutation(
                    name=f"drop-elide[{idx}]", plan=_drop(plan, idx),
                    expect=("dirty-loss",)))
        elif isinstance(op, HaloExchange):
            up_idx = next((i for i, o in enumerate(ops)
                           if isinstance(o, HaloUnpack)), None)
            if up_idx is not None and up_idx > idx:
                swapped = list(ops)
                swapped[idx], swapped[up_idx] = swapped[up_idx], swapped[idx]
                muts.append(Mutation(
                    name=f"swap-exchange-unpack[{idx}]",
                    plan=_with_ops(plan, swapped),
                    expect=("halo-order",)))
            reach = _skirt_reach(plan)
            if plan.device > 0 and plan.mesh_devices > 1 and reach > 0 \
                    and op.depth >= reach:
                shallow = dataclasses.replace(op, depth=reach - 1)
                muts.append(Mutation(
                    name=f"shrink-halo-depth[{idx}]",
                    plan=_with_ops(plan, [shallow if i == idx else o
                                          for i, o in enumerate(ops)]),
                    expect=("halo-depth",)))
        elif isinstance(op, HaloUnpack):
            muts.append(Mutation(
                name=f"drop-unpack[{idx}]", plan=_drop(plan, idx),
                expect=("unreachable-handle",), severity=WARN))
        elif isinstance(op, FetchHome):
            if plan.spill_home and op.items:
                muts.append(Mutation(
                    name=f"drop-fetch[{idx}]", plan=_drop(plan, idx),
                    expect=("disk-unfetched",), severity=WARN))
        elif isinstance(op, SpillHome):
            muts.append(Mutation(
                name=f"drop-spill[{idx}]", plan=_drop(plan, idx),
                expect=("disk-unspilled",), severity=WARN))

    # Contract skews (plan-level, not per-op).
    if any(isinstance(o, Elide) and o.items for o in ops):
        if plan.cyclic:
            muts.append(Mutation(
                name="clear-cyclic", plan=dataclasses.replace(
                    plan, cyclic=False),
                expect=("illegal-elide",)))
        elided = next(name for o in ops if isinstance(o, Elide)
                      for name, _lo, _hi in o.items)
        if elided not in plan.keep_live:
            muts.append(Mutation(
                name=f"keep-live-elided[{elided}]",
                plan=dataclasses.replace(
                    plan, keep_live=tuple(plan.keep_live) + (elided,)),
                expect=("illegal-elide",)))
    return muts


def _carry_drop_detectable(plan: Plan, carry: CarryEdge) -> bool:
    """True when removing ``carry`` must trip the verifier: either it moves
    dirty rows nothing else retires from the source slot, or the next
    tile's download ships rows only the carry makes valid."""
    t = carry.tile
    dl_t = next((o for o in plan.ops if isinstance(o, Download)
                 and o.tile == t), None)
    dl_n = next((o for o in plan.ops if isinstance(o, Download)
                 and o.tile == t + 1), None)
    up_n = next((o for o in plan.ops if isinstance(o, Upload)
                 and o.tile == t + 1), None)
    for name, lo, hi in carry.items:
        # (a) orphaned dirty rows in the source slot.
        dirty = _inter(_tile_writes(plan, t, name), lo, hi)
        if dl_t is not None:
            for n, dlo, dhi in dl_t.items:
                if n == name:
                    dirty = _sub(dirty, dlo, dhi)
        for o in plan.ops:
            if isinstance(o, Elide) and o.tile == t:
                for n, elo, ehi in o.items:
                    if n == name:
                        dirty = _sub(dirty, elo, ehi)
        if dirty:
            return True
        # (b) next tile's download needs rows only this carry provides.
        if dl_n is None:
            continue
        need: Ivs = ()
        for n, dlo, dhi in dl_n.items:
            if n == name:
                for ilo, ihi in _inter(((lo, hi),), dlo, dhi):
                    need = _add(need, ilo, ihi)
        if up_n is not None:
            for n, ulo, uhi in up_n.items:
                if n == name:
                    need = _sub(need, ulo, uhi)
        for wlo, whi in _tile_writes(plan, t + 1, name):
            need = _sub(need, wlo, whi)
        if need:
            return True
    return False


def _skirt_reach(plan: Plan) -> int:
    """Deepest row below the shard origin the stream touches."""
    lo_min = 0
    for op in plan.ops:
        if isinstance(op, Upload):
            for _name, lo, _hi in op.items:
                lo_min = min(lo_min, lo)
        elif isinstance(op, Compute):
            for _name, rows in op.writes:
                for lo, _hi in rows:
                    lo_min = min(lo_min, lo)
    return -lo_min


def check_mutations(plan: Plan,
                    mutations: Optional[List[Mutation]] = None
                    ) -> Dict[str, bool]:
    """Run the verifier over every mutation; map mutation name -> caught.

    A value of ``False`` anywhere is a verifier false negative."""
    from .verify import verify_plan

    result: Dict[str, bool] = {}
    for m in (enumerate_mutations(plan) if mutations is None else mutations):
        r = verify_plan(m.plan)
        result[m.name] = m.caught_by(r.diagnostics)
    return result
