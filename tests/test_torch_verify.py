"""The port's plan tools (``repro_torch.core.{verify,fuzz,tune}``) against
the JAX package's.

Every app plan at ``tests/test_verify.py``'s sizes (CloverLeaf 2D/3D and
OpenSBLI, ram and spill tiers, no mesh and ``sim:4``) is byte-equal between
the packages
and gets the same diagnostics from both verifiers, clean and under every
fuzzer mutation.  The port's split Cyclic plans, which differ from the JAX
package's on purpose (``repro_torch/core/dependency.py::split_chain``), verify
clean; the fuzzer misses nothing on the port's plans; the tuner picks the
JAX package's winner with equal modelled makespans; ``debug=True`` runs
clean plans and rejects a corrupt one.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402

APPS = {"cloverleaf2d": lambda A: A.CloverLeaf2D(48, 32),
        "cloverleaf3d": lambda A: A.CloverLeaf3D(16, 48, 10),
        "opensbli": lambda A: A.OpenSBLI(24)}


def _kw(pkg):
    return {"device": "cpu"} if pkg is T else {}


def _app_plans(pkg, apps, app_name, tier, mesh=None):
    """``tests/test_verify.py::_app_plans``, on the ``p100-pcie`` model in
    both packages."""
    app = APPS[app_name](apps)
    kw = {"num_tiles": 4, **_kw(pkg)}
    if mesh:
        kw["mesh"] = mesh
    if tier == "spill":
        kw["hw"] = pkg.P100_PCIE.with_(host_capacity=app.total_bytes() * 0.4)
    else:
        kw["hw"] = pkg.P100_PCIE
        kw["capacity_bytes"] = float("inf")
    sess = pkg.Session("sim", **kw)
    app.record_init(sess)
    sess.queue.clear()
    app.dt = 1e-4
    app.record_timestep(sess)
    return sess.plan()


def _diags(result):
    return [(d.severity, d.category, d.op_index, d.message, d.dataset,
             d.interval, d.plan_index) for d in result.diagnostics]


@pytest.fixture(scope="module",
                params=[(a, t, m) for a in APPS for t in ("ram", "spill")
                        for m in (None, "sim:4")],
                ids=lambda p: f"{p[0]}-{p[1]}" + (f"-{p[2]}" if p[2] else ""))
def app_plans(request):
    app_name, tier, mesh = request.param
    return (T.plans_to_json(_app_plans(T, TA, app_name, tier, mesh)),
            J.plans_to_json(_app_plans(J, JA, app_name, tier, mesh)), tier, mesh)


def test_app_plans_verify_clean_and_equal_jax(app_plans):
    port_json, jax_json, tier, mesh = app_plans
    assert port_json == jax_json          # unsplit chains plan byte-equal
    port = T.verify_plans(T.plans_from_json(port_json))
    ref = J.verify_plans(J.plans_from_json(port_json))
    assert port.ok and not port.warnings, port.summary()
    assert _diags(port) == _diags(ref)
    assert port.summary() == ref.summary()
    plans = T.plans_from_json(port_json)
    # A sim:4 shard's homes are a quarter of the app's: under the spill
    # tier's host budget (0.4 of the homes), so only unsharded plans spill.
    assert all(p.spill_home for p in plans) is (tier == "spill" and not mesh)
    assert all(p.mesh_devices == (4 if mesh else 1) for p in plans)


def test_mutant_diagnostics_equal_jax(app_plans):
    """Every fuzzer mutation of the plan, exported as JSON, gets the same
    diagnostics from both verifiers (and is flagged by both)."""
    port_json = app_plans[0]
    n = 0
    for p in T.plans_from_json(port_json):
        for m in T.enumerate_mutations(p):
            doc = T.plans_to_json([m.plan])
            port = T.verify_plans(T.plans_from_json(doc))
            ref = J.verify_plans(J.plans_from_json(doc))
            assert _diags(port) == _diags(ref), m.name
            n += 1
    assert n > 20


# -- the port's split Cyclic plans (fault C1's fix) ----------------------------------


def _split_plans(pkg, apps):
    """CloverLeaf 2D at a third of its homes with Cyclic on: the timestep
    chain splits on MemoryError (fault C1's setting)."""
    app = apps.CloverLeaf2D(40, 32, summary_every=0)
    sess = pkg.Session("sim", hw=pkg.P100_PCIE, prefetch=True,
                       capacity_bytes=app.total_bytes() / 3, **_kw(pkg))
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    app.dt = 1e-4
    app.record_timestep(sess)
    return sess.plan()


@pytest.fixture(scope="module")
def split_plans():
    return _split_plans(T, TA), _split_plans(J, JA)


def test_port_split_cyclic_plans_verify_clean(split_plans):
    port, ref = split_plans
    assert len(port) > 1 and any(p.cyclic for p in port)
    assert T.plans_to_json(port) != J.plans_to_json(ref)   # on purpose (C1)
    r = T.verify_plans(port)
    assert r.ok and not r.warnings, r.summary()


def test_c1_reference_split_plan_is_invisible_to_the_verifier(split_plans):
    """The JAX package's own split Cyclic plan loses state (ROADMAP C1), yet
    both verifiers pass it: each plan is verified on its own, and the lost
    download is sound within the head's plan — the tail reads what the
    head elided, which no single plan shows.  Recorded, not repaired: a
    verifier that saw it would need the chain set's cross-plan liveness."""
    _, ref = split_plans
    doc = J.plans_to_json(ref)
    port = T.verify_plans(T.plans_from_json(doc))
    assert port.ok and not port.warnings
    assert _diags(port) == _diags(J.verify_plans(ref))


# -- the fuzzer -------------------------------------------------------------------------


def _record_heat(pkg, sess, n=40, m=24, steps=2):
    """``tests/test_plan.py::heat_loops`` in either package (the kernels are
    plain arithmetic, so one lambda serves jnp arrays and torch tensors)."""
    blk = pkg.Block("grid", (n, m))
    rng = np.random.RandomState(7)
    u = pkg.make_dataset(blk, "u", halo=1, init=rng.rand(n, m).astype(np.float32))
    tmp = pkg.make_dataset(blk, "tmp", halo=1)
    S, Z = pkg.star_stencil(2, 1), pkg.point_stencil(2)
    interior = ((1, n - 1), (1, m - 1))
    for s in range(steps):
        sess.par_loop(
            f"avg{s}", blk, interior, [pkg.Arg(u, S, pkg.READ), pkg.Arg(tmp, Z, pkg.WRITE)],
            lambda acc: {"tmp": 0.25 * (acc("u", (1, 0)) + acc("u", (-1, 0))
                                        + acc("u", (0, 1)) + acc("u", (0, -1)))})
        sess.par_loop(
            f"copy{s}", blk, interior, [pkg.Arg(tmp, Z, pkg.READ), pkg.Arg(u, Z, pkg.RW)],
            lambda acc: {"u": acc("tmp")})
    return u


def _heat_plans(**kw):
    sess = T.Session("sim", device="cpu", capacity_bytes=float("inf"), **kw)
    _record_heat(T, sess)
    return sess.plan()


def test_fuzzer_misses_nothing_on_port_plans(split_plans):
    corpus = {
        "heat-cyclic": _heat_plans(num_tiles=4, cyclic=True, prefetch=True),
        "heat-1slot": _heat_plans(num_tiles=3, num_slots=1),
        "cl2d-spill": _app_plans(T, TA, "cloverleaf2d", "spill"),
        "cl2d-split-cyclic": split_plans[0],
    }
    total, missed, cats = 0, [], set()
    for tag, plans in corpus.items():
        for p in plans:
            res = T.check_mutations(p)
            total += len(res)
            missed += [f"{tag}:{k}" for k, v in res.items() if not v]
            for m in T.enumerate_mutations(p):
                cats.update(m.expect)
    assert total > 500
    assert not missed, f"verifier missed {len(missed)}: {missed[:10]}"
    assert {"missing-op", "dirty-loss", "uninit-download", "missing-dep",
            "slot-conflict", "illegal-elide", "disk-unfetched",
            "disk-unspilled"} <= cats


# -- the tuner ---------------------------------------------------------------------------


def _tune(pkg, **grids):
    """A transfer-bound heat session at a quarter of its homes (so some
    candidates do not fit), tuned on the sim interpreter."""
    hw = pkg.P100_PCIE.with_(link_latency=1e-6, up_bw=2e9, down_bw=2e9)
    sess = pkg.Session("sim", hw=hw, num_tiles=None,
                       capacity_bytes=2 * 130 * 66 * 4 / 4, **_kw(pkg))
    _record_heat(pkg, sess, n=128, m=64, steps=3)
    return sess, sess.tune(**grids)


def test_tune_picks_the_jax_winner():
    """The default grid: the same winner, the same modelled makespan and
    feasibility for every candidate."""
    _, want = _tune(J)
    with reference_tiles():   # the JAX package's tile counts
        sess, got = _tune(T)
    pick = lambda r: (r.best.num_tiles, r.best.num_slots, r.best.tiled_dim,  # noqa: E731
                      r.best.codec)
    assert pick(got) == pick(want)
    assert got.best_makespan == want.best_makespan
    assert got.baseline_makespan == want.baseline_makespan
    assert got.rows == want.rows
    assert any(not r["feasible"] for r in got.rows)
    assert got.best_makespan <= got.baseline_makespan
    assert got.summary() == want.summary()


def test_tune_apply_rebuilds_the_backend():
    sess, res = _tune(T, num_tiles=(16, 32), num_slots=(3,), tiled_dims=(0,))
    out = sess.tune(num_tiles=(16, 32), num_slots=(3,), tiled_dims=(0,), apply=True)
    assert sess.config == out.best and out.best.num_tiles == res.best.num_tiles
    sess.flush()
    assert sess.history[-1].modelled_s > 0


def test_tune_mesh_grid_raises_for_sharding():
    """A multi-device candidate runs the sharded executor: the grid costs
    ``sim:2`` beside the unsharded config, with the JAX package's rows and
    winner.  (It raised before sharded execution was ported.)"""
    grid = dict(num_tiles=(16,), num_slots=(3,), tiled_dims=(0,), meshes=[1, 2])
    with reference_tiles():   # the JAX package's tile counts
        sess, _ = _tune(T, num_tiles=(16,), num_slots=(3,), tiled_dims=(0,))
        got = sess.tune(**grid)
    jsess, _ = _tune(J, num_tiles=(16,), num_slots=(3,), tiled_dims=(0,))
    want = jsess.tune(**grid)
    assert {r["mesh"] for r in got.rows} == {None, "sim:2"}
    assert got.rows == want.rows
    assert got.best_makespan == want.best_makespan


# -- Session.verify, explain(verify=True) and debug mode --------------------------


def _heat_session(backend="sim", **kw):
    blk = T.Block("grid", (40, 24))
    rng = np.random.RandomState(7)
    u = T.make_dataset(blk, "u", halo=1, init=rng.rand(40, 24).astype(np.float32))
    tmp = T.make_dataset(blk, "tmp", halo=1)
    sess = T.Session(backend, device="cpu", num_tiles=4,
                     capacity_bytes=float("inf"), **kw)
    sess.par_loop("avg", blk, ((1, 39), (1, 23)), [u, tmp],
                  lambda acc: {"tmp": 0.5 * (acc("u", (1, 0)) + acc("u", (-1, 0)))})
    sess.par_loop("copy", blk, ((1, 39), (1, 23)), [tmp, u],
                  lambda acc: {"u": acc("tmp")})
    return sess, u


def test_session_verify_and_explain():
    sess, _ = _heat_session()
    res = sess.verify()
    assert res.ok and res.plans == 1
    text = sess.explain(verify=True)
    assert "verify:" in text and "clean" in text
    assert sess.queue    # nothing ran


def test_debug_mode_runs_clean_plans_and_matches_plain_ooc():
    plain, u0 = _heat_session("ooc")
    want = plain.fetch(u0)
    dbg, u1 = _heat_session("ooc", debug=True)
    got = dbg.fetch(u1)
    assert np.array_equal(got, want)
    assert dbg.history[-1].verify_s > 0 and plain.history[-1].verify_s == 0


def test_debug_mode_rejects_corrupt_plan():
    ex = T.OutOfCoreExecutor(T.OOCConfig(num_tiles=4, device="cpu",
                                         capacity_bytes=float("inf"),
                                         debug=True))
    sess, _ = _heat_session()
    loops = list(sess.queue)
    ir = ex.plan_chain(loops).ir
    # Drop the last download: dirty rows are never retired.
    cut = tuple(op for op in ir.ops
                if not (isinstance(op, T.Download)
                        and op.tile == ir.num_tiles - 1))
    with pytest.raises(T.PlanVerificationError) as ei:
        ex.run_chain(loops, plan=dataclasses.replace(ir, ops=cut))
    assert any(d.category == "dirty-loss" for d in ei.value.result.errors)
    assert not ex.history    # nothing ran
