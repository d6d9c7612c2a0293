"""The port's apps (``repro_torch.apps``) against the JAX package's.

Both packages build their fields from the same ``coords()``-only init chain,
so the same app at the same size starts from the same state.  The JAX runs
use its ``reference`` backend (and ``sim`` for plans); the port's run on the
CPU.  Tolerances are the reference's own (tests/test_apps.py): fields rtol
1e-4, atol 1e-5; summaries rtol 1e-3.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
RED = dict(rtol=1e-3)
CL2D_FIELDS = ("density0", "energy0", "xvel0", "yvel0")
OOC = dict(num_tiles=4, capacity_bytes=float("inf"), prefetch=True)


def _assert_fields(got_app, want_app, names):
    for n in names:
        got = got_app.d(n).interior()
        assert np.isfinite(got).all(), n
        np.testing.assert_allclose(got, want_app.d(n).interior(), **FIELD, err_msg=n)


def _assert_summaries(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **RED, err_msg=k)


# -- CloverLeaf 2D ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cl2d():
    app = JA.CloverLeaf2D(40, 32, summary_every=3)
    return app, app.run(J.Session("reference"), steps=3)


@pytest.fixture(scope="module")
def port_cl2d():
    runs = {}
    for backend, kw in (("reference", {}), ("ooc", OOC), ("ooc-async", OOC)):
        app = TA.CloverLeaf2D(40, 32, summary_every=3)
        sess = T.Session(backend, device="cpu", **kw)
        runs[backend] = (app, app.run(sess, steps=3), sess)
    return runs


@pytest.mark.parametrize("backend", ["reference", "ooc", "ooc-async"])
def test_cloverleaf2d_matches_jax_reference(backend, jax_cl2d, port_cl2d):
    app, summary, _ = port_cl2d[backend]
    _assert_fields(app, jax_cl2d[0], CL2D_FIELDS)
    _assert_summaries(summary, jax_cl2d[1])


def test_cloverleaf2d_ooc_async_bit_identical_to_ooc(port_cl2d):
    a, b = port_cl2d["ooc"], port_cl2d["ooc-async"]
    for n in CL2D_FIELDS:
        assert torch.equal(torch.from_numpy(a[0].d(n).interior()),
                           torch.from_numpy(b[0].d(n).interior())), n
    assert a[1] == b[1]
    assert all(h.num_tiles == 4 for h in a[2].history)


def _sim_plans(pkg, apps):
    app = apps.CloverLeaf2D(40, 32, summary_every=0)
    kw = {"device": "cpu"} if pkg is T else {}
    sess = pkg.Session("sim", hw=pkg.P100_PCIE, num_tiles=4, **kw)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    app.record_timestep(sess)
    plan_json, explain = pkg.plans_to_json(sess.plan()), sess.explain()
    sess.flush()
    return plan_json, explain, [h.modelled_s for h in sess.history]


@pytest.fixture(scope="module")
def cl2d_plans():
    return _sim_plans(J, JA), _sim_plans(T, TA)


@pytest.mark.parametrize("what", ["plans_to_json", "explain", "makespans"])
def test_cloverleaf2d_plans_equal_jax(what, cl2d_plans):
    i = ("plans_to_json", "explain", "makespans").index(what)
    want, got = cl2d_plans[0][i], cl2d_plans[1][i]
    assert got == want
    if what == "makespans":
        assert len(got) == 2 and all(t > 0 for t in got)


def test_cloverleaf2d_chain_structure():
    app = TA.CloverLeaf2D(24, 24, summary_every=0)
    assert len(app.dats) == 25  # §5.1: 25 variables
    sess = T.Session("reference", device="cpu")
    app.record_init(sess)
    sess.flush()
    app.record_timestep(sess)
    assert len(sess.queue) == 51  # 27 physics + 24 halo loops
    info = T.analyze_chain(sess.queue)
    assert info.skew_slope == 3  # halo mirror reads reach +/-3
    for tmp in ("pre_vol", "post_vol", "pre_mass", "ener_flux"):
        assert tmp in info.write_first


def test_cloverleaf2d_split_cyclic_chains_keep_state(jax_cl2d):
    """At a third of the problem the timestep chain splits; Cyclic must still
    download the velocities that the whole chain reads first (the reference
    package's split elides them and comes back 0.1 off)."""
    app = TA.CloverLeaf2D(40, 32, summary_every=3)
    sess = T.Session("ooc", device="cpu", capacity_bytes=app.total_bytes() / 3,
                     prefetch=True)
    summary = app.run(sess, steps=3)
    assert len(sess.history) > sess.chains_flushed  # some chain split
    _assert_fields(app, jax_cl2d[0], CL2D_FIELDS)
    _assert_summaries(summary, jax_cl2d[1])


# -- CloverLeaf 3D and OpenSBLI -------------------------------------------------


@pytest.fixture(scope="module")
def jax_cl3d():
    app = JA.CloverLeaf3D(14, 12, 10, summary_every=2)
    return app, app.run(J.Session("reference"), steps=2)


@pytest.mark.parametrize("backend", ["reference", "ooc"])
def test_cloverleaf3d_matches_jax_reference(backend, jax_cl3d):
    app = TA.CloverLeaf3D(14, 12, 10, summary_every=2)
    kw = dict(num_tiles=3, capacity_bytes=float("inf")) if backend == "ooc" else {}
    summary = app.run(T.Session(backend, device="cpu", **kw), steps=2)
    _assert_fields(app, jax_cl3d[0], CL2D_FIELDS + ("zvel0",))
    _assert_summaries(summary, jax_cl3d[1])


@pytest.fixture(scope="module")
def jax_sbli():
    app = JA.OpenSBLI(16, chain_steps=1)
    return app, app.run(J.Session("reference"), steps=2)


@pytest.mark.parametrize("backend", ["reference", "ooc"])
def test_opensbli_two_step_chains_match_jax_reference(backend, jax_sbli):
    app = TA.OpenSBLI(16, chain_steps=2)  # tile ACROSS both timesteps
    kw = (dict(num_tiles=3, capacity_bytes=float("inf"), prefetch=True)
          if backend == "ooc" else {})
    sess = T.Session(backend, device="cpu", **kw)
    summary = app.run(sess, steps=2)
    _assert_fields(app, jax_sbli[0], ("rho", "rhou", "rhov", "rhow", "rhoE"))
    _assert_summaries(summary, jax_sbli[1])
    # init + one chain of both timesteps + the summary
    assert sess.chains_flushed <= 4


def _sim_plans_3d(pkg, apps, name, chain_steps):
    """Plans of ``chain_steps`` timesteps recorded as one chain after init,
    with Cyclic on, at a fixed dt (both packages' app loops, names and
    stencils are the same, so the plans must be too)."""
    app = (apps.CloverLeaf3D(14, 12, 10, summary_every=0) if name == "cloverleaf3d"
           else apps.OpenSBLI(16, chain_steps=chain_steps))
    kw = {"device": "cpu"} if pkg is T else {}
    sess = pkg.Session("sim", hw=pkg.P100_PCIE, num_tiles=4, **kw)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    if name == "cloverleaf3d":
        app.dt = 1e-4
    for _ in range(chain_steps):
        app.record_timestep(sess)
    plan_json, explain = pkg.plans_to_json(sess.plan()), sess.explain()
    sess.flush()
    return plan_json, explain, [h.modelled_s for h in sess.history]


@pytest.mark.parametrize("chain_steps", [1, 2])
@pytest.mark.parametrize("name", ["cloverleaf3d", "opensbli"])
def test_3d_app_plans_equal_jax(name, chain_steps):
    """ROADMAP A5's plan-parity check for the 3-D apps: ``plans_to_json``,
    ``explain()`` and the modelled makespans are equal in both packages."""
    want = _sim_plans_3d(J, JA, name, chain_steps)
    got = _sim_plans_3d(T, TA, name, chain_steps)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and all(t > 0 for t in got[2])


@pytest.mark.parametrize("app, n_dats", [
    (lambda: TA.CloverLeaf3D(8, 8, 8), 30),   # §5.1: 30 variables
    (lambda: TA.OpenSBLI(8), 29),             # §5.1: 29 datasets
], ids=["cloverleaf3d", "opensbli"])
def test_dataset_counts_match_paper(app, n_dats):
    assert len(app().dats) == n_dats


def test_opensbli_24_loops_per_step():
    app = TA.OpenSBLI(12)
    sess = T.Session("reference", device="cpu")
    app.record_init(sess)
    sess.flush()
    app.record_timestep(sess)
    assert len(sess.queue) == 24  # 3 stages x (prim + shear + 5 resid + rk)


# -- knobs the port has not ported, and where tensors are made ------------------


def _sharded(sess):
    return (isinstance(sess.backend, T.ShardedOutOfCoreExecutor)
            and sess.config.backend == "ooc-sharded"
            and sess.backend.mesh.num_devices == 2)


@pytest.mark.parametrize("make, holds", [
    (lambda tmp: TA.CloverLeaf2D(16, 16, mesh=2).make_session(device="cpu"),
     _sharded),
    (lambda tmp: TA.CloverLeaf3D(8, 8, 8, mesh="sim:2").make_session(device="cpu"),
     _sharded),
    (lambda tmp: TA.OpenSBLI(8, mesh=2).make_session(device="cpu"), _sharded),
    (lambda tmp: TA.CloverLeaf2D(16, 16, store=T.StoreConfig(
        kind="mmap", directory=str(tmp))),
     lambda app: {d.store.kind for d in app.dats.values()} == {"mmap"}),
], ids=["cl2d-mesh", "cl3d-mesh", "opensbli-mesh", "cl2d-mmap"])
def test_unported_app_knobs_raise(make, holds, tmp_path):
    """The app knobs that were once unported now work: ``mesh=`` builds an
    ``ooc-sharded`` Session over that mesh (sharded execution, ported after
    it raised here), and ``store="mmap"`` gives every home an mmap store."""
    assert holds(make(tmp_path))


def test_run_is_init_then_run_steps():
    """``run(steps=3)`` and ``run(steps=1)`` followed by ``run_steps(1, 3)``
    give the same fields, dt, step count and summaries, bit for bit (the
    step loop a resumed run continues with)."""
    def fields(app, sess):
        return {n: sess.fetch(app.d(n)) for n in ("density0", "energy0", "xvel0")}

    whole = TA.CloverLeaf2D(20, 14, summary_every=1)
    sess = T.Session("ooc", device="cpu", num_tiles=2)
    want = whole.run(sess, steps=3)
    parts = TA.CloverLeaf2D(20, 14, summary_every=1)
    sess2 = T.Session("ooc", device="cpu", num_tiles=2)
    parts.run(sess2, steps=1)
    got = parts.run_steps(sess2, 1, 3)
    assert got == want and set(want) and (parts.dt, parts.step_count) == (whole.dt, 3)
    for name, arr in fields(whole, sess).items():
        assert np.array_equal(fields(parts, sess2)[name], arr), name


def test_make_session_without_mesh_is_plain_ooc():
    sess = TA.CloverLeaf2D(16, 16).make_session(device="cpu", num_tiles=2)
    assert isinstance(sess.backend, T.OutOfCoreExecutor)


@pytest.mark.parametrize("backend", ["reference", "ooc", "cuda"])
def test_accessors_report_their_device(backend):
    """Kernels make fresh tensors on ``acc.device``: every accessor (the
    tracing one of stencil inference, the reference's and the tile
    engine's) sets it."""
    blk = T.Block("g", (8, 6))
    u = T.make_dataset(blk, "u", halo=1)
    seen = []

    def k(acc):
        seen.append(acc.device)
        return {"u": torch.ones(acc.shape, device=acc.device)}

    sess = T.Session(backend, device="cpu", num_tiles=2,
                     capacity_bytes=float("inf"))
    sess.par_loop("fill", blk, ((0, 8), (0, 6)), [u], k)
    out = sess.fetch(u)
    assert np.array_equal(out, np.ones((8, 6), np.float32))
    assert len(seen) >= 2 and all(d == torch.device("cpu") for d in seen)
