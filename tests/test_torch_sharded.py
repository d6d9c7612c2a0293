"""The port's sharded execution (``repro_torch.core.{mesh,distributed,
sharded}``) against the JAX package's.

The same inputs, made from numpy seeds, go through both packages on the CPU
at the reference's test sizes: shard geometries and segment splits of the
apps' timestep chains, halo message counts, ``exchange_halos`` (the JAX one
under ``shard_map`` on 4 of the host devices ``tests/conftest.py`` forces),
``make_sharded_chain_step``, ``sim:4`` plans of all three apps, and
CloverLeaf 2D on sharded sessions against the port's ``ooc`` (bit for bit)
and the JAX ``reference`` (fields rtol 1e-4 / atol 1e-5, summaries rtol
1e-3, the reference's own tolerances).  Split sharded plans are held against
their execution and against JAX ``reference``, not against the JAX
package's sharded ``ooc``, whose split loses Cyclic state (fault C1).
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import mesh as jmesh  # noqa: E402
from repro.core import sharded as jsharded  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import mesh as tmesh  # noqa: E402
from repro_torch.core import sharded as tsharded  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
RED = dict(rtol=1e-3)
CL2D_FIELDS = ("density0", "energy0", "pressure", "viscosity", "soundspeed",
               "xvel0", "yvel0", "volume", "xarea", "yarea")
# The fields a CloverLeaf 2D timestep reads before it writes them.
CARRIED = ("density0", "energy0", "xvel0", "yvel0", "volume", "xarea", "yarea")
INF = dict(num_tiles=4, capacity_bytes=float("inf"))
APPS = {"cloverleaf2d": lambda A: A.CloverLeaf2D(48, 32),
        "cloverleaf3d": lambda A: A.CloverLeaf3D(16, 48, 10),
        "opensbli": lambda A: A.OpenSBLI(24)}


def _kw(pkg):
    return {"device": "cpu"} if pkg is T else {}


def drive(rt, app, steps=1):
    """``tests/test_sharded.py::drive``: init + timesteps without the cyclic
    flag or dt chain breakers, so every home is fully defined."""
    app.record_init(rt)
    rt.flush()
    for _ in range(steps):
        app.dt = 1e-4
        app.record_timestep(rt)
        rt.flush()


def assert_all_dats_equal(want_app, app):
    for name in want_app.dats:
        np.testing.assert_array_equal(
            want_app.d(name).materialize(), app.d(name).materialize(),
            err_msg=name)


def _timestep_loops(pkg, apps, app_name):
    app = APPS[app_name](apps)
    sess = pkg.Session("reference", **_kw(pkg))
    app.record_init(sess)
    sess.queue.clear()
    app.dt = 1e-4
    app.record_timestep(sess)
    return list(sess.queue)


# -- geometry and counts --------------------------------------------------------


@pytest.mark.parametrize("extent, n, skirt", [(34, 4, 5), (8192, 4, 40),
                                              (7, 3, 0), (5, 1, 2)])
def test_shard_geometries_equal_jax(extent, n, skirt):
    got = tmesh.shard_geometries(extent, n, skirt)
    want = jmesh.shard_geometries(extent, n, skirt)
    assert [(g.index, g.lo, g.hi, g.skirt_lo, g.skirt_hi, g.ext_lo, g.ext_hi)
            for g in got] == [
        (g.index, g.lo, g.hi, g.skirt_lo, g.skirt_hi, g.ext_lo, g.ext_hi)
        for g in want]
    with pytest.raises(T.MeshError):
        tmesh.shard_geometries(n - 1, n, skirt) if n > 1 else \
            tmesh.shard_geometries(0, 1, skirt)


def test_mesh_specs():
    assert T.parse_mesh("sim:4") == T.DeviceMesh.sim(4)
    assert T.parse_mesh(3) == T.DeviceMesh.sim(3)
    assert T.parse_mesh("cuda:2") == T.DeviceMesh(2, kind="cuda")
    assert T.DeviceMesh.devices(2).spec == "cuda:2"
    with pytest.raises(T.MeshError, match="cuda:N"):
        T.parse_mesh("jax:2")
    with pytest.raises(T.MeshError, match="virtual"):
        T.DeviceMesh.sim(2).torch_devices()


@pytest.mark.parametrize("app_name", sorted(APPS))
def test_segments_and_halo_extents_equal_jax(app_name):
    """``split_segments`` at several skirt budgets and ``loop_halo_extent``
    on the apps' timestep chains, loop by loop."""
    tl = _timestep_loops(T, TA, app_name)
    jl = _timestep_loops(J, JA, app_name)
    assert [lp.name for lp in tl] == [lp.name for lp in jl]
    for dim in range(tl[0].block.ndim):
        assert ([tsharded.loop_halo_extent(lp, dim) for lp in tl]
                == [jsharded.loop_halo_extent(lp, dim) for lp in jl])
        assert (tdist.chain_halo_depth(tl, dim)
                == jdist.chain_halo_depth(jl, dim))
    widest = max(tsharded.loop_halo_extent(lp, 1) for lp in tl)
    for budget in (widest, widest + 3, 40, 64):
        got = tsharded.split_segments(tl, 1, budget)
        want = jsharded.split_segments(jl, 1, budget)
        assert ([[lp.name for lp in s] for s in got]
                == [[lp.name for lp in s] for s in want])
    if widest:
        with pytest.raises(T.ShardingError):
            tsharded.split_segments(tl, 1, widest - 1)


def test_message_counts_equal_jax():
    for n in range(1, 9):
        for arrays in (1, 3):
            for periodic in (False, True):
                assert (tdist.exchange_message_count(n, arrays, periodic)
                        == jdist.exchange_message_count(n, arrays, periodic))
                for loops, per_loop in ((1, False), (5, False), (5, True)):
                    assert (tdist.chain_message_count(n, arrays, loops, per_loop,
                                                      periodic)
                            == jdist.chain_message_count(n, arrays, loops,
                                                         per_loop, periodic))
    assert tdist.chain_halo_depth([], dim=1) == 0


# -- exchange_halos and make_sharded_chain_step against shard_map ---------------


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} XLA devices (conftest forces 8)")
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("depth, periodic", [(3, False), (3, True), (0, False),
                                             (2, True)],
                         ids=["open", "periodic", "depth0", "narrow-periodic"])
def test_exchange_halos_equals_jax_shard_map(depth, periodic):
    """Four blocks (uniform width, the last case narrower than three
    depths) through the port's in-place copies and the JAX ``ppermute``
    under ``shard_map``: bit for bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import shard_map

    mesh = _jax_mesh(4)
    width = 5 if depth == 2 else 14
    rng = np.random.RandomState(11)
    blocks = [rng.rand(6, width).astype(np.float32) for _ in range(4)]
    fn = jax.jit(shard_map(
        lambda a: jdist.exchange_halos({"u": a}, depth, "x", dim=1,
                                       periodic=periodic)["u"],
        mesh=mesh, in_specs=P(None, "x"), out_specs=P(None, "x"),
        check_vma=False))
    want = np.asarray(fn(jax.device_put(np.concatenate(blocks, 1),
                                        NamedSharding(mesh, P(None, "x")))))
    shards = [{"u": torch.from_numpy(b.copy())} for b in blocks]
    got = tdist.exchange_halos(shards, depth, dim=1, periodic=periodic)
    assert all(g["u"] is s["u"] for g, s in zip(got, shards))   # in place
    np.testing.assert_array_equal(
        np.concatenate([g["u"].numpy() for g in got], 1), want)


class TestShardedChainStep:
    """The periodic heat program of ``tests/test_distributed.py`` (8 ranks'
    worth of blocks with wrapped halos, two smoothing loops) through both
    packages' ``make_sharded_chain_step`` on 4 ranks."""

    N, M, HALO = 16, 64, 2

    def _locals(self, n):
        per = self.M // n
        rng = np.random.RandomState(0)
        g = rng.rand(self.N, self.M).astype(np.float32)
        locs = []
        for r in range(n):
            lo = (r * per - self.HALO) % self.M
            idx = [(lo + i) % self.M for i in range(per + 2 * self.HALO)]
            locs.append(g[:, idx])
        return g, locs

    @pytest.mark.parametrize("per_loop", [False, True])
    def test_bit_equal_to_jax(self, per_loop):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        n, halo = 4, self.HALO
        mesh = _jax_mesh(n)
        g, locs = self._locals(n)

        def jsmooth(arrays):
            u = arrays["u"]
            return {"u": 0.5 * u + 0.25 * (jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1))}

        def tsmooth(arrays, rank):
            u = arrays["u"]
            return {"u": 0.5 * u + 0.25 * (torch.roll(u, 1, 1)
                                           + torch.roll(u, -1, 1))}

        jstep = jdist.make_sharded_chain_step(
            lambda a: jsmooth(jsmooth(a)), mesh, "x", depth=halo,
            per_loop=per_loop, loop_fns=[jsmooth, jsmooth],
            per_loop_depth=halo, dim=1, periodic=True)
        tstep = tdist.make_sharded_chain_step(
            lambda a, r: tsmooth(tsmooth(a, r), r), T.DeviceMesh.sim(n),
            depth=halo, per_loop=per_loop, loop_fns=[tsmooth, tsmooth],
            per_loop_depth=halo, dim=1, periodic=True)
        assert (tstep.exchanges, tstep.messages_per_array) == (
            jstep.exchanges, jstep.messages_per_array)
        want = np.asarray(jstep({"u": jax.device_put(
            np.concatenate(locs, 1), NamedSharding(mesh, P(None, "x")))})["u"])
        got = tstep([{"u": torch.from_numpy(b.copy())} for b in locs])
        np.testing.assert_array_equal(
            np.concatenate([a["u"].numpy() for a in got], 1), want)
        # The owned columns are the periodic heat program's result.
        per, W = self.M // n, self.M // n + 2 * halo
        ref = g.copy()
        for _ in range(2):
            ref = 0.5 * ref + 0.25 * (np.roll(ref, 1, 1) + np.roll(ref, -1, 1))
        if not per_loop:
            owned = np.concatenate(
                [want[:, r * W + halo: r * W + halo + per] for r in range(n)], 1)
            np.testing.assert_allclose(owned, ref, atol=1e-6)


# -- plans -----------------------------------------------------------------------


def _sim_session(pkg, apps, app_name, mesh="sim:4", **kw):
    app = APPS[app_name](apps)
    sess = pkg.Session("sim", mesh=mesh, hw=pkg.P100_PCIE, **{**INF, **kw},
                       **_kw(pkg))
    app.record_init(sess)
    sess.queue.clear()
    app.dt = 1e-4
    app.record_timestep(sess)
    return app, sess


@pytest.mark.parametrize("app_name", sorted(APPS))
def test_sim4_plans_equal_jax(app_name):
    """Per-device plans byte-equal in ``plans_to_json``, the same
    ``explain()`` text and equal modelled makespans after the flush."""
    _, tsess = _sim_session(T, TA, app_name)
    _, jsess = _sim_session(J, JA, app_name)
    tplans, jplans = tsess.plan(), jsess.plan()
    assert {p.device for p in tplans} == {0, 1, 2, 3}
    assert T.plans_to_json(tplans) == J.plans_to_json(jplans)
    assert tsess.explain() == jsess.explain()
    tsess.flush()
    jsess.flush()
    assert ([h.modelled_s for h in tsess.history]
            == [h.modelled_s for h in jsess.history])
    assert ([h.halo_messages for h in tsess.history]
            == [h.halo_messages for h in jsess.history])


def test_explain_shows_devices_and_mesh_summary():
    _, sess = _sim_session(T, TA, "cloverleaf2d")
    text = sess.explain()
    for dev in range(4):
        assert f"device {dev}/4" in text
    assert "halo-exchange" in text
    assert "mesh summary: per-device makespans" in text
    assert "modelled makespan (device" in text


def test_tune_enumerates_shard_counts():
    _, sess = _sim_session(T, TA, "cloverleaf2d")
    res = sess.tune(meshes=[1, 2, 4], num_tiles=(4,), num_slots=(3,),
                    tiled_dims=(0,))
    assert {"sim:2", "sim:4"} <= {r["mesh"] for r in res.rows}
    assert all(r["feasible"] for r in res.rows)
    assert res.best_makespan <= res.baseline_makespan


# -- execution -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ooc_drive():
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    drive(T.Session("ooc", device="cpu", **INF), app, steps=2)
    return app


@pytest.mark.parametrize("backend, mesh", [("ooc-sharded", "sim:1"),
                                           ("ooc-sharded", "sim:4"),
                                           ("ooc-async", "sim:3")])
def test_sharded_drive_bit_identical_to_ooc(backend, mesh, ooc_drive):
    """The redundant skirt compute is the same arithmetic on the same
    values: every home equals the unsharded run's, bit for bit."""
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    with T.Session(backend, mesh=mesh, device="cpu", **INF) as sess:
        assert isinstance(sess.backend, T.ShardedOutOfCoreExecutor)
        drive(sess, app, steps=2)
        assert_all_dats_equal(ooc_drive, app)
        if mesh != "sim:1":
            st = sess.transfer_stats()
            assert st["halo_messages"] > 0
            assert sess.backend.exchange_path == "host"


def test_debug_sharded_session_verifies_every_plan(ooc_drive):
    """``debug=True`` on a mesh verifies each shard's plan before it runs
    and the cross-device exchange consistency of every segment's plans."""
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    sess = T.Session("ooc-sharded", mesh="sim:4", device="cpu", debug=True, **INF)
    drive(sess, app, steps=2)
    assert all(h.verify_s > 0 for h in sess.history)
    assert_all_dats_equal(ooc_drive, app)


def test_cyclic_prefetch_run_bit_identical_to_ooc():
    """``app.run`` (Cyclic after init, dt breakers, summaries) with
    speculative prefetch on ``sim:4`` gives the unsharded run's fields
    carried between steps and its ``dt``, bit for bit.  Under Cyclic the homes of write-first
    temporaries are dead (their downloads are elided, so they hold whatever
    each run last landed) and are not compared; the summaries add the
    shards' partial sums in another order (rtol 1e-3)."""
    kw = dict(INF, prefetch=True, device="cpu")
    want_app = TA.CloverLeaf2D(40, 32, summary_every=2)
    want = want_app.run(T.Session("ooc", **kw), steps=3)
    app = TA.CloverLeaf2D(40, 32, summary_every=2, mesh="sim:4")
    sess = app.make_session(**kw)
    got = app.run(sess, steps=3)
    for n in CARRIED:
        np.testing.assert_array_equal(app.d(n).interior(),
                                      want_app.d(n).interior(), err_msg=n)
    assert app.dt == want_app.dt
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **RED, err_msg=k)
    assert sess.transfer_stats()["halo_messages"] > 0


def _prefetch_heat(C, backend, mesh=None, rounds=3):
    """Three flushes of one heat chain (a star sweep, then a commit), so
    speculative prefetch captures each chain's first tile for the next."""
    blk = C.Block("grid", (24, 20))
    rng = np.random.RandomState(5)
    u = C.make_dataset(blk, "u", halo=1,
                       init=rng.rand(24, 20).astype(np.float32))
    tmp = C.make_dataset(blk, "tmp", halo=1)
    sess = C.Session(backend, mesh=mesh, **INF, prefetch=True, cyclic=True,
                     **_kw(C))
    box = ((1, 23), (1, 19))
    for _ in range(rounds):
        sess.par_loop("diffuse", blk, box, [u, tmp], lambda acc: {
            "tmp": 0.5 * acc("u") + 0.125 * (acc("u", (0, 1)) + acc("u", (0, -1))
                                             + acc("u", (1, 0)) + acc("u", (-1, 0)))})
        sess.par_loop("commit", blk, box, [tmp, u], lambda acc: {"u": acc("tmp")})
        sess.flush()
    return np.asarray(sess.fetch(u)), sess


def test_exchange_invalidates_prefetch_captures():
    """A prefetch capture taken at the end of one chain holds the skirt rows
    the next exchange refreshes; the port bumps the refreshed homes'
    versions, so the capture misses and the run equals the unsharded one
    bit for bit.  The JAX package replays the stale capture (its sharded
    run comes back off the reference)."""
    want, ooc = _prefetch_heat(T, "ooc")
    assert sum(h.prefetch_hits for h in ooc.history) > 0
    got, _ = _prefetch_heat(T, "ooc-sharded", "sim:2")
    np.testing.assert_array_equal(got, want)
    ref, _ = _prefetch_heat(J, "reference")
    np.testing.assert_allclose(got, ref, **FIELD)
    jax_sharded, _ = _prefetch_heat(J, "ooc-sharded", "sim:2")
    assert np.abs(jax_sharded - ref).max() > 1e-3


@pytest.fixture(scope="module")
def jax_cl2d():
    app = JA.CloverLeaf2D(40, 32, summary_every=2)
    return app, app.run(J.Session("reference"), steps=2)


def _assert_matches_jax(app, summary, jax_cl2d):
    want_app, want = jax_cl2d
    for n in CL2D_FIELDS:
        got = app.d(n).interior()
        assert np.isfinite(got).all(), n
        np.testing.assert_allclose(got, want_app.d(n).interior(), **FIELD,
                                   err_msg=n)
    assert set(summary) == set(want)
    for k in want:
        np.testing.assert_allclose(summary[k], want[k], **RED, err_msg=k)


def test_sim4_run_matches_jax_reference(jax_cl2d):
    """Cross-shard reductions: ``dt`` (min) exact under any split, the
    summary sums combined shard by shard."""
    app = TA.CloverLeaf2D(40, 32, summary_every=2)
    sess = T.Session("ooc-sharded", mesh="sim:4", device="cpu", **INF)
    _assert_matches_jax(app, app.run(sess, steps=2), jax_cl2d)


def _split_session(backend, mesh="sim:2", cap_frac=0.15, **kw):
    app = TA.CloverLeaf2D(40, 32, summary_every=2)
    sess = T.Session(backend, mesh=mesh, device="cpu",
                     capacity_bytes=app.total_bytes() * cap_frac, **kw)
    return app, sess


@pytest.mark.parametrize("backend", ["sim", "ooc-sharded"])
def test_split_plans_match_execution(backend):
    """At 0.15 of the homes every shard's segment splits (at a tenth
    before the tile function's workspace was charged, which no longer fits
    single loops at this size): the planned
    halo messages and computes equal what execution records (plan and run
    take their halves from the same ``split_chain``)."""
    app, sess = _split_session(backend)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    app.dt = 1e-4
    app.record_timestep(sess)
    plans = sess.plan()
    before = len(sess.history)
    sess.flush()
    hist = sess.history[before:]
    assert len(plans) > 2 * len(hist)          # the shards' segments split
    assert (sum(p.totals()["halo_messages"] for p in plans)
            == sum(h.halo_messages for h in hist) > 0)
    assert (sum(p.counts()["computes"] for p in plans)
            == sum(h.op_counts["computes"] for h in hist))


def test_split_sharded_run_matches_jax_reference(jax_cl2d):
    """Split Cyclic segments keep their state (fault C1 stays fixed on every
    shard): the fields match JAX ``reference``."""
    app, sess = _split_session("ooc-sharded", prefetch=True)
    summary = app.run(sess, steps=2)
    assert len(sess.backend.inner[0].history) > len(sess.history)   # split
    _assert_matches_jax(app, summary, jax_cl2d)


def test_ledger_halo_stats_equal_achieved():
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    sess = T.Session("ooc-sharded", mesh="sim:4", device="cpu", **INF)
    drive(sess, app)
    st = sess.transfer_stats()
    assert st["halo_messages"] > 0 and st["halo_bytes"] > 0
    assert st["halo_messages"] == sess.backend.halo_stats.messages
    assert st["halo_bytes"] == sess.backend.halo_stats.bytes


def test_checkpoint_restore_resume_bit_identical(tmp_path):
    app = TA.CloverLeaf2D(32, 24, summary_every=0)
    with T.Session("ooc-sharded", mesh="sim:3", device="cpu", num_tiles=3,
                   capacity_bytes=float("inf")) as sess:
        drive(sess, app, steps=1)
        path = str(tmp_path / "ck.npz")
        manifest = sess.checkpoint(path)
        assert manifest["plan_signatures"]
        app.dt = 1e-4
        app.record_timestep(sess)
        sess.flush()
        after = {n: app.d(n).materialize().copy() for n in app.dats}
        sess.restore(path, datasets=list(app.dats.values()))
        app.step_count -= 1   # sweep direction rewinds with restore
        app.dt = 1e-4
        app.record_timestep(sess)
        sess.flush()
        for n in app.dats:
            np.testing.assert_array_equal(after[n], app.d(n).materialize(),
                                          err_msg=n)


def test_exit_closes_every_inner_executors_threads():
    app = TA.CloverLeaf2D(24, 16, summary_every=0)
    with T.Session("ooc-async", mesh="sim:2", device="cpu", num_tiles=2,
                   capacity_bytes=float("inf")) as sess:
        drive(sess, app)
        workers = [t for t in threading.enumerate()
                   if t.name.startswith("transfer-")]
        assert workers
        inner = sess.backend.inner
    assert all(ex.transfer._workers == {} for ex in inner)
    for t in workers:
        t.join(timeout=5)
        assert not t.is_alive()


def test_offset_accessor_forwards_device():
    class Inner(T.Accessor):
        shape = (2, 3)
        device = torch.device("cpu")

        def coords(self):
            return (torch.zeros(self.shape, dtype=torch.int32),
                    torch.ones(self.shape, dtype=torch.int32))

        def __call__(self, name, offset=None):
            return torch.full(self.shape, 7.0)

    seen = {}

    def kernel(acc):
        seen["device"] = acc.device
        seen["coords"] = acc.coords()
        return {"u": torch.ones(acc.shape, device=acc.device) * acc("u")}

    out = tsharded.shift_kernel(kernel, (0, 5))(Inner())
    assert seen["device"] == torch.device("cpu")
    assert seen["coords"][1].eq(6).all() and seen["coords"][0].eq(0).all()
    assert out["u"].eq(7.0).all()


# -- cuda:N -----------------------------------------------------------------------


def test_cuda_mesh_beyond_the_cards_raises():
    n = torch.cuda.device_count() + 1
    with pytest.raises(T.MeshError, match="CUDA devices"):
        T.DeviceMesh(n, kind="cuda").torch_devices()


def test_device_path_exchange_bit_identical_to_host_path(monkeypatch,
                                                         ooc_drive):
    """The ``cuda:N`` exchange (buffers per shard, ``exchange_halos``, the
    received regions landed home) with its devices faked as four CPU
    devices equals the host path and the unsharded run, with the same
    achieved counts."""
    monkeypatch.setattr(T.DeviceMesh, "torch_devices",
                        lambda self: [torch.device("cpu")] * self.num_devices)
    runs = {}
    for mesh in ("sim:4", "cuda:4"):
        app = TA.CloverLeaf2D(40, 32, summary_every=0)
        sess = T.Session("ooc-sharded", mesh=mesh, device="cpu", **INF)
        drive(sess, app, steps=2)
        runs[mesh] = (app, sess.backend)
    assert runs["cuda:4"][1].exchange_path == "peer"
    assert_all_dats_equal(runs["sim:4"][0], runs["cuda:4"][0])
    assert_all_dats_equal(ooc_drive, runs["cuda:4"][0])
    assert runs["cuda:4"][1].halo_stats == runs["sim:4"][1].halo_stats
