"""The port's Session against the JAX package's on the heat program.

One numpy seed builds the JAX package's datasets; the port's come from their
padded homes through ``datasets_from_numpy``.  The same loops then run
through JAX ``reference``/``ooc``/``pallas`` and the port's ``reference``,
``ooc``, ``ooc-async`` and ``cuda`` backends on the CPU.  Tolerances are the
reference's own (tests/test_apps.py): fields rtol 1e-4, atol 1e-5;
reductions rtol 1e-3.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import star2d_kernel as jax_star2d  # noqa: E402
from repro.kernels import star3d_kernel as jax_star3d  # noqa: E402
from repro_torch.kernels import star2d_kernel as torch_star2d  # noqa: E402
from repro_torch.kernels import star3d_kernel as torch_star3d  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
RED = dict(rtol=1e-3)
N, M, STEPS = 128, 64, 3            # 2-D heat: 32 tiles at a quarter capacity
PROBLEM = 2 * (N + 2) * (M + 2) * 4  # u and tmp homes
OOC = dict(hw="p100-pcie", capacity_bytes=PROBLEM / 4, cyclic=True,
           prefetch=True)
# The port at the JAX package's 32 tiles: at a quarter capacity its chain
# does not fit with the tile function's workspace charged (core/workspace.py)
PORT_OOC = dict(OOC, num_tiles=32, capacity_bytes=float("inf"))
PORT_BACKENDS = ("reference", "ooc", "ooc-async", "cuda")


def _jax_homes(shape, seed):
    """The JAX package's padded homes, made from one numpy seed."""
    blk = J.Block("grid", shape)
    rng = np.random.RandomState(seed)
    u = J.make_dataset(blk, "u", halo=1, init=rng.rand(*shape).astype(np.float32))
    t = J.make_dataset(blk, "tmp", halo=1)
    return {"u": u.materialize().copy(), "tmp": t.materialize().copy()}


def _record(C, star, sess, dats, coeffs, steps):
    u, tmp = dats["u"], dats["tmp"]
    blk = u.block
    interior = tuple((1, s - 1) for s in blk.size)
    diffuse = star("u", "tmp", coeffs)
    for s in range(steps):
        sess.par_loop(f"diffuse{s}", blk, interior, [u, tmp], diffuse)
        sess.par_loop(f"commit{s}", blk, interior, [tmp, u],
                      lambda acc: {"u": acc("tmp")})
    sess.par_loop("summary", blk, interior, [u],
                  lambda acc: {"usum": acc("u").sum(), "umin": acc("u").min()},
                  reductions=[C.ReductionSpec("usum"),
                              C.ReductionSpec("umin", "min")])


def _run(pkg, backend, homes, *, three_d=False, **kw):
    """Record and run the heat program; returns the field, the reductions,
    the session and, for planning backends, the plan JSON and explain()."""
    shape = homes["u"].shape
    if pkg == "jax":
        C, star = J, (jax_star3d if three_d else jax_star2d)
        blk = C.Block("grid", tuple(s - 2 for s in shape))
        dats = {n: C.make_dataset(blk, n, halo=1, init=a) for n, a in homes.items()}
        sess = C.Session(backend, **kw)
    else:
        C, star = T, (torch_star3d if three_d else torch_star2d)
        blk = C.Block("grid", tuple(s - 2 for s in shape))
        dats = C.datasets_from_numpy(blk, homes, halo=1)
        sess = C.Session(backend, device="cpu", **kw)
    coeffs = (0.4, 0.1, 0.1, 0.1) if three_d else (0.0, 0.25, 0.25)
    _record(C, star, sess, dats, coeffs, steps=2 if three_d else STEPS)
    plan_json = explain = None
    if backend in ("ooc", "ooc-async"):
        plan_json = C.plans_to_json(sess.plan())
        explain = sess.explain()
    field = sess.fetch(dats["u"])
    reds = (float(sess.reduction("usum")), float(sess.reduction("umin")))
    return field, reds, sess, plan_json, explain


@pytest.fixture(scope="module")
def homes():
    return _jax_homes((N, M), seed=11)


@pytest.fixture(scope="module")
def jax_runs(homes):
    return {"reference": _run("jax", "reference", homes),
            "ooc": _run("jax", "ooc", homes, **OOC),
            "pallas": _run("jax", "pallas", homes)}


@pytest.fixture(scope="module")
def port_runs(homes):
    kw = {"ooc": PORT_OOC, "ooc-async": PORT_OOC}
    return {b: _run("torch", b, homes, **kw.get(b, {})) for b in PORT_BACKENDS}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("jax_backend", ["reference", "ooc"])
def test_fields_and_reductions_match_jax(backend, jax_backend, jax_runs, port_runs):
    want, want_reds = jax_runs[jax_backend][:2]
    got, got_reds = port_runs[backend][:2]
    assert got.shape == (N, M) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **FIELD)
    np.testing.assert_allclose(got_reds, want_reds, **RED)


def test_jax_ooc_config_runs_out_of_core(jax_runs, port_runs):
    for runs in (jax_runs, port_runs):
        hist = runs["ooc"][2].history
        assert len(hist) == 1 and hist[0].num_tiles == PORT_OOC["num_tiles"]


def test_ooc_async_bit_identical_to_ooc(port_runs):
    a, b = port_runs["ooc"], port_runs["ooc-async"]
    assert torch.equal(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    assert a[1] == b[1]
    assert port_runs["ooc-async"][2].transfer_stats()["mode"] == "threaded"


def test_plans_byte_equal_to_jax(jax_runs, port_runs):
    assert port_runs["ooc"][3] == jax_runs["ooc"][3]
    assert port_runs["ooc"][4] == jax_runs["ooc"][4]
    assert ([h.modelled_s for h in port_runs["ooc"][2].history]
            == [h.modelled_s for h in jax_runs["ooc"][2].history])


def test_kernel_backend_counters_match_pallas(jax_runs, port_runs):
    jb, tb = jax_runs["pallas"][2].backend, port_runs["cuda"][2].backend
    assert (tb.pallas_loops, tb.fallback_loops) == (jb.pallas_loops, jb.fallback_loops)
    assert (tb.pallas_loops, tb.fallback_loops) == (STEPS, STEPS + 1)


def test_pallas_name_selects_the_cuda_backend(homes, port_runs):
    got = _run("torch", "pallas", homes)
    assert isinstance(got[2].backend, T.KernelBackend)
    np.testing.assert_array_equal(got[0], port_runs["cuda"][0])


@pytest.mark.parametrize("backend", ["ooc", "cuda", "reference"])
def test_star3d_heat_matches_jax(backend):
    homes3 = _jax_homes((12, 10, 8), seed=5)
    kw = (dict(hw="p100-pcie", num_tiles=3, capacity_bytes=float("inf"),
               cyclic=True) if backend == "ooc" else {})
    want = _run("jax", backend if backend != "cuda" else "pallas", homes3,
                three_d=True, **kw)
    got = _run("torch", backend, homes3, three_d=True, **kw)
    np.testing.assert_allclose(got[0], want[0], **FIELD)
    np.testing.assert_allclose(got[1], want[1], **RED)
    if backend == "ooc":
        assert got[3] == want[3]
        assert got[2].history[0].num_tiles > 1
    if backend == "cuda":
        assert got[2].backend.pallas_loops == want[2].backend.pallas_loops == 2


# -- the data plane's hazards, on paths the heat chain does not take ----------


@pytest.mark.parametrize("num_slots", [1, 2])
def test_small_slot_pools_match_reference(num_slots, homes, jax_runs):
    """One slot: the edge carry overlaps its own slot; two: every upload
    reuses the slot whose download was just submitted."""
    for backend in ("ooc", "ooc-async"):
        got = _run("torch", backend, homes, num_slots=num_slots, num_tiles=6,
                   capacity_bytes=float("inf"))
        np.testing.assert_allclose(got[0], jax_runs["reference"][0], **FIELD)
        np.testing.assert_allclose(got[1], jax_runs["reference"][1], **RED)


def test_lossy_codec_roundtrips_through_numpy_like_jax(homes):
    kw = dict(hw="p100-pcie", capacity_bytes=PROBLEM / 4, codec="bf16")
    want = _run("jax", "ooc", homes, **kw)
    got = _run("torch", "ooc", homes, **dict(kw, num_tiles=PORT_OOC["num_tiles"],
                                               capacity_bytes=float("inf")))
    assert [h.num_tiles for h in got[2].history] == [
        h.num_tiles for h in want[2].history]
    np.testing.assert_allclose(got[0], want[0], **FIELD)
    st = got[2].transfer_stats()
    assert st["bytes_up_wire"] < st["bytes_up_raw"]


def test_pinned_dataset_and_resident_match_reference(homes, jax_runs):
    pinned = _run("torch", "ooc", homes, hw="p100-pcie", num_tiles=4,
                  capacity_bytes=float("inf"), pinned=("u",))
    resident = _run("torch", "resident", homes)
    for got in (pinned, resident):
        np.testing.assert_allclose(got[0], jax_runs["reference"][0], **FIELD)


def test_traced_run_emits_lane_spans_and_stays_bit_identical(homes, port_runs):
    got = _run("torch", "ooc-async", homes, trace=True, **PORT_OOC)
    assert np.array_equal(got[0], port_runs["ooc"][0])
    tracks = {s.track for s in got[2].trace().spans()}
    assert {"upload", "download", "chain"} <= tracks


def test_engine_raises_where_dynamic_slice_would_clamp():
    blk = T.Block("g", (16, 8))
    u = T.make_dataset(blk, "u", halo=1)
    t = T.make_dataset(blk, "tmp", halo=1)
    sess = T.Session("ooc", device="cpu", num_tiles=2, capacity_bytes=float("inf"))
    sess.par_loop("copy", blk, ((0, 16), (0, 8)), [u, t], lambda acc: {"tmp": acc("u")})
    cp = sess.backend.plan_chain(sess.queue)
    tile = cp.sched.tiles[0]
    slots = {n: torch.zeros(cp.sched.max_fp_len[n], 10) for n in ("u", "tmp")}
    with pytest.raises(T.SliceBoundsError, match="outside the slot"):
        cp.engine.run_tile(tile, slots, {"u": 5, "tmp": 5})


def test_captured_tensor_content_changes_the_plan_key():
    from repro_torch.core.dependency import kernel_fingerprint

    def make(c):
        return lambda acc: {"tmp": acc("u") * c}

    a, b = make(torch.tensor([1.0, 2.0])), make(torch.tensor([1.0, 2.0]))
    assert kernel_fingerprint(a) == kernel_fingerprint(b)
    assert kernel_fingerprint(a) != kernel_fingerprint(make(torch.tensor([1.0, 3.0])))


def _queued_heat(debug=False):
    blk = T.Block("g", (8, 6))
    u = T.make_dataset(blk, "u", halo=1)
    sess = T.Session("sim", device="cpu", num_tiles=2, debug=debug,
                     capacity_bytes=float("inf"))
    sess.par_loop("fill", blk, ((0, 8), (0, 6)), [u],
                  lambda acc: {"u": acc("u") + 1.0})
    return sess, u


def _debug_verifies(tmp):
    sess, _ = _queued_heat(debug=True)
    sess.flush()
    return sess.history[-1].verify_s > 0


def _checkpoint(tmp):
    sess, u = _queued_heat()
    manifest = sess.checkpoint(str(tmp / "state.npz"), datasets=[u])
    return manifest["format"] == 1 and list(manifest["datasets"]) == ["u"]


def _sharded_session(tmp):
    sess = T.Session("ooc", device="cpu", mesh=2)
    return isinstance(sess.backend, T.ShardedOutOfCoreExecutor)


def _sharded_tune(tmp):
    rows = _queued_heat()[0].tune(meshes=[1, 2]).rows
    return {r["mesh"] for r in rows} == {None, "sim:2"}


def _server_session(tmp):
    from repro_torch.serve import ServerClient, StencilServer

    with StencilServer("sim:1", device="cpu", capacity_bytes=float("inf")) as srv:
        sess = srv.session("t")
        blk = T.Block("g", (8, 6))
        u = T.make_dataset(blk, "u", halo=1)
        sess.par_loop("fill", blk, ((0, 8), (0, 6)), [u],
                      lambda acc: {"u": acc("u") + 1.0})
        ok = (isinstance(sess.backend, ServerClient)
              and bool((sess.fetch(u) == 1.0).all()) and len(sess.history) == 1)
        sess.close()
        return ok


@pytest.mark.parametrize("call, err", [
    (_sharded_session, None),
    (lambda tmp: T.Session("ooc", device="cpu", mesh="jax:2"), T.MeshError),
    (_debug_verifies, None),
    (lambda tmp: _queued_heat()[0].verify().ok, None),
    (_sharded_tune, None),
    (_checkpoint, None),
    (lambda tmp: T.make_dataset(T.Block("g", (4, 4)), "u", store=T.StoreConfig(
        kind="mmap", directory=str(tmp))).store.kind == "mmap", None),
    (_server_session, None),
], ids=["mesh", "jax-mesh", "debug", "verify", "tune", "checkpoint", "mmap",
        "server"])
def test_unported_features_raise(call, err, tmp_path):
    """The reference's ``jax:N`` mesh has no counterpart and raises a
    ``MeshError`` that names ``cuda:N``.  The features that were unported
    before (``err`` None) now run and return True: a multi-device ``mesh``
    routes an ``ooc`` Session to the sharded executor, ``tune``'s
    ``meshes=`` grid costs ``sim:2``, ``debug`` verifies the plan before it
    runs, ``verify`` finds it clean, ``checkpoint`` writes a format-1
    manifest, ``mmap`` gives the dataset an mmap home, and a
    ``StencilServer`` session runs its chain on a lane."""
    if err is None:
        assert call(tmp_path) is True
        return
    with pytest.raises(err, match="cuda:N"):
        call(tmp_path)


# -- a chain that no tile count fits splits; Cyclic must keep its state --------

SPLIT_N, SPLIT_M = 64, 40
SPLIT_PROBLEM = 2 * (SPLIT_N + 2) * (SPLIT_M + 2) * 4


@pytest.fixture(scope="module")
def split_runs():
    homes = _jax_homes((SPLIT_N, SPLIT_M), seed=13)
    runs = {"reference": _run("torch", "reference", homes)}
    for prefetch in (False, True):
        runs[prefetch] = _run("torch", "ooc", homes, hw="p100-pcie",
                              capacity_bytes=SPLIT_PROBLEM / 2, cyclic=True,
                              prefetch=prefetch)
    return runs


@pytest.mark.parametrize("prefetch", [False, True])
def test_split_cyclic_heat_equals_reference(prefetch, split_runs):
    """At half its homes the heat chain splits in two (at a quarter before
    the tile function's workspace was charged, where it now splits in four).
    ``u`` is read
    first by the whole chain but written first by the tail, so the tail
    must not treat it as a dead Cyclic temporary (it came back 0.242 off
    before the split kept read-first datasets live)."""
    got, want = split_runs[prefetch], split_runs["reference"]
    assert len(got[2].history) == 2 and got[2].chains_flushed == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **RED)


def test_split_plan_preview_matches_the_run_and_keeps_u_live(split_runs):
    sess, plan_json = split_runs[True][2], split_runs[True][3]
    plans = T.plans_from_json(plan_json)
    assert [p.num_tiles for p in plans] == [h.num_tiles for h in sess.history]
    assert all("u" in p.keep_live for p in plans)


def test_threaded_lanes_release_the_finished_chain():
    """A lane worker waiting for its next task must not keep the last
    chain's interpreter (and so its device slots) alive: on the card that
    doubled the slot memory of ``ooc-async`` between chains."""
    import gc

    from repro_torch.core.interp import DataPlaneInterpreter

    blk = T.Block("g", (32, 16))
    u = T.make_dataset(blk, "u", halo=1, init=np.ones((32, 16), np.float32))
    t = T.make_dataset(blk, "tmp", halo=1)
    sess = T.Session("ooc-async", device="cpu", num_tiles=4,
                     capacity_bytes=float("inf"))
    sess.par_loop("copy", blk, ((0, 32), (0, 16)), [u, t],
                  lambda acc: {"tmp": acc("u")})
    sess.flush()
    gc.collect()
    assert not [o for o in gc.get_objects()
                if isinstance(o, DataPlaneInterpreter) and o.info.datasets.get("u") is u]
    assert np.array_equal(sess.fetch(t), np.ones((32, 16), np.float32))
    sess.close()
