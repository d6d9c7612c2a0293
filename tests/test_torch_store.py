"""The port's disk tier (``repro_torch.core.store``) against the JAX package's.

Store round trips, the chunk cache, mmap reopen, the ``ooc`` data plane on
disk-backed homes with the host oversubscribed, ``sim`` disk costing, and
checkpoints: resumed runs and checkpoints carried across the two packages.
Sizes are the reference's own (``tests/test_store.py``: ``CloverLeaf2D(20,
14)``, ``num_tiles=2``).  Data-plane runs are held bit for bit against the
port's RAM run; cross-package runs at the reference's field tolerance
(rtol 1e-4, atol 1e-5).
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.store import ChunkedStore as JChunked  # noqa: E402
from repro_torch.core.store import ChunkedStore, MmapStore  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
CL2D_FIELDS = ("density0", "energy0", "xvel0", "yvel0")
OOC = dict(num_tiles=2, capacity_bytes=float("inf"), device="cpu")


def _specs(pkg, tmp_path, tag):
    return [
        None,
        "ram",
        pkg.StoreConfig(kind="mmap", directory=str(tmp_path / f"{tag}-mm")),
        pkg.StoreConfig(kind="chunked", directory=str(tmp_path / f"{tag}-ch"),
                        chunk_bytes=256, cache_bytes=1 << 10),
        pkg.StoreConfig(kind="chunked", directory=str(tmp_path / f"{tag}-id"),
                        chunk_bytes=512, cache_bytes=1 << 20, codec="identity"),
    ]


# -- store round trips -----------------------------------------------------------


def test_registry_has_all_three():
    assert set(T.available_stores()) == set(J.available_stores())
    assert {"ram", "mmap", "chunked"} <= set(T.available_stores())


@pytest.mark.parametrize("i", range(5),
                         ids=["none", "ram", "mmap", "chunked", "chunked-identity"])
def test_store_roundtrip_matches_jax(i, tmp_path):
    """Every kind: the same writes through both packages leave the same
    home, read back by box, by rows and as tensors."""
    rng = np.random.default_rng(3)
    ref = rng.random((13 + 2, 9 + 2), dtype=np.float32)
    patch = rng.random((4, 5), dtype=np.float32)
    homes = []
    for pkg, tag in ((J, "jax"), (T, "port")):
        blk = pkg.Block("b", (13, 9))
        dat = pkg.make_dataset(blk, "d", halo=1, init=ref,
                               store=_specs(pkg, tmp_path, tag)[i])
        dat.write(((2, 6), (1, 6)), patch)
        dat.write_rows(0, 8, 10, np.full((2, 11), 7.0, np.float32))
        homes.append((dat, np.array(dat.materialize(), copy=True)))
    (jd, jhome), (td, thome) = homes
    assert np.array_equal(thome, jhome)
    assert td.version == jd.version == 1
    assert td.store.kind == (jd.store.kind if i else "ram")
    for box in (((0, 13), (0, 9)), ((-1, 3), (2, 9)), ((5, 14), (-1, 4))):
        assert np.array_equal(td.read(box), jd.read(box)), box
        assert np.array_equal(td.box_tensor(box).numpy(), jd.read(box)), box
    assert np.array_equal(td.rows_tensor(0, 3, 9).numpy(), jd.read_rows(0, 3, 9))
    # A tensor write (what the data plane's download lands) through the store.
    td.write_rows(1, 0, 2, torch.full((15, 2), 3.0))
    jd.write_rows(1, 0, 2, np.full((15, 2), 3.0, np.float32))
    assert np.array_equal(td.materialize(), np.asarray(jd.materialize()))


def test_tensor_forms_are_views_only_where_the_store_has_them(tmp_path):
    blk = T.Block("b", (6, 4))
    for kind, live in (("ram", True), ("mmap", True), ("chunked", False)):
        d = T.make_dataset(blk, kind, halo=1, store=T.StoreConfig(
            kind=kind, directory=str(tmp_path / kind)))
        assert d.store.tensor_views is live
        d.rows_tensor(0, 0, 2).fill_(5.0)
        assert bool((d.read_rows(0, 0, 2) == 5.0).all()) is live, kind


def test_chunked_data_property_raises(tmp_path):
    d = T.make_dataset(T.Block("b", (4, 4)), "d", store=T.StoreConfig(
        kind="chunked", directory=str(tmp_path)))
    with pytest.raises(T.StoreError):
        d.data
    assert d.materialize().shape == (6, 6)


def test_from_store_validates_shape(tmp_path):
    blk = T.Block("b", (5, 4))
    st = MmapStore(str(tmp_path / "a.mmap"), (7, 6), np.float32)
    d = T.Dataset.from_store(blk, "a", st, halo=1)
    assert d.padded_shape == (7, 6) and d.store is st
    with pytest.raises(T.StoreError):
        T.Dataset.from_store(blk, "b", MmapStore(
            str(tmp_path / "b.mmap"), (8, 6), np.float32), halo=1)


def test_unknown_store_kind_raises():
    with pytest.raises(T.StoreError, match="unknown store kind"):
        T.make_dataset(T.Block("b", (4, 4)), "d", store="tape")


# -- the chunk cache ------------------------------------------------------------


def _chunked_pair(tmp_path, cache_bytes):
    kw = dict(chunk_bytes=2 * 8 * 4, cache_bytes=cache_bytes)
    return (ChunkedStore(str(tmp_path / "port"), (12, 8), np.float32, **kw),
            JChunked(str(tmp_path / "jax"), (12, 8), np.float32, **kw))


@pytest.mark.parametrize("budget_chunks", [1, 3])
def test_chunk_cache_lru_and_budget_match_jax(tmp_path, budget_chunks):
    """The same access pattern evicts the same chunks in the same order,
    writes back the same dirty chunks and never holds more than the budget
    (or one chunk, if the budget is smaller)."""
    rng = np.random.default_rng(5)
    port, ref = _chunked_pair(tmp_path, budget_chunks * 2 * 8 * 4)
    ops = [("w", 0, 4), ("r", 2, 6), ("w", 10, 12), ("r", 0, 2), ("p", 4, 8),
           ("w", 5, 9), ("s", 4, 10), ("r", 0, 12), ("s", 0, 12)]
    for op, lo, hi in ops:
        idx = (slice(lo, hi),)
        if op == "w":
            vals = rng.random((hi - lo, 8), dtype=np.float32)
            port.write(idx, torch.from_numpy(vals))
            ref.write(idx, vals)
        elif op == "r":
            assert np.array_equal(port.read(idx), ref.read(idx))
        elif op == "p":
            assert port.prefetch(idx) == ref.prefetch(idx)
        else:
            assert port.spill(idx) == ref.spill(idx)
        assert port.cache_keys() == ref.cache_keys(), (op, lo, hi)
        assert port.cache_resident_bytes() <= max(budget_chunks, 1) * 2 * 8 * 4
    assert port.stats == ref.stats
    assert port.stats["chunk_evictions"] > 0


def test_chunked_reopen_sees_written_data(tmp_path):
    rng = np.random.default_rng(6)
    st, _ = _chunked_pair(tmp_path, 1 << 20)
    vals = rng.random((12, 8), dtype=np.float32)
    st.write((slice(0, 12),), vals)
    st.close()
    again = ChunkedStore(str(tmp_path / "port"), (12, 8), np.float32,
                         chunk_bytes=2 * 8 * 4)
    assert np.array_equal(again.read((slice(0, 12),)), vals)


# -- mmap reopen -----------------------------------------------------------------


def test_mmap_home_survives_reopen(tmp_path):
    rng = np.random.default_rng(7)
    blk = T.Block("b", (6, 5))
    cfg = T.StoreConfig(kind="mmap", directory=str(tmp_path))
    vals = rng.random((8, 7), dtype=np.float32)
    d = T.make_dataset(blk, "u", halo=1, init=vals, store=cfg)
    assert d.flush_store() == 0
    again = T.Dataset.from_store(
        blk, "u", MmapStore.open(str(tmp_path / "u.mmap"), (8, 7), np.float32))
    assert np.array_equal(again.materialize(), vals)
    # ... and so does a reopen through the config, as the JAX package's does.
    j = J.make_dataset(J.Block("b", (6, 5)), "u", halo=1, store=J.StoreConfig(
        kind="mmap", directory=str(tmp_path), mode="r+"))
    assert np.array_equal(np.asarray(j.materialize()), vals)
    with pytest.raises(T.StoreError):
        MmapStore.open(str(tmp_path / "u.mmap"), (9, 7), np.float32)


# -- the data plane on disk-backed homes ----------------------------------------------


def _app(store=None, pkg=TA, nx=20, ny=14):
    return pkg.CloverLeaf2D(nx, ny, summary_every=0, store=store)


def _cfg(tmp_path, kind, tag, cache_bytes=16 << 10):
    # Chunks of 7 rows, so a spill retires whole chunks and a later fetch
    # reads them back from disk.
    return T.StoreConfig(kind=kind, directory=str(tmp_path / tag),
                         chunk_bytes=512, cache_bytes=cache_bytes)


def _run(app, steps=2, **kw):
    sess = T.Session("ooc", **{**OOC, **kw})
    app.run(sess, steps=steps)
    out = {n: sess.fetch_raw(d) for n, d in app.dats.items()}
    return sess, out


@pytest.fixture(scope="module")
def ram_run():
    return _run(_app())[1]


@pytest.mark.parametrize("kind", ["mmap", "chunked"])
def test_disk_homes_bit_identical_to_ram_with_host_oversubscribed(
        kind, tmp_path, ram_run):
    """A host budget of 0.3 x the homes plans FetchHome/SpillHome; the disk
    lane runs them, and the fields equal the RAM run's bit for bit."""
    app = _app(store=_cfg(tmp_path, kind, kind))
    sess, out = _run(app, host_capacity=app.total_bytes() * 0.3)
    for name in ram_run:
        assert np.array_equal(out[name], ram_run[name]), name
    st = sess.transfer_stats()
    assert st["home_fetches"] > 0 and st["home_spills"] > 0
    assert st["bytes_disk_read"] > 0 and st["bytes_disk_written"] > 0
    assert st["lanes"]["disk"]["service"]["count"] > 0
    assert all(h.disk_written >= 0 for h in sess.history)
    sess.close()


@pytest.mark.parametrize("kind", ["mmap", "chunked"])
def test_threaded_matches_sync_with_disk_tier(kind, tmp_path):
    outs = {}
    for mode in ("sync", "threaded"):
        app = _app(store=_cfg(tmp_path, kind, mode))
        sess, outs[mode] = _run(app, host_capacity=app.total_bytes() * 0.3,
                                transfer=mode)
        sess.close()
    for name in outs["sync"]:
        assert np.array_equal(outs["sync"][name], outs["threaded"][name]), name


def test_reference_backend_on_chunked_homes_matches_ram(tmp_path):
    """The oracle writes back through the store where its tensors are
    copies (``chunked``), so it agrees with itself on RAM homes."""
    outs = []
    for store in (None, _cfg(tmp_path, "chunked", "ref")):
        app = _app(store=store)
        sess = T.Session("reference", device="cpu")
        app.run(sess, steps=1)
        outs.append({n: sess.fetch_raw(d) for n, d in app.dats.items()})
    for name in outs[0]:
        assert np.array_equal(outs[0][name], outs[1][name]), name


@pytest.mark.parametrize("kind", ["mmap", "chunked"])
def test_kernel_backend_on_disk_homes_matches_ram(kind, tmp_path):
    """The ``cuda`` backend stages each swept box out of the home as a
    tensor and writes the result back through the store (on the CPU its
    wrappers run their plain versions)."""
    from repro_torch.kernels import star2d_kernel

    rng = np.random.default_rng(8)
    init = rng.random((34, 22), dtype=np.float32)
    outs, counts = [], []
    for store in (None, _cfg(tmp_path, kind, "kernel")):
        blk = T.Block("g", (32, 20))
        u = T.make_dataset(blk, "u", halo=1, init=init, store=store)
        v = T.make_dataset(blk, "v", halo=1, store=store)
        sess = T.Session("cuda", device="cpu")
        for i in range(3):
            a, b = (u, v) if i % 2 == 0 else (v, u)
            sess.par_loop(f"sweep{i}", blk, ((1, 31), (1, 19)), [a, b],
                          star2d_kernel(a.name, b.name, (0.5, 0.125, 0.125)))
        outs.append(sess.fetch(v))
        counts.append(sess.backend.pallas_loops)
    assert np.array_equal(outs[0], outs[1])
    assert counts == [3, 3]


# -- sim disk costing -----------------------------------------------------------------


def _sim(pkg, apps):
    app = apps.CloverLeaf2D(20, 14, summary_every=0)
    hw = pkg.P100_PCIE.with_(host_capacity=app.total_bytes() * 0.3)
    kw = {"device": "cpu"} if pkg is T else {}
    sess = pkg.Session("sim", hw=hw, num_tiles=2,
                       capacity_bytes=float("inf"), **kw)
    app.record_init(sess)
    jsons = [pkg.plans_to_json(sess.plan())]
    sess.flush()
    sess.cyclic = True
    app.record_timestep(sess)
    jsons.append(pkg.plans_to_json(sess.plan()))
    sess.flush()
    return jsons, [(h.disk_read, h.disk_written, h.op_counts["home_fetches"],
                    h.op_counts["home_spills"], h.modelled_s)
                   for h in sess.history]


def test_sim_disk_costs_and_plans_equal_jax():
    (jj, jh), (tj, th) = _sim(J, JA), _sim(T, TA)
    assert tj == jj
    assert th == jh
    assert all('"spill_home": true' in j for j in tj)
    assert th[0][1] > 0 and th[0][3] > 0    # init: spills only
    assert th[-1][0] > 0 and th[-1][2] > 0  # timestep: fetches too


# -- checkpoint / restore ---------------------------------------------------------------


def _continue(app, sess, steps=1):
    for _ in range(steps):
        app.record_timestep(sess)
    sess.flush()
    return {n: sess.fetch_raw(d) for n, d in app.dats.items()}


@pytest.mark.parametrize("kind", ["ram", "chunked"])
def test_resume_is_bit_identical(kind, tmp_path):
    def store(tag):
        return None if kind == "ram" else _cfg(tmp_path, "chunked", tag)

    app = _app(store=store("src"))
    sess = T.Session("ooc", **OOC)
    app.run(sess, steps=1)
    ckpt = str(tmp_path / "state.npz")
    manifest = sess.checkpoint(ckpt)
    assert "density0" in manifest["datasets"]
    dt, step_count = app.dt, app.step_count
    app.run_steps(sess, 1, 2)
    final_a = {n: sess.fetch_raw(d) for n, d in app.dats.items()}

    app2 = _app(store=store("dst"))
    sess2 = T.Session("ooc", **OOC)
    sess2.restore(ckpt, datasets=app2.dats.values())
    app2.dt, app2.step_count = dt, step_count
    sess2.cyclic = True
    app2.run_steps(sess2, 1, 2)
    for name in final_a:
        assert np.array_equal(final_a[name], sess2.fetch_raw(app2.dats[name])), name
    for name, dat in app.dats.items():
        assert dat.version == app2.dats[name].version
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_restore_drops_pinned_and_prefetch_state(tmp_path):
    """Device-side data from before the snapshot must not survive it."""
    app = _app()
    sess = T.Session("ooc", **OOC, prefetch=True, pinned=("volume",))
    app.run(sess, steps=1)
    ex = sess.backend
    assert ex.residency._pinned_cache and ex._spec.uploaded
    path = str(tmp_path / "s.npz")
    sess.checkpoint(path)
    sess.restore(path)
    assert not ex.residency._pinned_cache and not ex._spec.uploaded


def _session(pkg):
    return J.Session("reference") if pkg is J else T.Session("ooc", **OOC)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    """A checkpoint one package writes loads into the other; one more step
    from it agrees with the writer's own continuation at the field
    tolerance (the JAX side runs its ``reference`` backend, the port its
    ``ooc``, so the state fields are compared: write-first temporaries
    differ between backends by design)."""
    ckpt = str(tmp_path / "cross.npz")
    (w_pkg, w_apps), (r_pkg, r_apps) = (((J, JA), (T, TA)) if writer == "jax"
                                        else ((T, TA), (J, JA)))
    src = _app(pkg=w_apps)
    sess = _session(w_pkg)
    src.run(sess, steps=1)
    sess.checkpoint(ckpt)
    scalars = (src.dt, src.step_count)
    want = _continue(src, sess)

    dst = _app(pkg=r_apps)
    sess2 = _session(r_pkg)
    manifest = sess2.restore(ckpt, datasets=dst.dats.values())
    assert manifest["format"] == 1 and "density0" in manifest["datasets"]
    dst.dt, dst.step_count = scalars
    sess2.cyclic = True
    got = _continue(dst, sess2)
    for name in CL2D_FIELDS:
        np.testing.assert_allclose(got[name], want[name], **FIELD, err_msg=name)
