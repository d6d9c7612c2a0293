"""The tile function's host side and its eager device part on the CPU
(``repro_torch.core.engine``; ``core/tile_graph.py`` captures that device
part as CUDA graphs on a card, ``tests/test_torch_tile_graph_cuda.py``).

* Each chain's tile signatures in the port equal the JAX engine's compile
  cache keys (``TileEngine._cache``, one ``jax.jit`` each) for the same
  config, and the port's graph keys number at most ``num_slots`` times
  those.  The JAX side plans on ``sim`` (its plans are the port's, byte for
  byte, for unsplit chains) and its engine's own ``run_tile`` then runs over
  every tile of its schedule, as its data plane does, with the XLA compile
  stubbed out: the cache fills exactly as in a run.
* The eager tile function leaves every home bit for bit as the package did
  before the tile function was split (``DIGESTS``, SHA-1 first 16 hex
  digits, taken with one CPU thread; ``python tests/test_torch_tile_graph.py``
  prints them for the package on ``PYTHONPATH``).
* The graph key tells apart tiles that differ in any slot-local offset or
  tensor.
* A chain whose kernel captures a scalar that changes between two runs
  computes with the new one (fields against JAX ``reference``, rtol 1e-4 /
  atol 1e-5).
"""
import contextlib
import hashlib
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402
from repro_torch.kernels import star2d_kernel as torch_star2d  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
HEAT = (64, 48)
APPS = ("heat", "cloverleaf2d", "cloverleaf3d", "opensbli")
NUM_TILES = {"heat": 8, "cloverleaf2d": 4, "cloverleaf3d": 3, "opensbli": 3}

DIGESTS = {
    "heat": "428d37daddb98774",
    "heat_one_slot": "428d37daddb98774",
    "cloverleaf2d_split": "aab094c8ef6fda8f",
    "cloverleaf2d_async": "0c09a748f2b66843",
    "cloverleaf3d": "be2cd7f2dc9d5dc0",
    "opensbli": "05c0fc64b0c86e95",
}


# -- the programs, in either package ------------------------------------------------


def _heat_homes():
    rng = np.random.default_rng(7)
    u = np.zeros(tuple(s + 2 for s in HEAT), np.float32)
    u[1:-1, 1:-1] = rng.random(HEAT, dtype=np.float32)
    return {"u": u, "tmp": np.zeros_like(u)}


def _heat(C, star, sess, dats, steps=3, summary=True):
    u, tmp = dats["u"], dats["tmp"]
    blk = u.block
    box = tuple((1, s - 1) for s in blk.size)
    for s in range(steps):
        sess.par_loop(f"diffuse{s}", blk, box, [u, tmp], star("u", "tmp", (0.0, 0.25, 0.25)))
        sess.par_loop(f"commit{s}", blk, box, [tmp, u], lambda acc: {"u": acc("tmp")})
    if summary:
        sess.par_loop("summary", blk, box, [u],
                      lambda acc: {"usum": acc("u").sum(), "umin": acc("u").min()},
                      reductions=[C.ReductionSpec("usum"), C.ReductionSpec("umin", "min")])


def _port_heat_dats():
    blk = T.Block("grid", HEAT)
    return T.datasets_from_numpy(blk, _heat_homes(), halo=1)


def _make_app(apps, name):
    if name == "cloverleaf2d":
        return apps.CloverLeaf2D(40, 32, summary_every=2)
    if name == "cloverleaf3d":
        return apps.CloverLeaf3D(14, 12, 10, summary_every=2)
    return apps.OpenSBLI(16, chain_steps=2)


def _sha(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def digests() -> dict:
    """Every home's SHA-1 after each program on the port's ``ooc`` family on
    the CPU (the eager tile function), with its summaries."""
    out = {}
    for name, kw in (("heat", dict(num_tiles=8)), ("heat_one_slot", dict(num_tiles=8,
                                                                         num_slots=1))):
        dats = _port_heat_dats()
        sess = T.Session("ooc", device="cpu", capacity_bytes=float("inf"), cyclic=True,
                         prefetch=True, **kw)
        _heat(T, torch_star2d, sess, dats)
        sess.flush()
        reds = [float(sess.reduction("usum")), float(sess.reduction("umin"))]
        out[name] = _sha([dats[n].to_numpy() for n in sorted(dats)]
                         + [np.array(reds, np.float64)])
    for name, app_name, backend, kw in (
            ("cloverleaf2d_split", "cloverleaf2d", "ooc", dict(split=True)),
            ("cloverleaf2d_async", "cloverleaf2d", "ooc-async", dict(num_tiles=4)),
            ("cloverleaf3d", "cloverleaf3d", "ooc", dict(num_tiles=3)),
            ("opensbli", "opensbli", "ooc", dict(num_tiles=3))):
        app = _make_app(TA, app_name)
        split = kw.pop("split", False)
        cap = app.total_bytes() / 3 if split else float("inf")
        sess = T.Session(backend, device="cpu", capacity_bytes=cap, prefetch=True, **kw)
        # the split case at the parent's tile counts: the digests hold the
        # tile function, not the planner (tests/_torch_reference_tiles.py)
        with reference_tiles() if split else contextlib.nullcontext():
            summary = app.run(sess, steps=2)
        sess.close()
        out[name] = _sha([app.dats[n].to_numpy() for n in sorted(app.dats)]
                         + [np.array([summary[k] for k in sorted(summary)], np.float64)])
    return out


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eager_tile_function_is_bit_identical_to_before(one_thread):
    assert digests() == DIGESTS


# -- signatures against the JAX engine's compile cache --------------------------------


def _record(pkg, apps, name, sess):
    """Record ``name``'s chains on ``sess``: its init (or the heat program)
    flushed, then one timestep chain with Cyclic on."""
    if name == "heat":
        if pkg is T:
            dats = _port_heat_dats()
            star = torch_star2d
        else:
            from repro.kernels import star2d_kernel as star
            blk = pkg.Block("grid", HEAT)
            dats = {n: pkg.make_dataset(blk, n, halo=1, init=a)
                    for n, a in _heat_homes().items()}
        _heat(pkg, star, sess, dats)
        sess.flush()
        return
    app = _make_app(apps, name)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    app.record_timestep(sess)
    sess.flush()


def _jax_signatures(name):
    """{chain sig_hash: the JAX engine's compile-cache keys} once its own
    ``run_tile`` has run every tile of the chain's schedule."""
    import repro.apps as JA
    import repro.core as J

    sess = J.Session("sim", hw=J.P100_PCIE, num_tiles=NUM_TILES[name],
                     capacity_bytes=float("inf"))
    _record(J, JA, name, sess)
    out = {}
    for cp in sess.backend._plans.values():
        cp.engine._build = lambda sig: (lambda slots, starts, origins: (slots, {}))
        for tile in cp.sched.tiles:
            cp.engine.run_tile(tile, {}, {})
        out[cp.ir.sig_hash] = set(cp.engine._cache)
    return out


def _port_tiles(name, monkeypatch):
    """Each chain's (sig_hash, num_slots, [(signature, graph key) per tile])
    of the port's ``ooc`` run on the CPU."""
    calls = defaultdict(list)
    run_tile = T.TileEngine.run_tile

    def recording(self, tile, slots, origins):
        calls[id(self)].append((self.signature(tile),
                                self.graph_key(tile, slots, origins)))
        return run_tile(self, tile, slots, origins)

    monkeypatch.setattr(T.TileEngine, "run_tile", recording)
    sess = T.Session("ooc", device="cpu", hw="p100-pcie", num_tiles=NUM_TILES[name],
                     capacity_bytes=float("inf"))
    _record(T, TA, name, sess)
    plans = list(sess.backend._plans.values())
    assert len(calls) == len(plans)
    return {cp.ir.sig_hash: (cp.ir.num_slots, calls[id(cp.engine)]) for cp in plans}


@pytest.mark.parametrize("name", APPS)
def test_tile_signatures_equal_the_jax_compile_cache(name, monkeypatch):
    want = _jax_signatures(name)
    got = _port_tiles(name, monkeypatch)
    assert set(got) == set(want) and len(got) >= 1
    for sig_hash, (num_slots, tiles) in got.items():
        sigs = {s for s, _ in tiles}
        keys = {k for _, k in tiles}
        assert sigs == want[sig_hash], (name, sig_hash)
        assert len(keys) <= num_slots * len(sigs), (name, len(keys), len(sigs))
        # every key is one signature's
        assert {k[0] for k in keys} == sigs


# -- the graph key --------------------------------------------------------------------


def _one_chain():
    dats = _port_heat_dats()
    sess = T.Session("ooc", device="cpu", num_tiles=8, capacity_bytes=float("inf"))
    _heat(T, torch_star2d, sess, dats, summary=False)
    cp = sess.backend.plan_chain(sess.queue)
    slots = {n: torch.zeros(tuple((cp.sched.max_fp_len[n],) + d.padded_shape[1:]))
             for n, d in cp.info.datasets.items()}
    return cp, slots


def test_graph_key_tells_apart_every_offset_and_tensor():
    cp, slots = _one_chain()
    eng = cp.engine
    tiles = cp.sched.tiles
    origins = [dict(o) for o in cp.ir.tile_origins]
    base = eng.graph_key(tiles[2], slots, origins[2])
    assert base == eng.graph_key(tiles[2], dict(slots), dict(origins[2]))
    # a slot-local offset: one dataset's origin moved by a row
    for name in origins[2]:
        moved = dict(origins[2], **{name: origins[2][name] + 1})
        assert eng.graph_key(tiles[2], slots, moved) != base, name
    # the same signature at other slot-local offsets: every tile start moved
    # by a row against unmoved origins
    shifted = type(tiles[2])(
        index=tiles[2].index,
        loop_ranges=[None if b is None else ((b[0][0] + 1, b[0][1] + 1),) + tuple(b[1:])
                     for b in tiles[2].loop_ranges],
        footprint=tiles[2].footprint, upload=tiles[2].upload,
        download=tiles[2].download, edge_to_next=tiles[2].edge_to_next)
    assert eng.signature(shifted) == eng.signature(tiles[2])
    assert eng.graph_key(shifted, slots, origins[2]) != base
    # one loop's start alone moved: the same signature, other offsets
    k = next(i for i, b in enumerate(tiles[2].loop_ranges) if b is not None)
    ranges = list(tiles[2].loop_ranges)
    (lo, hi), rest = ranges[k][0], ranges[k][1:]
    ranges[k] = ((lo + 1, hi + 1),) + tuple(rest)
    one = type(tiles[2])(index=2, loop_ranges=ranges, footprint={}, upload={},
                         download={}, edge_to_next={})
    assert eng.graph_key(one, slots, origins[2]) != base
    # a tensor: the same shape and values, another tensor
    for name in slots:
        other = dict(slots, **{name: slots[name].clone()})
        assert eng.graph_key(tiles[2], other, origins[2]) != base, name
    # interior tiles of one slot pattern at the same offsets share a key
    sigs = [eng.signature(t) for t in tiles]
    assert len(set(sigs)) < len(sigs)


def test_start_enters_coords_as_a_device_tensor():
    """``coords()`` reads the tiled dim's start from the 0-d int32 tensor
    ``tile_fn`` is given, and the eager call's fresh one gives the grid's
    coordinates."""
    blk = T.Block("g", (16, 8))
    u = T.make_dataset(blk, "u", halo=1)
    sess = T.Session("ooc", device="cpu", num_tiles=4, capacity_bytes=float("inf"))
    sess.par_loop("fill", blk, ((0, 16), (0, 8)), [u],
                  lambda acc: {"u": acc.coords()[0].to(torch.float32)})
    cp = sess.backend.plan_chain(sess.queue)
    tile = cp.sched.tiles[1]
    origins = dict(cp.ir.tile_origins[1])
    slots = {"u": torch.zeros(cp.sched.max_fp_len["u"], 10)}
    seen = []

    def start_t(k, start):
        seen.append((k, start))
        return torch.full((), 100, dtype=torch.int32)

    cp.engine.tile_fn(tile, slots, origins, start_t)
    (k, start), = seen
    lo, hi = tile.loop_ranges[0][0]
    rows = slots["u"][lo - origins["u"]:hi - origins["u"], 1:9]
    assert start == lo
    assert torch.equal(rows[:, 0], torch.arange(100, 100 + hi - lo, dtype=torch.float32))
    cp.engine.run_tile(tile, slots, origins)
    assert torch.equal(rows[:, 0], torch.arange(lo, hi, dtype=torch.float32))


# -- a captured scalar changed between two runs ---------------------------------------


def _scaled(pkg, sess, dats, scale):
    u, tmp = dats["u"], dats["tmp"]
    blk = u.block
    box = tuple((1, s - 1) for s in blk.size)
    sess.par_loop("scale", blk, box, [u, tmp],
                  lambda acc: {"tmp": scale * acc("u") + 0.25 * acc("u", (1, 0))})
    sess.par_loop("commit", blk, box, [tmp, u], lambda acc: {"u": acc("tmp")})
    sess.flush()


def test_a_captured_scalar_changed_between_runs_is_used():
    import repro.core as J

    homes = _heat_homes()
    dats = T.datasets_from_numpy(T.Block("grid", HEAT), homes, halo=1)
    sess = T.Session("ooc", device="cpu", num_tiles=8, capacity_bytes=float("inf"))
    blk = J.Block("grid", HEAT)
    jdats = {n: J.make_dataset(blk, n, halo=1, init=a) for n, a in homes.items()}
    jsess = J.Session("reference")
    for scale in (0.5, 2.0, 0.5):
        _scaled(T, sess, dats, scale)
        _scaled(J, jsess, jdats, scale)
        np.testing.assert_allclose(dats["u"].interior(), jdats["u"].interior(), **FIELD)
    st = sess.plan_stats()
    assert st["plan_misses"] == 2 and st["plan_hits"] == 1
    assert all(h.graph_captures == h.graph_replays == 0 for h in sess.history)


if __name__ == "__main__":
    # print the digests of the package on PYTHONPATH, one thread
    import json
    torch.set_num_threads(1)
    print(json.dumps(digests(), indent=1))
