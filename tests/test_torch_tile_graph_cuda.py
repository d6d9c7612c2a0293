"""``core/tile_graph.py::TileGraphs`` on a card: the tile function captured
as CUDA graphs on the ``ooc`` data plane, at small sizes with enough tiles
that keys repeat.  Every replay is ``torch.equal`` to the eager tile
function on clones of the tile's tensors (``check_replays``), the homes
equal to a run whose tiles all run eagerly on the card, a replaced slot
tensor is refused, a captured scalar changed between two runs gives what
the eager tile function gives, and so do a run with a wire codec (whose
uploads copy from pageable memory while tiles warm up) and two served lanes
with reductions on one card.  It needs a card and skips without one; it
imports no JAX, so it runs where the card is::

    python -m pytest -q -m cuda tests/test_torch_tile_graph_cuda.py

``chip_smoke.py`` phases 6 and 7 run the same graphs at full size.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.tile_graph import TileGraphs  # noqa: E402
from repro_torch.kernels import star2d_kernel  # noqa: E402

HEAT = (256, 64)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _eager(self, tile, slots, origins):
    return self.engine.run_tile(tile, slots, origins)


def _heat_dats(seed=5):
    rng = np.random.default_rng(seed)
    u = np.zeros(tuple(s + 2 for s in HEAT), np.float32)
    u[1:-1, 1:-1] = rng.random(HEAT, dtype=np.float32)
    return T.datasets_from_numpy(T.Block("grid", HEAT), {"u": u, "tmp": np.zeros_like(u)},
                                 halo=1)


def _heat_rounds(sess, dats):
    """Two rounds of three diffusion steps, each round ending in a sum and
    a min read on the host; returns the reductions of each round."""
    u, tmp = dats["u"], dats["tmp"]
    box = tuple((1, s - 1) for s in HEAT)
    reds = []
    for r in range(2):
        for s in range(3):
            sess.par_loop(f"diffuse{s}", u.block, box, [u, tmp],
                          star2d_kernel("u", "tmp", (0.0, 0.25, 0.25)))
            sess.par_loop(f"commit{s}", u.block, box, [tmp, u],
                          lambda acc: {"u": acc("tmp")})
        sess.par_loop("summary", u.block, box, [u],
                      lambda acc: {"usum": acc("u").sum(), "umin": acc("u").min()},
                      reductions=[T.ReductionSpec("usum"), T.ReductionSpec("umin", "min")])
        reds.append((float(sess.reduction("usum")), float(sess.reduction("umin"))))
    return reds


def _heat(backend, num_slots=3, **kw):
    dats = _heat_dats()
    for d in dats.values():
        d.pin()
    sess = T.Session(backend, device="cuda", num_tiles=16, num_slots=num_slots,
                     capacity_bytes=float("inf"), cyclic=True, prefetch=True, **kw)
    reds = _heat_rounds(sess, dats)[-1]
    sess.close()
    return {n: d.to_numpy() for n, d in dats.items()}, reds, sess.history


def _app(name, backend):
    # sizes and tile counts at which the timestep chains replay too
    app, tiles = {"cloverleaf2d": lambda: (TA.CloverLeaf2D(256, 24, summary_every=2), 16),
                  "cloverleaf3d": lambda: (TA.CloverLeaf3D(32, 12, 10, summary_every=2), 8),
                  "opensbli": lambda: (TA.OpenSBLI(24, chain_steps=2), 8)}[name]()
    for d in app.dats.values():
        d.pin()
    sess = T.Session(backend, device="cuda", num_tiles=tiles, capacity_bytes=float("inf"),
                     prefetch=True)
    summary = app.run(sess, steps=2)
    sess.close()
    return {n: d.to_numpy() for n, d in app.dats.items()}, summary, sess.history


def _run(name, backend):
    return _heat(backend) if name == "heat" else _app(name, backend)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ooc", "ooc-async"])
@pytest.mark.parametrize("name", ["heat", "cloverleaf2d", "cloverleaf3d", "opensbli"])
def test_every_replay_equals_the_eager_tile_function(name, backend, monkeypatch):
    _needs_card()
    monkeypatch.setattr(TileGraphs, "check_replays", True)
    homes, summary, hist = _run(name, backend)
    replays = sum(h.graph_replays for h in hist)
    assert replays > 0 and sum(h.graph_checked for h in hist) == replays
    for h in hist:
        assert h.graph_warmups + h.graph_replays == h.num_tiles
        assert h.graph_captures <= h.graph_warmups
        assert h.graph_pool_bytes >= 0 and h.graph_capture_s >= 0
    monkeypatch.setattr(TileGraphs, "check_replays", False)
    monkeypatch.setattr(TileGraphs, "__call__", _eager)
    want_homes, want_summary, want_hist = _run(name, backend)
    assert sum(h.graph_replays for h in want_hist) == 0
    assert summary == want_summary
    for n in want_homes:
        assert np.array_equal(homes[n], want_homes[n]), n


@pytest.mark.cuda
def test_one_slot_pool_replays_equal_eager(monkeypatch):
    _needs_card()
    monkeypatch.setattr(TileGraphs, "check_replays", True)
    homes, reds, hist = _heat("ooc", num_slots=1)
    assert sum(h.graph_replays for h in hist) > 0
    monkeypatch.setattr(TileGraphs, "__call__", _eager)
    want, want_reds, _ = _heat("ooc", num_slots=1)
    assert reds == want_reds and all(np.array_equal(homes[n], want[n]) for n in want)


@pytest.mark.cuda
def test_a_replaced_slot_tensor_is_refused():
    _needs_card()
    blk = T.Block("g", (64, 16))
    u = T.make_dataset(blk, "u", halo=1)
    t = T.make_dataset(blk, "tmp", halo=1)
    sess = T.Session("ooc", device="cuda", num_tiles=8, capacity_bytes=float("inf"))
    sess.par_loop("copy", blk, ((0, 64), (0, 16)), [u, t],
                  lambda acc: {"tmp": acc("u") + 1.0})
    cp = sess.backend.plan_chain(sess.queue)
    slots = {n: torch.zeros((cp.sched.max_fp_len[n], 18), device="cuda")
             for n in ("u", "tmp")}
    origins = [dict(o) for o in cp.ir.tile_origins]
    graphs = TileGraphs(cp.engine, torch.device("cuda"), slots.values(),
                        torch.cuda.MemPool())
    try:
        tiles = cp.sched.tiles
        i = next(i for i in range(1, len(tiles))
                 if cp.engine.graph_key(tiles[i], slots, origins[i])
                 == cp.engine.graph_key(tiles[i - 1], slots, origins[i - 1]))
        graphs(tiles[i - 1], slots, origins[i - 1])
        graphs(tiles[i], slots, origins[i])
        assert (graphs.warmups, graphs.captures, graphs.replays) == (1, 1, 1)
        other = dict(slots, tmp=slots["tmp"].clone())
        with pytest.raises(ValueError, match="slot tensors they were made with"):
            graphs(tiles[i], other, origins[i])
        torch.cuda.synchronize()
    finally:
        graphs.release()
    with pytest.raises(RuntimeError, match="after release"):
        graphs(tiles[i], slots, origins[i])


def _scaled(sess, dats, scale):
    u, tmp = dats["u"], dats["tmp"]
    box = tuple((1, s - 1) for s in HEAT)
    sess.par_loop("scale", u.block, box, [u, tmp],
                  lambda acc: {"tmp": scale * acc("u") + 0.25 * acc("u", (1, 0))})
    sess.par_loop("commit", u.block, box, [tmp, u], lambda acc: {"u": acc("tmp")})
    sess.flush()


@pytest.mark.cuda
def test_a_captured_scalar_changed_between_runs_equals_eager(monkeypatch):
    """The counterpart of CloverLeaf's ``dt``, which changes every step at
    full size: a new scalar makes a new plan, whose run captures anew."""
    _needs_card()

    def runs():
        dats = _heat_dats()
        sess = T.Session("ooc", device="cuda", num_tiles=16, capacity_bytes=float("inf"))
        out = []
        for scale in (0.5, 2.0, 0.5):
            _scaled(sess, dats, scale)
            out.append(dats["u"].to_numpy())
        sess.close()
        return out, sess.history

    monkeypatch.setattr(TileGraphs, "check_replays", True)
    got, hist = runs()
    assert all(h.graph_replays > 0 and h.graph_checked == h.graph_replays for h in hist)
    monkeypatch.setattr(TileGraphs, "__call__", _eager)
    want, _ = runs()
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert not np.array_equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ooc", "ooc-async"])
def test_a_wire_codec_run_replays_equal_eager(backend, monkeypatch):
    """bf16 on the wire: each upload decodes on the host and copies from
    pageable memory, in the lanes' threads while the compute stream warms
    up, captures and replays tiles."""
    _needs_card()
    monkeypatch.setattr(TileGraphs, "check_replays", True)
    homes, reds, hist = _heat(backend, codec="bf16")
    replays = sum(h.graph_replays for h in hist)
    assert replays > 0 and sum(h.graph_checked for h in hist) == replays
    monkeypatch.setattr(TileGraphs, "check_replays", False)
    monkeypatch.setattr(TileGraphs, "__call__", _eager)
    want, want_reds, _ = _heat(backend, codec="bf16")
    assert reds == want_reds and all(np.array_equal(homes[n], want[n]) for n in want)


@pytest.mark.cuda
def test_two_served_lanes_with_reductions_equal_eager(monkeypatch):
    """Two tenants on two lanes of one card, each on its own homes: one
    lane's tiles warm up, capture and replay while the other reads its
    reductions back and copies."""
    _needs_card()
    from repro_torch.serve import StencilServer

    def served():
        out, errors = {}, []
        with StencilServer("sim:2", device="cuda", num_tiles=16,
                           capacity_bytes=float("inf"), prefetch=True) as srv:
            def tenant(seed):
                try:
                    rt = srv.session(f"t{seed}")
                    rt.cyclic = True
                    dats = _heat_dats(seed)
                    reds = _heat_rounds(rt, dats)
                    rt.close()
                    out[seed] = (reds, {n: d.to_numpy() for n, d in dats.items()},
                                 rt.history)
                except Exception as e:  # raised after the join
                    errors.append((seed, e))

            threads = [threading.Thread(target=tenant, args=(seed,)) for seed in (1, 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        return out

    monkeypatch.setattr(TileGraphs, "check_replays", True)
    got = served()
    for seed, (_, _, hist) in got.items():
        replays = sum(h.graph_replays for h in hist)
        assert replays > 0 and sum(h.graph_checked for h in hist) == replays, seed
    monkeypatch.setattr(TileGraphs, "check_replays", False)
    monkeypatch.setattr(TileGraphs, "__call__", _eager)
    want = served()
    for seed in (1, 2):
        assert got[seed][0] == want[seed][0], seed
        for n in want[seed][1]:
            assert np.array_equal(got[seed][1][n], want[seed][1][n]), (seed, n)
    assert got[1][0] != got[2][0]
