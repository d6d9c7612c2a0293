"""The tile function's workspace charged to the out-of-core plan.

``repro_torch/core/workspace.py`` traces what the port's eager tile
function creates beyond the slot tensors (on the ``meta`` device) and the
executor charges it, with the allocator's rounding, before it picks a tile
count.  Here, on the CPU, for heat, CloverLeaf 2D, CloverLeaf 3D and
OpenSBLI at a third of their homes:

* every tile's slots, pinned residency and the bytes its tile function
  really created (the same :class:`LiveBytes` tracker around the real CPU
  tiles) fit the capacity (the parent package's plans broke it);
* the fields equal the JAX ``reference``'s at the reference's tolerances
  (fields rtol 1e-4 / atol 1e-5, summaries rtol 1e-3), and ``ooc-async`` is
  bit-identical to ``ooc`` (heat and CloverLeaf 2D, the main path);
* each chain that plans unsplit plans byte-equal to the JAX package at the
  port's tile count;
* a timestep whose ``dt`` changed traces nothing and searches no count;
* the admission oracle rejects a tenant whose slots fit but whose slots and
  workspace do not, and predicts the footprint the executor charges.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import star2d_kernel as jax_star2d  # noqa: E402
from repro_torch.core import executor as executor_mod  # noqa: E402
from repro_torch.core import workspace as workspace_mod  # noqa: E402
from repro_torch.core.engine import TileEngine  # noqa: E402
from repro_torch.core.tiling import choose_num_tiles, make_tile_schedule  # noqa: E402
from repro_torch.core.workspace import LiveBytes, device_bytes  # noqa: E402
from repro_torch.kernels import star2d_kernel as torch_star2d  # noqa: E402
from repro_torch.serve import AdmissionError, StencilServer  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
RED = dict(rtol=1e-3)
HEAT = (256, 32)
CPU = dict(device="cpu")

# (make the app in a package, the fields it carries)
APPS = {
    "cloverleaf2d": (lambda A: A.CloverLeaf2D(40, 32, summary_every=1),
                     ("density0", "energy0", "xvel0", "yvel0")),
    "cloverleaf3d": (lambda A: A.CloverLeaf3D(14, 12, 10, summary_every=1),
                     ("density0", "energy0", "xvel0", "yvel0", "zvel0")),
    "opensbli": (lambda A: A.OpenSBLI(16, chain_steps=1),
                 ("rho", "rhou", "rhov", "rhow", "rhoE")),
}


# -- the programs -----------------------------------------------------------------


def _heat_homes():
    rng = np.random.default_rng(3)
    u = np.zeros(tuple(s + 2 for s in HEAT), np.float32)
    u[1:-1, 1:-1] = rng.random(HEAT, dtype=np.float32)
    return {"u": u, "tmp": np.zeros_like(u)}


def _heat_record(C, star, sess, dats, steps=3):
    u, tmp = dats["u"], dats["tmp"]
    blk = u.block
    box = tuple((1, s - 1) for s in blk.size)
    for s in range(steps):
        sess.par_loop(f"diffuse{s}", blk, box, [u, tmp], star("u", "tmp", (0.0, 0.25, 0.25)))
        sess.par_loop(f"commit{s}", blk, box, [tmp, u], lambda acc: {"u": acc("tmp")})
    sess.par_loop("summary", blk, box, [u],
                  lambda acc: {"usum": acc("u").sum(), "umin": acc("u").min()},
                  reductions=[C.ReductionSpec("usum"), C.ReductionSpec("umin", "min")])


def _heat(pkg, backend, **kw):
    """(fields, summary, session) of the heat program."""
    homes = _heat_homes()
    if pkg is J:
        blk = J.Block("grid", HEAT)
        dats = {n: J.make_dataset(blk, n, halo=1, init=a) for n, a in homes.items()}
        sess, star = J.Session(backend, **kw), jax_star2d
    else:
        dats = T.datasets_from_numpy(T.Block("grid", HEAT), homes, halo=1)
        sess, star = T.Session(backend, **CPU, **kw), torch_star2d
    _heat_record(pkg, star, sess, dats)
    fields = {"u": np.array(sess.fetch(dats["u"]))}
    summary = {n: float(sess.reduction(n)) for n in ("usum", "umin")}
    return fields, summary, sess


def _third(name):
    if name == "heat":
        return sum(a.nbytes for a in _heat_homes().values()) / 3
    return APPS[name][0](TA).total_bytes() / 3


def _run(pkg, name, backend, **kw):
    """(fields, summary, session): ``name`` through one timestep."""
    if name == "heat":
        return _heat(pkg, backend, **kw)
    make, carried = APPS[name]
    app = make(JA if pkg is J else TA)
    sess = pkg.Session(backend, **kw) if pkg is J else T.Session(backend, **CPU, **kw)
    summary = app.run(sess, steps=1)
    return {n: np.array(app.d(n).interior()) for n in carried}, summary, sess


def _tracked(monkeypatch):
    """Record, for every real tile, the bytes its tile function created and
    the plan it ran under (slots, pinned residency)."""
    planned, tiles = {}, []
    plan_chain, run_tile = executor_mod.OutOfCoreExecutor.plan_chain, TileEngine.run_tile

    def plan(self, *args, **kwargs):
        cp = plan_chain(self, *args, **kwargs)
        planned[id(cp.engine)] = (cp.ir.num_slots * cp.slot_bytes + cp.pinned_bytes,
                                  getattr(cp, "workspace_bytes", 0))
        return cp

    def tile(self, *args, **kwargs):
        mode = LiveBytes()
        with mode:
            out = run_tile(self, *args, **kwargs)
        tiles.append((planned[id(self)], mode.peak))
        return out

    monkeypatch.setattr(executor_mod.OutOfCoreExecutor, "plan_chain", plan)
    monkeypatch.setattr(TileEngine, "run_tile", tile)
    return tiles


NAMES = ["heat", *sorted(APPS)]
ASYNC = ("heat", "cloverleaf2d")


@pytest.fixture(scope="module", params=NAMES)
def runs(request):
    name = request.param
    cap = _third(name)
    with pytest.MonkeyPatch.context() as mp:
        tiles = _tracked(mp)
        ooc = _run(T, name, "ooc", capacity_bytes=cap, prefetch=True)
    return {"name": name, "cap": cap, "tiles": tiles, "ooc": ooc,
            "async": (_run(T, name, "ooc-async", capacity_bytes=cap, prefetch=True)
                      if name in ASYNC else None),
            "reference": _run(J, name, "reference")}


# -- the charge holds ------------------------------------------------------------------


def test_every_tile_fits_its_capacity(runs):
    """Slots, pinned residency and what the tile function really created
    fit the capacity on every tile; the charge covers what was created."""
    cap, tiles = runs["cap"], runs["tiles"]
    assert tiles and any(peak > 0 for _, peak in tiles)
    assert any(h.num_tiles > 1 for h in runs["ooc"][2].history)
    for (resident, charged), peak in tiles:
        assert resident + peak <= cap, (runs["name"], resident, peak, cap)
        assert peak <= charged


def test_fields_match_jax_reference(runs):
    got, want = runs["ooc"], runs["reference"]
    for n, a in want[0].items():
        assert np.isfinite(got[0][n]).all(), n
        np.testing.assert_allclose(got[0][n], a, **FIELD, err_msg=n)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], **RED, err_msg=k)


def test_ooc_async_bit_identical_to_ooc(runs):
    if runs["async"] is None:
        return   # held on heat and CloverLeaf 2D (the tier-1 run's time)
    a, b = runs["ooc"], runs["async"]
    for n in a[0]:
        assert torch.equal(torch.from_numpy(a[0][n]), torch.from_numpy(b[0][n])), n
    assert a[1] == b[1]
    assert [h.num_tiles for h in a[2].history] == [h.num_tiles for h in b[2].history]


# -- the plans ------------------------------------------------------------------------


def _plans(pkg, name, **kw):
    """{chain: plans} of the app's init chain and first timestep (heat: its
    one chain), previewed on ``sim``."""
    if name == "heat":
        homes = _heat_homes()
        if pkg is J:
            blk = J.Block("grid", HEAT)
            dats = {n: J.make_dataset(blk, n, halo=1, init=a) for n, a in homes.items()}
            sess, star = J.Session("sim", **kw), jax_star2d
        else:
            dats = T.datasets_from_numpy(T.Block("grid", HEAT), homes, halo=1)
            sess, star = T.Session("sim", **CPU, **kw), torch_star2d
        _heat_record(pkg, star, sess, dats)
        return {"heat": sess.plan()}
    app = APPS[name][0](JA if pkg is J else TA)
    sess = pkg.Session("sim", **kw) if pkg is J else T.Session("sim", **CPU, **kw)
    app.record_init(sess)
    out = {"init": sess.plan()}
    sess.flush()
    sess.cyclic = True
    if name != "opensbli":
        app.dt = 1e-4
    app.record_timestep(sess)
    out["step"] = sess.plan()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_unsplit_plans_byte_equal_to_jax_at_the_ports_tile_count(name):
    got = _plans(T, name, hw="p100-pcie", capacity_bytes=_third(name))
    unsplit = {c: plans[0] for c, plans in got.items() if len(plans) == 1}
    assert unsplit, f"{name}: no chain planned unsplit"
    for chain, plan in unsplit.items():
        want = _plans(J, name, hw=J.P100_PCIE, num_tiles=plan.num_tiles,
                      capacity_bytes=float("inf"))[chain]
        assert T.plans_to_json([plan]) == J.plans_to_json(want), (name, chain)


# -- the memo -------------------------------------------------------------------------


def test_a_new_dt_traces_no_workspace_and_searches_no_tile_count(monkeypatch):
    calls = {"trace": 0, "search": 0}
    measure = workspace_mod.measure_tile

    def traced(*args, **kwargs):
        calls["trace"] += 1
        return measure(*args, **kwargs)

    def searched(*args, **kwargs):
        calls["search"] += 1
        return choose_num_tiles(*args, **kwargs)

    monkeypatch.setattr(workspace_mod, "measure_tile", traced)
    monkeypatch.setattr(workspace_mod, "choose_num_tiles", searched)
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    sess = T.Session("sim", hw="p100-pcie", capacity_bytes=app.total_bytes() / 2, **CPU)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    for step in range(3):          # the sweep order alternates: x-y, y-x, x-y
        if step == 2:
            seen, misses = dict(calls), sess.backend.plan_misses
            assert seen["trace"] > 0 and seen["search"] > 0
        app.dt = 1e-4 * (step + 1)
        app.record_timestep(sess)
        sess.flush()
    assert sess.backend.plan_misses > misses       # a new plan: dt is captured
    assert calls == seen


# -- the tracker ----------------------------------------------------------------------


def test_live_bytes_counts_new_storages_once_and_releases_them():
    base = torch.zeros(1000)
    mode = LiveBytes()
    with mode:
        a = base * 2                 # new: 4,000 B -> 4,096
        v = a[10:]                   # a view: nothing
        a.add_(1)                    # in place: nothing
        b = torch.empty(3_000_000)   # 12 MB
        del b
        c = v + base[10:]            # 3,960 B -> 4,096
    assert mode.peak == 4096 + device_bytes(12_000_000)
    assert mode.live == 2 * 4096
    mib = 1 << 20
    assert device_bytes(1) == 512 and device_bytes(mib) == mib
    assert device_bytes(2 * mib + 1) == 2 * mib + 512 + mib         # remainder kept
    assert device_bytes(10 * mib + 1) == 12 * mib                   # own segment
    assert device_bytes(12_000_000) == 12_000_256 + mib
    del a, v, c


# -- the admission oracle ---------------------------------------------------------------


def test_oracle_rejects_a_tenant_whose_slots_fit_but_not_with_its_workspace():
    """One diffusion loop (no chain to split) at a capacity its slots fit
    at some tile count, but not beside the tile function's workspace: the
    port rejects it at submission; the JAX oracle, which charges slots
    only, admits it."""
    n, m = 64, 32
    homes = _heat_homes()
    homes = {k: a[: n + 2, : m + 2].copy() for k, a in homes.items()}

    def record(C, star, rt, dats):
        u, tmp = dats["u"], dats["tmp"]
        rt.par_loop("diffuse", u.block, ((1, n - 1), (1, m - 1)), [u, tmp],
                    star("u", "tmp", (0.0, 0.25, 0.25)))

    sess = T.Session("sim", hw="p100-pcie", capacity_bytes=float("inf"), **CPU)
    record(T, torch_star2d, sess, T.datasets_from_numpy(T.Block("g", (n, m)), homes, halo=1))
    info = sess.backend.plan_chain(list(sess.queue)).info
    # the slots' least size, and less room beside it than one 512-byte block
    cap = 3 * make_tile_schedule(info, 4096).slot_bytes() + 256
    assert choose_num_tiles(info, cap) > 1      # the slots alone fit
    with StencilServer("sim:1", hw="p100-pcie", capacity_bytes=cap, **CPU) as srv:
        rt = srv.session("t")
        with pytest.raises(AdmissionError):
            record(T, torch_star2d, rt,
                   T.datasets_from_numpy(T.Block("g", (n, m)), homes, halo=1))
            rt.flush()
        rt.queue.clear()
        rt.close()
    blk = J.Block("g", (n, m))
    jdats = {k: J.make_dataset(blk, k, halo=1, init=a) for k, a in homes.items()}
    jsess = J.Session("sim", hw=J.P100_PCIE)
    record(J, jax_star2d, jsess, jdats)
    oracle = JS.AdmissionOracle(J.ExecutionConfig(hw=J.P100_PCIE, capacity_bytes=cap),
                                JS.SharedPlanCache())
    assert oracle.predict(list(jsess.queue)).admitted


def test_oracle_predicts_the_footprint_the_executor_charges():
    app = TA.CloverLeaf2D(24, 24, summary_every=0)
    cap = app.total_bytes() / 2
    with StencilServer("sim:1", hw="p100-pcie", capacity_bytes=cap, **CPU) as srv:
        oracle = srv.oracle
        sess = T.Session("sim", hw="p100-pcie", capacity_bytes=cap, **CPU)
        app.record_init(sess)
        loops = list(sess.queue)
        verdict = oracle.predict(loops)
        cp = sess.backend.plan_chain(loops)
    assert verdict.admitted and verdict.chains == 1 and cp.workspace_bytes > 0
    assert verdict.predicted_bytes == (cp.ir.num_slots * cp.slot_bytes + cp.pinned_bytes
                                       + cp.workspace_bytes) <= cap
