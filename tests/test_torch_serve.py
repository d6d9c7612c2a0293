"""The port's serving layer (``repro_torch.serve``) against its own serial
runs and against the JAX package's ``repro.serve``.

Everything runs on ``sim:N`` lane pools of data-plane executors on the CPU
(``device="cpu"``; on the card ``chip_smoke.py --serve`` runs the same path).
The load-bearing property: concurrency and scheduling move wall-clock time
only, so every tenant is bit-identical to its serial port run — under both
policies, after a preemption, and when it adopts another tenant's plan.
Against the JAX package: a served CloverLeaf 2D tenant matches JAX
``reference`` (fields rtol 1e-4 / atol 1e-5, summaries rtol 1e-3, the
reference's own tolerances), the oracle's verdict equals the JAX oracle's on
unsplit chains, and a preemption checkpoint loads into JAX datasets.
"""
import hashlib
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402
from repro.core.store import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro_torch.core.interp import predict_plans  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AdmissionOracle,
    JobView,
    ServeError,
    SharedPlanCache,
    StencilServer,
    available_policies,
    make_policy,
)

CAP = 2e6   # small enough to force real multi-tile streaming on test grids
CPU = dict(device="cpu")
FIELD = dict(rtol=1e-4, atol=1e-5)
RED = dict(rtol=1e-3)
JOIN_S = 120

_WORKLOADS = [
    ("cl2d-a", lambda: TA.CloverLeaf2D(nx=24, ny=24, summary_every=2), 2),
    ("cl2d-b", lambda: TA.CloverLeaf2D(nx=24, ny=24, summary_every=2), 2),
    ("cl3d", lambda: TA.CloverLeaf3D(nx=10, ny=10, nz=10, summary_every=2), 2),
    ("osbli", lambda: TA.OpenSBLI(n=12), 2),
]


def _homes(app):
    """Every dataset's whole padded home, as a digest."""
    return {n: hashlib.sha1(np.ascontiguousarray(d.materialize())).hexdigest()
            for n, d in app.dats.items()}


def _serial(factory, steps, **kw):
    app = factory()
    rt = app.make_session("ooc", capacity_bytes=CAP, **CPU, **kw)
    try:
        return app.run(rt, steps=steps), _homes(app)
    finally:
        rt.close()


def _threads(work, items):
    """Run ``work(*item)`` for each item in its own thread; re-raise the
    first failure after all have joined."""
    errs = []

    def guarded(*a):
        try:
            work(*a)
        except Exception as e:  # surfaced after join
            errs.append((a[0], e))

    threads = [threading.Thread(target=guarded, args=it) for it in items]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a tenant thread hung"
    assert not errs, f"tenant failures: {errs}"


@pytest.fixture(scope="module")
def serial_results():
    """Ground truth, computed once: each workload alone on a plain ooc
    Session of the port."""
    return {name: _serial(factory, steps) for name, factory, steps in _WORKLOADS}


# -- concurrent determinism ---------------------------------------------------------


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_tenants_bit_identical_to_serial(policy, serial_results):
    """Four mixed-app tenants (two identical CloverLeaf 2D) submitted from
    threads onto one sim:2 pool: every home bit-identical to the serial
    run, plans shared across the identical tenants."""
    outs = {}
    with StencilServer("sim:2", policy=policy, capacity_bytes=CAP, **CPU) as srv:
        def work(name, factory, steps):
            app = factory()
            rt = srv.session(name)
            try:
                outs[name] = (app.run(rt, steps=steps), _homes(app))
            finally:
                rt.close()

        _threads(work, _WORKLOADS)
        st = srv.stats()
        assert st.cross_tenant_plan_hits > 0
        assert st.jobs_completed >= len(_WORKLOADS) and st.jobs_rejected == 0
        for name, t in st.tenants.items():
            assert t.achieved_modelled_s == pytest.approx(t.predicted_s, rel=0.5), name
    for name, _, _ in _WORKLOADS:
        assert outs[name] == serial_results[name], name


@pytest.fixture(scope="module")
def jax_cl2d():
    app = JA.CloverLeaf2D(nx=24, ny=24, summary_every=2)
    summary = app.run(J.Session("reference"), steps=2)
    return app, summary


def test_served_tenant_matches_jax_reference(jax_cl2d, serial_results):
    want_app, want = jax_cl2d
    with StencilServer("sim:2", capacity_bytes=CAP, **CPU) as srv:
        app = TA.CloverLeaf2D(nx=24, ny=24, summary_every=2)
        rt = srv.session("solo")
        got = app.run(rt, steps=2)
        rt.close()
    assert (got, _homes(app)) == serial_results["cl2d-a"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **RED, err_msg=k)
    for n in ("density0", "energy0", "xvel0", "yvel0"):
        np.testing.assert_allclose(app.d(n).interior(),
                                   np.asarray(want_app.d(n).interior()),
                                   **FIELD, err_msg=n)


# -- the admission oracle against the JAX package's --------------------------------


def _chains(C, app, **kw):
    """The init chain and one timestep chain, recorded, not run."""
    sess = C.Session("sim", **kw)
    app.record_init(sess)
    init = list(sess.queue)
    sess.queue.clear()
    app.dt = 1e-4
    app.record_timestep(sess)
    return init, list(sess.queue)


def _verdict(v):
    return (v.admitted, v.predicted_makespan_s, v.predicted_bytes, v.chains)


def _oracles(cap):
    port = AdmissionOracle(T.ExecutionConfig(hw="p100-pcie", capacity_bytes=cap,
                                             **CPU), SharedPlanCache())
    ref = JS.AdmissionOracle(J.ExecutionConfig(hw="p100-pcie", capacity_bytes=cap),
                             JS.SharedPlanCache())
    return port, ref


@pytest.mark.parametrize("cyclic", [False, True])
def test_oracle_equals_jax_oracle_unsplit(cyclic):
    port, ref = _oracles(CAP)
    jax_chains = _chains(J, JA.CloverLeaf2D(24, 24, summary_every=0))
    port_chains = _chains(T, TA.CloverLeaf2D(24, 24, summary_every=0), **CPU)
    for jl, tl in zip(jax_chains, port_chains):
        # the JAX package's footprint: slots and pinned residency only
        # (tests/_torch_reference_tiles.py)
        with reference_tiles():
            got = port.predict(tl, cyclic=cyclic, tenant="t")
        assert got.admitted and got.chains == 1
        assert _verdict(got) == _verdict(ref.predict(jl, cyclic=cyclic))


def test_oracle_predicts_the_ports_own_split():
    """A CloverLeaf 2D timestep chain at a third of its homes splits into
    six.  Under Cyclic the port keeps the whole chain's read-first datasets
    live in both halves (fault C1), so its verdict is the port's own split
    plans, which differ from the JAX oracle's."""
    app = TA.CloverLeaf2D(40, 32, summary_every=0)
    cap = app.total_bytes() / 3
    port, ref = _oracles(cap)
    step = _chains(T, app, **CPU)[1]
    # the JAX package's tile counts (tests/_torch_reference_tiles.py): the
    # splits differ by C1 alone
    with reference_tiles():
        got = port.predict(step, cyclic=True, tenant="t")
        sess = T.Session("sim", hw="p100-pcie", capacity_bytes=cap, cyclic=True, **CPU)
        plans = sess.plan(step)
    assert got.admitted and got.chains == len(plans) > 1
    assert (got.predicted_makespan_s, got.predicted_bytes) == predict_plans(
        plans, sess.config.hw)
    want = ref.predict(_chains(J, JA.CloverLeaf2D(40, 32, summary_every=0))[1],
                       cyclic=True)
    assert want.chains == got.chains
    assert want.predicted_makespan_s != got.predicted_makespan_s


# -- shared plans: the adopter's engine is the donor's ------------------------------


def _diffuse(acc):
    u = acc("u")
    return {"tmp": 0.5 * u + 0.125 * (acc("u", (1, 0)) + acc("u", (-1, 0))
                                      + acc("u", (0, 1)) + acc("u", (0, -1)))}


def _commit(acc):
    return {"u": acc("tmp")}


def _total(acc):
    return {"usum": acc("u").sum(), "umax": acc("u").max()}


def _heat(rt, seed, rounds=3, steps=2, n=48, m=24):
    """The heat chain (module-level kernels, so two tenants' kernels
    fingerprint equal) on homes from ``seed``, flushed ``rounds`` times."""
    blk = T.Block("grid", (n, m))
    rng = np.random.default_rng(seed)
    u = T.make_dataset(blk, "u", halo=1, init=rng.random((n, m), dtype=np.float32))
    tmp = T.make_dataset(blk, "tmp", halo=1)
    inner = ((1, n - 1), (1, m - 1))
    reds = []
    rt.cyclic = True
    for _ in range(rounds):
        for s in range(steps):
            rt.par_loop(f"diffuse{s}", blk, inner, [u, tmp], _diffuse)
            rt.par_loop(f"commit{s}", blk, inner, [tmp, u], _commit)
        rt.par_loop("total", blk, inner, [u], _total,
                    reductions=[T.ReductionSpec("usum"), T.ReductionSpec("umax", "max")])
        reds.append((float(rt.reduction("usum")), float(rt.reduction("umax"))))
    return reds, u.materialize().copy()


# 0.7 of the homes: multi-tile, with room for the tile function's workspace
# (a third before it was charged; core/workspace.py)
HEAT = dict(hw="p100-pcie", capacity_bytes=2 * 50 * 26 * 4 * 0.7, prefetch=True)


@pytest.mark.parametrize("mesh", ["sim:1", "sim:2"])
def test_adopter_and_donor_with_different_data_each_match_serial(mesh):
    """Two tenants run the same heat chain on different homes: the plan
    (and its engine) is shared, the data is not.  On ``sim:1`` they
    alternate on one lane, so a prefetch capture of one tenant must never
    feed the other."""
    want = {}
    for seed in (1, 2):
        sess = T.Session("ooc", **HEAT, **CPU)
        want[seed] = _heat(sess, seed)
        assert all(h.num_tiles > 1 for h in sess.history)
        sess.close()
    got = {}
    with StencilServer(mesh, **HEAT, **CPU) as srv:
        def work(seed):
            rt = srv.session(f"t{seed}")
            try:
                got[seed] = _heat(rt, seed)
            finally:
                rt.close()

        _threads(work, [(1,), (2,)])
        st = srv.stats()
        engines = [cp.engine for lane in srv.lanes for cp in lane._plans.values()]
        assert st.cross_tenant_plan_hits > 0
        assert len({id(e) for e in engines}) < len(engines)
    for seed in (1, 2):
        assert got[seed][0] == want[seed][0], seed
        assert torch.equal(torch.from_numpy(got[seed][1]),
                           torch.from_numpy(want[seed][1])), seed
    assert got[1][0] != got[2][0]


def test_more_tenant_threads_than_cores_lose_no_job():
    """More tenant threads than cores, the interpreter switching threads
    far more often than by default: every job runs once, and every tenant
    equals its serial run."""
    seeds = range((os.cpu_count() or 2) + 2)
    want = {}
    for seed in seeds:
        sess = T.Session("ooc", **HEAT, **CPU)
        want[seed] = _heat(sess, seed, rounds=2)
        sess.close()
    got = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with StencilServer("sim:2", policy="sjf", **HEAT, **CPU) as srv:
            def work(seed):
                rt = srv.session(f"t{seed}", priority=seed % 3)
                try:
                    got[seed] = _heat(rt, seed, rounds=2)
                finally:
                    rt.close()

            _threads(work, [(seed,) for seed in seeds])
            st = srv.stats()
    finally:
        sys.setswitchinterval(interval)
    assert st.jobs_completed == 2 * len(seeds) == sum(t.chains for t in st.tenants.values())
    for seed in seeds:
        assert got[seed][0] == want[seed][0], seed
        assert torch.equal(torch.from_numpy(got[seed][1]),
                           torch.from_numpy(want[seed][1])), seed


# -- preemption ----------------------------------------------------------------------


def test_preempt_resume_bit_identical_and_checkpoint_loads_in_jax(tmp_path):
    """A tenant preempted after its second chain checkpoints (format 1),
    re-queues and restores, and ends bit-identical to the serial run; its
    checkpoint loads into the JAX package's datasets as the homes it
    captured."""
    want = _serial(lambda: TA.CloverLeaf2D(nx=24, ny=24, summary_every=3), 3)
    with StencilServer("sim:2", capacity_bytes=CAP, spill_dir=str(tmp_path),
                       **CPU) as srv:
        app = TA.CloverLeaf2D(nx=24, ny=24, summary_every=3)
        rt = srv.session("victim")
        app.run(rt, steps=1)
        captured = {n: d.materialize().copy() for n, d in app.dats.items()}
        srv.preempt("victim")
        got = app.run_steps(rt, 1, 3)
        rt.close()
        st = srv.stats()
        assert st.preemptions == 1 and st.tenants["victim"].preemptions == 1
    assert (got, _homes(app)) == want
    jax_app = JA.CloverLeaf2D(nx=24, ny=24, summary_every=3)
    manifest = jax_load_checkpoint(str(tmp_path / "victim.preempt.npz"),
                                   jax_app.dats.values())
    # The checkpoint holds every dataset the tenant's chains had touched.
    assert manifest["format"] == 1 and 20 < len(manifest["datasets"]) <= len(captured)
    for n in manifest["datasets"]:
        np.testing.assert_array_equal(np.asarray(jax_app.dats[n].materialize()),
                                      captured[n], err_msg=n)


def test_auto_preempt_flags_lower_priority():
    """A high-priority tenant queued behind a busy one-lane pool flags the
    running low-priority tenant; both finish bit-identical to serial."""
    specs = {"lo": (0, lambda: TA.CloverLeaf2D(nx=24, ny=24, summary_every=3)),
             "hi": (5, lambda: TA.CloverLeaf2D(nx=20, ny=20, summary_every=3))}
    results = {}
    with StencilServer("sim:1", capacity_bytes=CAP, policy="fifo", **CPU) as srv:
        sessions = {k: srv.session(k, priority=p) for k, (p, _) in specs.items()}

        def work(name):
            app = specs[name][1]()
            results[name] = (app.run(sessions[name], steps=3), _homes(app))
            sessions[name].close()

        _threads(work, [("lo",), ("hi",)])
        assert srv.stats().jobs_completed > 0
    for name, (_, factory) in specs.items():
        assert results[name] == _serial(factory, 3), name


def test_session_restore_on_a_server_resets_the_lane(tmp_path):
    """``Session.checkpoint``/``restore``, ``history`` and ``trace`` through a
    ServerClient: a step replayed after a restore (prefetch on, so the lane
    holds captures of the later state) equals the step the first time."""
    with StencilServer("sim:1", capacity_bytes=CAP, prefetch=True, **CPU) as srv:
        app = TA.CloverLeaf2D(nx=24, ny=24, summary_every=0)
        rt = srv.session("t")
        app.run(rt, steps=1)
        ckpt = str(tmp_path / "t.npz")
        rt.checkpoint(ckpt)
        scalars = (app.dt, app.step_count)
        app.run_steps(rt, 1, 2)
        once = _homes(app)
        rt.restore(ckpt)
        app.dt, app.step_count = scalars
        rt.cyclic = True
        app.run_steps(rt, 1, 2)
        assert _homes(app) == once
        assert len(rt.history) == srv.stats().tenants["t"].chains
        assert rt.trace() is None
        rt.close()


# -- admission, the cache, lifecycle --------------------------------------------------


def test_admission_rejects_oversized_job_typed():
    with StencilServer("sim:1", capacity_bytes=1024, **CPU) as srv:
        app = TA.CloverLeaf2D(nx=64, ny=64, summary_every=1)
        rt = srv.session("big")
        with pytest.raises(AdmissionError) as ei:
            app.record_init(rt)
            rt.flush()
        assert isinstance(ei.value, ServeError)
        assert srv.stats().jobs_rejected == 1 and srv.stats().tenants["big"].rejected == 1
        rt.queue.clear()
        rt.close()


def test_admission_admits_and_predicts():
    with StencilServer("sim:1", capacity_bytes=CAP, **CPU) as srv:
        app = TA.CloverLeaf2D(nx=24, ny=24, summary_every=1)
        rt = srv.session("ok")
        app.record_init(rt)
        verdict = srv.oracle.predict(list(rt.queue), tenant="ok")
        assert verdict.admitted and verdict.predicted_makespan_s > 0
        assert 0 < verdict.predicted_bytes <= CAP
        rt.flush()
        assert set(srv.sla_estimate("ok")) == {
            "queued_jobs", "predicted_queue_wait_s", "predicted_makespan_s"}
        rt.close()


def test_shared_cache_lru_and_counters():
    cache = SharedPlanCache(max_plans=2)
    sentinel = object()
    for k in ("k1", "k2", "k3"):            # k3 evicts k1
        cache.insert((k,), sentinel, "a")
    assert len(cache) == 2
    assert cache.lookup(("k1",), "b") is None
    assert cache.lookup(("k2",), "b") is sentinel
    assert cache.cross_tenant_hits == 1
    assert cache.lookup(("k2",), "a") is sentinel
    assert cache.cross_tenant_hits == 1        # a same-tenant hit is not counted
    cache.insert(("k2",), object(), "b")       # first writer wins
    assert cache.lookup(("k2",), "c") is sentinel
    s = cache.stats()
    assert s["inserts"] == 3 and s["hits"] == 3 and s["misses"] == 1


def test_server_session_close_deregisters_and_duplicates_raise():
    with StencilServer("sim:1", capacity_bytes=CAP, **CPU) as srv:
        app = TA.CloverLeaf2D(nx=24, ny=24, summary_every=1)
        rt = srv.session("t")
        with pytest.raises(ServeError):
            srv.session("t")
        app.record_init(rt)
        rt.flush()
        backend = rt.backend
        rt.close()
        rt.close()
        assert srv.stats().tenants["t"].state == "closed"
        with pytest.raises(T.SessionClosedError):
            backend.run_chain([])
        srv.session("t").close()      # a closed tenant's name is reusable
        text = srv.stats().summary()
    assert "policy=fifo" in text and "cross-tenant" in text and "t:" in text


def test_policy_registry():
    assert {"fifo", "sjf"} <= set(available_policies())
    with pytest.raises(ValueError):
        make_policy("nope")
    a = JobView(tenant="a", seq=1, priority=0, predicted_makespan_s=5.0)
    b = JobView(tenant="b", seq=2, priority=0, predicted_makespan_s=1.0)
    c = JobView(tenant="c", seq=3, priority=9, predicted_makespan_s=9.0)
    assert make_policy("fifo").select([a, b]) is a
    assert make_policy("sjf").select([a, b]) is b
    assert make_policy("fifo").select([a, b, c]) is c
    assert make_policy("sjf").select([a, b, c]) is c


# -- lanes on devices ------------------------------------------------------------------


def test_cuda_mesh_lanes_bit_identical_to_sim(monkeypatch, serial_results):
    """``cuda:2`` puts lane i on ``torch_devices()[i]`` (faked as CPU
    devices here), each with its own executor; the tenants come out as on
    ``sim:2``.  The reference's ``jax:2`` raises, naming ``cuda:N``."""
    monkeypatch.setattr(T.DeviceMesh, "torch_devices",
                        lambda self: [torch.device("cpu")] * self.num_devices)
    outs = {}
    with StencilServer("cuda:2", capacity_bytes=CAP, **CPU) as srv:
        assert [lane.device.type for lane in srv.lanes] == ["cpu", "cpu"]
        assert srv.lane_streams == [None, None]

        def work(name, factory, steps):
            app = factory()
            rt = srv.session(name)
            outs[name] = (app.run(rt, steps=steps), _homes(app))
            rt.close()

        _threads(work, _WORKLOADS[:2])
    for name, _, _ in _WORKLOADS[:2]:
        assert outs[name] == serial_results[name], name
    with pytest.raises(T.MeshError, match="cuda:N"):
        StencilServer("jax:2", **CPU)


def test_launch_serve_stencil_on_the_cpu(capsys):
    assert launch_serve.main(["stencil", "--device", "cpu", "--tenants", "2",
                              "--nx", "24", "--ny", "24"]) == 0
    assert "cross-tenant plan hits" in capsys.readouterr().out
    assert launch_serve.main(["--arch", "x"]) != 0
    assert "unknown arch 'x'" in capsys.readouterr().err
    # model decode streams the dense and vlm families only
    assert launch_serve.main(["--arch", "mamba2_1_3b", "--reduced", "--device", "cpu",
                              "--offload"]) == 2
    assert "--offload supports dense/vlm families" in capsys.readouterr().err
