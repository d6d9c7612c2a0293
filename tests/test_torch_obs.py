"""The port's tracing spine end to end (ROADMAP A11): the drift audit's sim
oracle, bit-identity of traced runs, the serve layer's spans and metrics, and
the compute spans a CUDA data plane times with events.

Ported from ``tests/test_obs.py``.  The sim interpreter is its own oracle:
its spans are the simulated ledger events, so the audit's per-stream ratio
is exactly 1.0 — in the JAX package and in the port alike.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")


import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402
from repro_torch.core.interp import DataPlaneInterpreter  # noqa: E402
from repro_torch.obs import compare  # noqa: E402
from repro_torch.serve import StencilServer  # noqa: E402

CPU = dict(device="cpu")


def _sim_traced(C, app, **kw):
    sess = C.Session("sim", num_tiles=4, capacity_bytes=app.total_bytes() * 0.5,
                     trace=True, **kw)
    app.record_init(sess)
    sess.flush()
    app.dt = 1e-4
    app.record_timestep(sess)
    sess.flush()
    return sess


def test_sim_drift_audit_is_oracle_exact():
    # the JAX package's chains and tiles (tests/_torch_reference_tiles.py)
    with reference_tiles():
        sess = _sim_traced(T, TA.CloverLeaf2D(40, 24, summary_every=0), **CPU)
    jsess = _sim_traced(J, JA.CloverLeaf2D(40, 24, summary_every=0))
    tr = sess.trace()
    ledgers = sess.backend.ledgers
    assert len(ledgers) == len(sess.history) == len(jsess.backend.ledgers)
    seen = set()
    for ci, ledger in enumerate(ledgers):
        rep = compare(ledger, tr, chain=ci)
        want = JO.compare(jsess.backend.ledgers[ci], jsess.trace(), chain=ci)
        assert rep.unmatched_events == 0 and rep.overall_ratio == 1.0
        for sd in rep.streams.values():
            # Exact: the modelled spans are the simulated events.
            assert sd.ratio == 1.0 and sd.matched == sd.events, (ci, sd.name)
            assert sd.events == want.streams[sd.stream].events
            seen.add(sd.name)
        assert all(o.op >= 0 for o in rep.ops)
        assert rep.summary(top_k=3)
    assert {"compute", "upload", "download"} <= seen
    sess.close()
    jsess.close()


def test_drift_audit_tolerates_foreign_spans():
    sess = _sim_traced(T, TA.CloverLeaf2D(40, 24, summary_every=0), **CPU)
    tr = sess.trace()
    tr.emit("noise", cat="serve", track="tenant/x", t_start=0.0, t_end=9.9)
    rep = compare(sess.backend.ledgers[-1], tr,
                  chain=len(sess.backend.ledgers) - 1)
    assert rep.overall_ratio == 1.0
    sess.close()


@pytest.mark.parametrize("factory", [
    lambda: TA.CloverLeaf2D(32, 24, summary_every=0),
    lambda: TA.CloverLeaf3D(12, 10, 8, summary_every=0),
    lambda: TA.OpenSBLI(16),
], ids=["cloverleaf2d", "cloverleaf3d", "opensbli"])
def test_traced_run_bit_identical(factory):
    def run(trace):
        app = factory()
        sess = T.Session("ooc", num_tiles=2, capacity_bytes=float("inf"),
                         trace=trace, **CPU)
        try:
            app.record_init(sess)
            sess.flush()
            app.dt = 1e-4
            app.record_timestep(sess)
            sess.flush()
            return {k: d.materialize().copy() for k, d in app.dats.items()}
        finally:
            sess.close()

    plain, traced = run(False), run(True)
    assert set(plain) == set(traced)
    for k in plain:
        assert torch.equal(torch.from_numpy(plain[k]), torch.from_numpy(traced[k])), k


class _FakeEvent:
    """Stands in for a CUDA timing event: each one recorded is 1 ms after
    the previous one."""

    ticks = itertools.count()

    def __init__(self):
        self.t_ms = float(next(self.ticks))

    def elapsed_time(self, later):
        return later.t_ms - self.t_ms


def test_compute_spans_carry_device_time_from_events(monkeypatch):
    """Fed fake events, a traced data plane puts Compute and CarryEdge on
    the ``compute`` track at the anchor's time plus the events' elapsed
    time, with ``device_s`` and their ledger eids, and keeps their host
    dispatch on ``dispatch``.  On the card the events are CUDA's."""
    monkeypatch.setattr(DataPlaneInterpreter, "_record",
                        lambda self, timing=False: _FakeEvent() if timing else None)
    app = TA.CloverLeaf2D(32, 24, summary_every=0)
    sess = T.Session("ooc", num_tiles=3, capacity_bytes=float("inf"),
                     trace=True, **CPU)
    app.record_init(sess)
    sess.flush()
    app.dt = 1e-4
    app.record_timestep(sess)
    sess.flush()
    spans = [s for s in sess.trace().spans() if s.args and s.args.get("chain") == 1]
    dev = [s for s in spans if s.track == "compute"]
    assert {s.name for s in dev} == {"compute", "carry-edge"}
    assert len([s for s in dev if s.name == "compute"]) == 3
    for s in dev:
        assert s.args["device_s"] == pytest.approx(s.t_end - s.t_start)
        assert s.args["device_s"] > 0 and s.args["eids"]
    host = [s for s in spans if s.track == "dispatch"
            and s.name in ("compute", "carry-edge")]
    assert len(host) == len(dev) and not any("eids" in s.args for s in host)
    rep = compare(sess.backend.ledgers[1], sess.trace(), chain=1)
    assert rep.streams[0].matched == rep.streams[0].events
    assert rep.streams[0].achieved_s == pytest.approx(
        sum(s.args["device_s"] for s in dev))
    sess.close()


def test_untraced_run_records_no_event(monkeypatch):
    def refuse(self, timing=False):
        assert not timing, "an untraced run recorded a timing event"

    monkeypatch.setattr(DataPlaneInterpreter, "_record", refuse)
    app = TA.CloverLeaf2D(24, 16, summary_every=0)
    sess = T.Session("ooc", num_tiles=2, capacity_bytes=float("inf"), **CPU)
    app.record_init(sess)
    sess.flush()
    sess.close()


# -- serve layer ------------------------------------------------------------------


def test_serve_spans_metrics_and_shared_clock():
    """One injected clock feeds tenant queue-wait stats *and* serve spans:
    with time frozen, every serve-layer duration is exactly zero."""
    frozen = 1234.5
    with StencilServer("sim:1", capacity_bytes=2e6, trace=True,
                       clock=lambda: frozen, **CPU) as srv:
        app = TA.CloverLeaf2D(24, 24, summary_every=0)
        rt = srv.session("t0")
        app.record_init(rt)
        rt.flush()
        assert srv.stats().tenants["t0"].queue_wait_s == 0.0
        tr = srv.tracer
        assert rt.trace() is tr
        serve_spans = [s for s in tr.spans() if s.cat in ("serve", "lease")]
        assert {s.name for s in serve_spans} >= {"admit", "queue-wait", "t0"}
        for s in serve_spans:
            assert s.t_start == frozen and s.t_end == frozen
        lease = [s for s in serve_spans if s.cat == "lease"]
        assert lease and lease[0].track == "lane0"
        m = srv.metrics()
        assert m["counters"]["jobs_completed"] == 1.0
        assert m["histograms"]["queue_wait_s"]["count"] == 1
        assert m["histograms"]["queue_wait_s"]["sum"] == 0.0
        assert m["gauges"]["free_lanes"] == 1.0
        rt.close()


def test_serve_lane_tags_and_oracle_stays_untraced(tmp_path):
    with StencilServer("sim:2", capacity_bytes=2e6, trace=True,
                       spill_dir=str(tmp_path), **CPU) as srv:
        app = TA.CloverLeaf2D(24, 24, summary_every=2)
        rt = srv.session("t0")
        app.run(rt, steps=1)
        srv.preempt("t0")
        app.run_steps(rt, 1, 2)
        rt.close()
        spans = srv.tracer.spans()
        tracks = {s.track for s in spans}
        assert any(t.startswith("lane0/") for t in tracks)
        assert {s.name for s in spans if s.cat == "serve"} == {
            "admit", "queue-wait", "preempt-checkpoint", "preempt-restore"}
        # Every span is a lane's, a tenant's or a lease: the oracle's sim
        # executor shares the lanes' config but not their tracer.
        for s in spans:
            assert s.track.startswith(("lane", "tenant/")) or s.cat == "lease", s.track
        assert srv.metrics()["counters"]["preemptions"] == 1.0


def test_serve_untraced_by_default():
    with StencilServer("sim:1", capacity_bytes=2e6, **CPU) as srv:
        assert not srv.tracer.enabled
        rt = srv.session("t0")
        assert rt.trace() is None
        rt.close()
        assert srv.metrics()["counters"] == {}
