"""The port's own hardware preset, ``H100``, as its default ``hw``.

The reference's default is its own target's preset, ``TPU_V5E``; the
port's is ``H100`` (``repro_torch/core/memory.py``) at the same five sites:
``ExecutionConfig``, ``OOCConfig``, ``ResidentExecutor``,
``StencilServer`` and ``StreamedDecoder``.  The JAX package has no H100
preset, so it is run at the same figures
(``J.HardwareModel(**asdict(T.H100))``): each app planned there and run on
the port at its default gives byte-equal unsplit plans, equal modelled
makespans, and fields within the reference's tolerances (rtol 1e-4 /
atol 1e-5) of the JAX ``reference`` run.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.apps as TA  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.offload import StreamedDecoder  # noqa: E402
from repro_torch.serve import StencilServer  # noqa: E402

FIELD = dict(rtol=1e-4, atol=1e-5)
JHW = J.HardwareModel(**dataclasses.asdict(T.H100))


def _server_hws():
    server = StencilServer("sim:1", device="cpu")
    try:
        return [server.oracle.hw] + [lane.cfg.hw for lane in server.lanes]
    finally:
        server.close()


def _streamer_hws():
    cfg = TC.get_reduced_config("llama3_2_1b").with_(num_layers=2)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return [StreamedDecoder(model).hw]


@pytest.mark.parametrize("hws", [
    lambda: [T.ExecutionConfig(device="cpu").hw],
    lambda: [T.OOCConfig().hw],
    lambda: [T.ResidentExecutor(device="cpu").hw],
    _server_hws,
    _streamer_hws,
], ids=["ExecutionConfig", "OOCConfig", "ResidentExecutor", "StencilServer",
        "StreamedDecoder"])
def test_default_hw_is_the_h100_preset(hws):
    assert all(hw is T.H100 for hw in hws())


def test_the_preset_resolves_by_name():
    sess = T.Session("ooc", hw="h100-sxm", device="cpu")
    assert sess.config.hw is T.H100 and T.PRESETS["h100-sxm"] is T.H100
    assert sess.config.capacity_bytes is None and T.H100.fast_capacity == 80 * T.GB


@pytest.mark.parametrize("name", ["P100_PCIE", "P100_NVLINK", "KNL_7210"])
def test_the_paper_presets_keep_the_reference_figures(name):
    assert dataclasses.asdict(getattr(T, name)) == dataclasses.asdict(getattr(J, name))


# -- the three apps at the default hw against the JAX package at its figures ----------

# (app, size, carried fields, capacity over the homes): at these capacities
# a chain tiles (the tile counts below) and none splits.
APPS = {
    "cloverleaf2d": (lambda A: A.CloverLeaf2D(40, 32, summary_every=0),
                     ("density0", "energy0", "xvel0", "yvel0"), 2.5, [1, 3]),
    "cloverleaf3d": (lambda A: A.CloverLeaf3D(14, 12, 10, summary_every=0),
                     ("density0", "energy0", "xvel0", "yvel0", "zvel0"), 2.0, [1, 4]),
    "opensbli": (lambda A: A.OpenSBLI(16, chain_steps=1),
                 ("rho", "rhou", "rhov", "rhow", "rhoE"), 2.0, [2, 1]),
}


def _init_and_step(pkg, A, name, backend, **kw):
    """The app's init chain, then one timestep chain (Cyclic on, CloverLeaf
    at a fixed dt): the plan JSON previewed before the step runs, the
    modelled makespans and tile counts, the chains run and split, and the
    carried fields."""
    make, fields, frac, _ = APPS[name]
    app = make(A)
    if backend != "reference":
        kw["capacity_bytes"] = app.total_bytes() * frac
    sess = pkg.Session(backend, **kw)
    app.record_init(sess)
    sess.flush()
    sess.cyclic = True
    if name != "opensbli":
        app.dt = 1e-4
    app.record_timestep(sess)
    plan_json = pkg.plans_to_json(sess.plan()) if backend != "reference" else None
    sess.flush()
    return {"plans": plan_json,
            "makespans": [h.modelled_s for h in sess.history],
            "tiles": [h.num_tiles for h in sess.history],
            "chains": (len(sess.history), sess.chains_flushed),
            "fields": {n: np.array(app.d(n).interior()) for n in fields}}


@pytest.fixture(scope="module", params=sorted(APPS))
def app_runs(request):
    name = request.param
    # the port at the JAX package's tile counts (tests/_torch_reference_tiles.py)
    with reference_tiles():
        port = _init_and_step(T, TA, name, "ooc", device="cpu")
    return {"name": name,
            "port": port,
            "jax": _init_and_step(J, JA, name, "sim", hw=JHW),
            "jax_p100": _init_and_step(J, JA, name, "sim", hw=J.P100_PCIE),
            "jax_reference": _init_and_step(J, JA, name, "reference")}


def test_app_plans_byte_equal_to_jax_at_the_preset(app_runs):
    got, want = app_runs["port"], app_runs["jax"]
    assert got["tiles"] == want["tiles"] == APPS[app_runs["name"]][3]
    assert got["chains"] == want["chains"] == (2, 2)  # no chain split
    assert got["plans"] == want["plans"]


def test_app_makespans_equal_jax_at_the_preset(app_runs):
    got = app_runs["port"]["makespans"]
    assert got == app_runs["jax"]["makespans"] and all(t > 0 for t in got)
    assert got != app_runs["jax_p100"]["makespans"]


def test_app_fields_match_jax_reference_at_the_default(app_runs):
    for n, want in app_runs["jax_reference"]["fields"].items():
        got = app_runs["port"]["fields"][n]
        assert np.isfinite(got).all(), n
        np.testing.assert_allclose(got, want, **FIELD, err_msg=n)


def test_launcher_line_names_the_preset(capsys):
    argv = ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--offload"]
    assert launch_serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "modelled, h100-sxm=" in line
