"""The port's examples (``examples/{quickstart,serve_lm,train_lm}_torch.py``)
against the JAX package's (``examples/{quickstart,serve_lm,train_lm}.py``)
on the CPU.

The quickstart pair is loaded by path and each ``heat`` run as its script
runs it: the JAX ``reference`` against the port's ``ooc`` at the script's
``allclose(atol=1e-5)``, and the preview chain planned in both packages
under one ``HardwareModel`` (the port's default with the script's capacity)
to byte-equal plan JSON.  The JAX ``serve_lm.py`` and ``train_lm.py`` keep
their work in ``main``, so for those the tests call the JAX package
functions the scripts call, with the scripts' configs: the port's resident
logits, teacher-forced on the JAX example's greedy tokens, within fp32
rtol 1e-4 / atol 1e-5 of the JAX logits at every step, and its greedy
tokens equal to the JAX example's; the two ``build_config``s equal for both
presets, and the port's ``train`` on the JAX example's weights and batches
within ``tests/test_torch_train.py``'s F32 of the JAX example's sharded,
jitted step (loss, grad norm and lr at every step); the port's training
on its (1, 1) host mesh within F32 of the unsharded step; a run resumed
from its step-10 checkpoint bit for bit with the uninterrupted one.  Each script, run with its default ``--device`` on a
machine without CUDA, exits non-zero with ``resolve_device``'s message.
"""
import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _torch_reference_tiles import reference_tiles  # noqa: E402
from repro_torch.configs import get_reduced_config as t_get_reduced_config  # noqa: E402
from repro.kernels import star2d_kernel as j_star2d  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_make_host_mesh  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import adamw_init as j_adamw_init  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.data import TokenStream as JTokenStream  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    batch_specs, distribute, param_specs, shard_params)
from repro_torch.launch.mesh import init_ranks, make_host_mesh  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.train.data import DataConfig, TokenStream  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = torch.device("cpu")
F32 = dict(rtol=1e-4, atol=1e-5)
PROBLEM = 2 * 514 * 258 * 4          # quickstart's u and tmp homes


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture
def one_rank():
    """A gloo group of this one rank, as the train example joins one."""
    init_ranks("gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


# -- quickstart ---------------------------------------------------------------------


def test_quickstart_ooc_equals_the_jax_reference_and_prints_ok(capsys):
    jq, tq = _load("quickstart"), _load("quickstart_torch")
    ref = jq.heat(J.Session("reference"))
    hw = T.ExecutionConfig.hw.with_(fast_capacity=PROBLEM // 4)
    sess = T.Session("ooc", hw=hw, cyclic=True, prefetch=True, device="cpu")
    got = tq.heat(sess)
    assert got.shape == (512, 256)
    assert np.allclose(ref, got, atol=1e-5)
    assert sess.history[-1].num_tiles > 1
    assert tq.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("out-of-core result == reference  [OK]")
    assert f"(model: {T.ExecutionConfig.hw.name})" in out


def test_quickstart_preview_plan_is_byte_equal_to_the_jax_package():
    tq = _load("quickstart_torch")
    thw = T.ExecutionConfig.hw.with_(fast_capacity=PROBLEM // 4)
    jhw = J.HardwareModel(**dataclasses.asdict(thw))
    tsess = T.Session("ooc", hw=thw, cyclic=True, prefetch=True, device="cpu")
    tq.record_preview(tsess)
    # examples/quickstart.py's preview, in the JAX package
    jsess = J.Session("ooc", hw=jhw, cyclic=True, prefetch=True)
    blk = J.Block("preview", (512, 256))
    rng = np.random.RandomState(0)
    pu = J.make_dataset(blk, "u", halo=1, init=rng.rand(512, 256).astype(np.float32))
    pt = J.make_dataset(blk, "tmp", halo=1)
    box = ((1, 511), (1, 255))
    jsess.par_loop("p_diffuse", blk, box, [pu, pt], j_star2d("u", "tmp", (0.0, 0.25, 0.25)))
    jsess.par_loop("p_commit", blk, box, [pt, pu], lambda acc: {"u": acc("tmp")})
    # the JAX package's tile count: the port's planner without its
    # workspace charge (tests/_torch_reference_tiles.py)
    with reference_tiles():
        got, want = T.plans_to_json(tsess.plan()), J.plans_to_json(jsess.plan())
        assert '"op": "upload"' in got and got == want
        assert tsess.explain() == jsess.explain()


# -- serve_lm -----------------------------------------------------------------------


def test_serve_lm_matches_the_jax_example_step_by_step(capsys):
    """``examples/serve_lm.py``'s config, weights and prompts: the JAX
    greedy run's logits at every step against the port's resident step fed
    the same tokens; the port's resident and streamed greedy runs equal."""
    ts = _load("serve_lm_torch")
    jcfg = JC.get_reduced_config("llama3_2_1b").with_(num_layers=8)
    key = jax.random.PRNGKey(0)
    params = j_init_params(jcfg, key)
    B, gen = 4, 16
    prompts = jax.random.randint(key, (B,), 0, jcfg.vocab_size)
    step = jax.jit(lambda p, c, t: j_decode_step(p, jcfg, c, t))
    cache = j_init_cache(jcfg, B, gen + 1)
    tok, fed, want = prompts, [], []
    for _ in range(gen):
        fed.append(np.array(tok))
        logits, cache = step(params, cache, tok)
        want.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)
    greedy = fed[1:] + [np.array(tok)]          # the JAX example's outputs

    tcfg = t_get_reduced_config("llama3_2_1b").with_(num_layers=8)
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device=CPU)
    tcache = init_cache(tcfg, B, gen + 1, device=CPU)
    with torch.inference_mode():
        for t, (tokens, w) in enumerate(zip(fed, want)):
            logits, tcache = decode_step(model, tcache, torch.from_numpy(tokens).long())
            np.testing.assert_allclose(logits.numpy(), w, **F32, err_msg=f"step {t}")

    run = ts.serve(model, torch.from_numpy(np.array(prompts)).long(), gen)
    assert len(run["resident"]) == len(run["streamed"]) == gen
    for t, (got, w) in enumerate(zip(run["resident"], greedy)):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=f"step {t}")
    assert all(torch.equal(a, b) for a, b in zip(run["resident"], run["streamed"]))
    assert ts.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "greedy outputs identical: True" in out
    assert f"modelled step on {run['streamer'].hw.name} " in out


# -- train_lm -----------------------------------------------------------------------


def _step_losses(stdout: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step +(\d+)/\d+ loss=(\S+) ", stdout, re.M)}


def test_train_lm_resumes_bit_for_bit(tmp_path, one_rank, capsys):
    """``--preset tiny --steps 15`` saves at steps 10 and 15; with the
    step-15 checkpoint deleted, a second run to 15 resumes from step 10 and
    its step-15 loss and checkpoint are bit-identical to the first run's.
    The second run calls the script's ``train`` in this process (in the
    group ``main`` would join): ``main``'s own check, the last loss below
    the run's first, is the JAX example's and does not hold over steps
    11-15 of this schedule's tail."""
    tt = _load("train_lm_torch")
    ckpt = tmp_path / "ckpt"
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "train_lm_torch.py"), "--preset", "tiny", "--steps",
         "15", "--device", "cpu", "--ckpt-dir", str(ckpt)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "(improved)" in out.stdout
    first = _step_losses(out.stdout)
    assert sorted(first) == [1, 5, 10, 15]
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000010", "step_00000015"]
    shutil.move(str(ckpt / "step_00000015"), str(tmp_path / "first_15"))

    cfg, batch, seq = tt.build_config("tiny")
    history = tt.train(cfg, batch, seq, 15, str(ckpt), CPU)
    assert "resumed from step 10" in capsys.readouterr().out
    assert sorted(history) == [11, 12, 13, 14, 15]
    loss = history[15]["loss"]
    assert np.float32(loss).view(np.uint32) == np.float32(first[15]).view(np.uint32)
    a = np.load(tmp_path / "first_15" / "arrays.npz")
    b = np.load(ckpt / "step_00000015" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and "opt::step" in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_lm_follows_the_jax_example(tmp_path, one_rank, monkeypatch):
    """``examples/train_lm.py``'s presets, and its first three steps of the
    tiny preset (``--steps 3``): the JAX example's weights, schedule and
    jitted step on its host mesh, fed its ``TokenStream``, against the
    port's ``train`` from the same weights (carried across with
    ``params_from_numpy``) on its own stream, at every step within
    ``tests/test_torch_train.py``'s F32 (loss, grad norm, lr).  ROADMAP C7:
    the JAX step decays the stacked norm scales and the port's does not, by
    0.1 x the step's lr of them a step, which stays inside F32 here."""
    jt, tt = _load("train_lm"), _load("train_lm_torch")
    for preset in ("tiny", "100m"):
        (jcfg, *jshape), (tcfg, *tshape) = jt.build_config(preset), tt.build_config(preset)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), preset
        assert tshape == jshape, preset
    jcfg, batch, seq = jt.build_config("tiny")
    steps = 3
    params = j_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    opt_state = j_adamw_init(params)
    opt_cfg = JAdamWConfig(peak_lr=3e-3, warmup_steps=max(5, steps // 10), total_steps=steps)
    step_fn = jax.jit(j_make_train_step(jcfg, opt_cfg, j_make_host_mesh()))
    stream = JTokenStream(JDataConfig(jcfg.vocab_size, seq, batch))
    want = []
    for s in range(steps):
        jb = {k: jnp.asarray(v) for k, v in stream.batch_at(s).items()}
        params, opt_state, m = step_fn(params, opt_state, jb)
        want.append({k: float(v) for k, v in m.items()})

    def init_state(cfg, mesh, dev, seed=0):
        model = params_from_numpy(cfg, tree, device=dev).requires_grad_(True)
        shard_params(model, param_specs(model, cfg, mesh), mesh)
        return model, adamw_init(dict(model.named_parameters()))

    monkeypatch.setattr(tt, "init_state", init_state)
    cfg, batch, seq = tt.build_config("tiny")
    history = tt.train(cfg, batch, seq, steps, str(tmp_path), CPU)
    assert sorted(history) == [1, 2, 3]
    for s, w in enumerate(want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(history[s + 1][k], w[k], **F32,
                                       err_msg=f"step {s + 1} {k}")


def test_train_lm_host_mesh_step_equals_the_unsharded_step(one_rank):
    """The example's (1, 1) host mesh: three steps of its sharded model
    against ``make_train_step(cfg, opt_cfg, None)`` on the same weights and
    batches (``tests/test_torch_train.py``'s F32)."""
    tt = _load("train_lm_torch")
    cfg, batch, seq = tt.build_config("tiny")
    steps = 3
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=max(5, steps // 10), total_steps=steps)
    mesh = make_host_mesh(device_type="cpu")
    sharded, s_opt = tt.init_state(cfg, mesh, CPU)
    plain = init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    p_opt = adamw_init(dict(plain.named_parameters()))
    s_step, p_step = make_train_step(cfg, opt_cfg, mesh), make_train_step(cfg, opt_cfg, None)
    bspecs = batch_specs(cfg, mesh, batch)
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch))
    for s in range(steps):
        tb = {k: torch.from_numpy(v) for k, v in stream.batch_at(s).items()}
        sharded, s_opt, sm = s_step(sharded, s_opt, {k: distribute(v, bspecs[k], mesh)
                                                     for k, v in tb.items()})
        plain, p_opt, pm = p_step(plain, p_opt, tb)
        np.testing.assert_allclose(float(sm["loss"]), float(pm["loss"]), **F32)
        np.testing.assert_allclose(float(sm["grad_norm"]), float(pm["grad_norm"]), **F32)
    assert int(p_opt["step"]) == int(s_opt["step"]) == steps


# -- no fallback --------------------------------------------------------------------


@pytest.mark.parametrize("script", ["quickstart_torch", "serve_lm_torch", "train_lm_torch"])
def test_default_device_never_falls_back_to_cpu(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the example would run on it")
    out = subprocess.run([sys.executable, str(EXAMPLES / f"{script}.py")],
                         capture_output=True, text=True, timeout=120, env=_env(),
                         cwd=str(tmp_path))
    assert out.returncode != 0
    assert "CUDA is not available; pass device='cpu'" in out.stderr
