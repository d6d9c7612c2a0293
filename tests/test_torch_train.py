"""The port's training path (``repro_torch.train``, ``models.loss_fn`` and
``forward(remat=)``, ``launch/train.py``) against the JAX package's
``repro.train`` and ``repro.models.loss_fn``.

The same seeded numpy inputs go through both, with the JAX package's weights
carried across by ``params_from_numpy`` (norm scales perturbed so that the
comparison sees them): the loss and every gradient of one reduced arch per
family (dense, vlm with patches, moe with GQA and with MLA, ssm, hybrid,
encdec with encoder inputs), a two-microbatch step, AdamW on the same
gradients, the token stream, and checkpoints in both directions.  fp32 at
rtol 1e-4 / atol 1e-5, the port against itself (remat on and off, a resumed
run against an uninterrupted one) bit for bit.  Two faults of the reference
are shown there and fixed in the port: C6 (a bfloat16 checkpoint that the
reference cannot restore) and C7 (weight decay on stacked 1-D leaves).  The
JAX trees and jitted functions are built once per arch.  On the card,
``chip_smoke.py --train`` runs the same path at Llama 3.2 1B's published
widths.
"""
import functools
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import adamw_init as j_adamw_init  # noqa: E402
from repro.train import adamw_update as j_adamw_update  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro.train import checkpoint as JK  # noqa: E402
from repro.train import data as JD  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, loss_fn  # noqa: E402
from repro_torch.models.weights import load_tree, params_from_numpy, tensor_tree  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, adamw_update, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as TK  # noqa: E402
from repro_torch.train import data as TD  # noqa: E402
from repro_torch.train.step import loss_and_grads, make_prefill_step, make_serve_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)
# One arch per family: dense, vlm, moe (GQA), moe (MLA, a dense first
# layer), ssm, hybrid, encdec.
ARCHS = ["llama3_2_1b", "internvl2_76b", "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
         "mamba2_1_3b", "zamba2_1_2b", "whisper_medium"]
PERTURBED = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "ln_x": 1.0, "norm": 1.0,
             "final_norm": 1.0, "enc_norm": 1.0, "d_skip": 1.0, "dt_bias": 0.0,
             "conv_b": 0.0}
B, S = 2, 16


@pytest.fixture(autouse=True)
def _exact_fp32():
    """fp32 matmuls in fp32 (no TF32 where a card would allow it)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32", seed=0):
    """The JAX config, params and a numpy tree of them, with the leaves of
    PERTURBED moved from their initial values (shared by every test that
    asks: none of them writes to them)."""
    cfg = JC.get_reduced_config(arch).with_(dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(seed)))

    def perturb(path, leaf):
        base = PERTURBED.get(getattr(path[-1], "key", ""))
        if base is None:
            return leaf
        moved = base + 0.1 * rng.standard_normal(leaf.shape)
        return np.asarray(jnp.asarray(moved.astype(np.float32)).astype(leaf.dtype))
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _port(arch, tree, dtype="float32"):
    model = params_from_numpy(TC.get_reduced_config(arch).with_(dtype=dtype), tree,
                              device=CPU)
    return model.requires_grad_(True)


def _batch(cfg, batch=B, seq=S, seed=5):
    """Seeded numpy tokens, next-token labels, and the family's extra input."""
    rng = np.random.default_rng(seed)
    chunk = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["enc_inputs"] = rng.standard_normal((batch, 10, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg):
    def lf(p, b):
        return j_loss_fn(p, cfg, b["tokens"], b["labels"], patches=b.get("patches"),
                         enc_inputs=b.get("enc_inputs"))
    return jax.jit(jax.value_and_grad(lf))


@functools.lru_cache(maxsize=None)
def _jax_adamw(**kw):
    return jax.jit(functools.partial(j_adamw_update, cfg=JAdamWConfig(**kw)))


def _assert_tree_close(got, want, tol, where=""):
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol, f"{where}/{k}")
        else:
            g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) else got[k]
            np.testing.assert_allclose(g, np.asarray(want[k], np.float32), **tol,
                                       err_msg=f"{where}/{k}")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _fp64_grads(arch, tree, batch):
    """The port's loss and gradients of ``batch`` in float64 (the anchor of
    the roundoff check)."""
    model = _port(arch, tree).double()
    loss, grads = loss_and_grads(model, {k: v.double() if v.dtype == torch.float32 else v
                                 for k, v in _torch_batch(batch).items()})
    return loss, dict(_leaves(tensor_tree(model, grads)))


# -- loss_fn and its gradients -------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    cfg, params, tree = _reference(arch)
    batch = _batch(cfg)
    want_loss, want_grads = _jax_value_and_grad(cfg)(params, batch)
    model = _port(arch, tree)
    loss, grads = loss_and_grads(model, _torch_batch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(want_loss), **F32)
    got = dict(_leaves(tensor_tree(model, grads)))
    want = dict(_leaves(jax.tree.map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)
    off = [k for k in want if not np.allclose(got[k].numpy(), want[k], **F32)]
    # Where a leaf misses rtol 1e-4 / atol 1e-5, it must be fp32 roundoff that
    # the reference shares: the port no farther from a float64 run than
    # twice the reference is.  Only the hybrid's embedding gradient (up to
    # 7.1 in magnitude, 4.4e-5 between JAX and float64) needs this.  The
    # float64 run is itself held to the reference (within 1e-4 of it, and its
    # loss at rtol 1e-4), so a fault in the port cannot widen the bound.
    assert off == ([] if arch != "zamba2_1_2b" else ["/embed"]), off
    if off:
        exact_loss, exact = _fp64_grads(arch, tree, batch)
        np.testing.assert_allclose(exact_loss.item(), float(want_loss), **F32)
        for k in off:
            port = np.abs(got[k].double().numpy() - exact[k].numpy()).max()
            ref = np.abs(want[k].astype(np.float64) - exact[k].numpy()).max()
            assert ref <= 1e-4, (k, ref)
            assert port <= 2 * ref, (k, port, ref)
    if cfg.first_dense_layers:
        # The reference's lax.cond: a layer's unheld branch gets no gradient
        # (the port's tree writes zeros there, so the comparison above
        # already held them; this says why).
        nd = cfg.first_dense_layers
        for leaf in jax.tree.leaves(want_grads["blocks"]["mlp"]):
            assert not np.asarray(leaf)[nd:].any()
        for leaf in jax.tree.leaves(want_grads["blocks"]["moe"]):
            assert not np.asarray(leaf)[:nd].any()


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_lite_16b", "zamba2_1_2b",
                                  "whisper_medium"])
def test_remat_is_bit_identical(arch):
    cfg, _, tree = _reference(arch)
    model = _port(arch, tree)
    batch = _torch_batch(_batch(cfg))
    loss_on, on = loss_and_grads(model, batch, remat=True)
    loss_off, off = loss_and_grads(model, batch, remat=False)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(on[k], off[k]) for k in on)


def test_encdec_without_encoder_inputs_raises():
    cfg, _, tree = _reference("whisper_medium")
    model = _port("whisper_medium", tree)
    batch = _torch_batch(_batch(cfg))
    with pytest.raises(ValueError, match="stubbed"):
        loss_fn(model, batch["tokens"], batch["labels"])


# -- the train step ------------------------------------------------------------
def test_two_microbatches_match_the_reference():
    """One step of ``make_train_step(microbatches=2)`` in both packages (no
    weight decay, so that C7 does not enter): loss, grad norm, lr, the new
    parameters and both moments."""
    cfg, params, tree = _reference("llama3_2_1b")
    batch = _batch(cfg, batch=4)
    kw = dict(peak_lr=1e-3, warmup_steps=1, weight_decay=0.0)
    j_step = jax.jit(j_make_train_step(cfg, JAdamWConfig(**kw), microbatches=2))
    want_p, want_opt, want_m = j_step(params, j_adamw_init(params), batch)
    model = _port("llama3_2_1b", tree)
    step = make_train_step(model.cfg, AdamWConfig(**kw), microbatches=2)
    opt = adamw_init(dict(model.named_parameters()))
    model, opt, metrics = step(model, opt, _torch_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), **F32, err_msg=k)
    assert int(opt["step"]) == int(want_opt["step"]) == 1
    _assert_tree_close(tensor_tree(model), jax.tree.map(np.asarray, want_p), F32)
    for m in ("mu", "nu"):
        _assert_tree_close(tensor_tree(model, opt[m]),
                           jax.tree.map(np.asarray, want_opt[m]), F32, m)


def test_microbatched_gradients_accumulate_in_fp32_in_a_bf16_model(monkeypatch):
    """With one microbatch the gradients stay in the parameters' dtype (as
    ``jax.value_and_grad`` leaves them); with two the step sums fp32
    accumulators, and its loss is the mean of the two halves'."""
    import repro_torch.train.step as step_mod

    tree = _reference("llama3_2_1b", "bfloat16")[2]
    cfg = TC.get_reduced_config("llama3_2_1b").with_(dtype="bfloat16")
    batch = _torch_batch(_batch(cfg, batch=4))
    halves = [loss_and_grads(_port("llama3_2_1b", tree, "bfloat16"),
                     {k: v[i:i + 2] for k, v in batch.items()})[0] for i in (0, 2)]
    seen = []

    def spy(params, grads, state, opt_cfg):
        seen.append({g.dtype for g in grads.values()})
        return adamw_update(params, grads, state, opt_cfg)
    monkeypatch.setattr(step_mod, "adamw_update", spy)
    for mb, b in ((1, {k: v[:2] for k, v in batch.items()}), (2, batch)):
        model = _port("llama3_2_1b", tree, "bfloat16")
        _, _, metrics = make_train_step(cfg, AdamWConfig(), microbatches=mb)(
            model, adamw_init(dict(model.named_parameters())), b)
    assert seen == [{torch.bfloat16}, {torch.float32}]
    assert torch.equal(metrics["loss"], (halves[0] + halves[1]) * 0.5)


def test_sharding_options_raise():
    """The sharding options no longer raise (ROADMAP A14(e); the mesh paths
    are held against the JAX package by tests/test_torch_mesh.py): as in
    the reference, ``compress_pod_grads`` without a mesh leaves the step as
    it is, bit for bit."""
    cfg, _, tree = _reference("llama3_2_1b")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for kw in (dict(), dict(compress_pod_grads=True)):
        model = _port("llama3_2_1b", tree)
        state = adamw_init(dict(model.named_parameters()))
        _, state, metrics = make_train_step(model.cfg, AdamWConfig(), **kw)(model, state, b)
        out.append((metrics["loss"], [p.detach().clone() for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b_) for a, b_ in zip(out[0][1], out[1][1]))


def test_serve_and_prefill_steps_wrap_decode_and_forward():
    cfg, _, tree = _reference("llama3_2_1b")
    model = _port("llama3_2_1b", tree)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.no_grad():
        logits = make_prefill_step(model.cfg)(model, {"tokens": tokens})
        assert torch.equal(logits, forward(model, tokens)[:, -1, :])
        c1, c2 = init_cache(model.cfg, B, 4, device=CPU), init_cache(model.cfg, B, 4, device=CPU)
        got, _ = make_serve_step(model.cfg)(model, c1, tokens[:, 0])
        want, _ = decode_step(model, c2, tokens[:, 0])
    assert torch.equal(got, want)


# -- AdamW -----------------------------------------------------------------------
def _flat_numpy(model):
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("grad_scale", [1.0, 1e-4])      # clipped, and not
def test_adamw_update_matches_the_reference(grad_scale):
    """Three steps (through the warmup into the cosine) on the same
    gradients, JAX fed a per-layer tree keyed by the port's parameter
    names, so that its ``ndim >= 2`` test means what the port's means."""
    model = _port("mamba2_1_3b", _reference("mamba2_1_3b")[2])
    params = dict(model.named_parameters())
    j_params = {k: jnp.asarray(v) for k, v in _flat_numpy(model).items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=4)
    state, j_state = adamw_init(params), j_adamw_init(j_params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = {k: (grad_scale * rng.standard_normal(p.shape)).astype(np.float32)
             for k, p in params.items()}
        j_params, j_state, want = _jax_adamw(**kw)(
            j_params, {k: jnp.asarray(v) for k, v in g.items()}, j_state)
        _, state, got = adamw_update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                                     state, AdamWConfig(**kw))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), **F32, err_msg=k)
    assert int(state["step"]) == int(j_state["step"]) == 3
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), **F32,
                                   err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(state[m][k].numpy(), np.asarray(j_state[m][k]),
                                       **F32, err_msg=f"{m}/{k}")


def test_adamw_casts_the_update_back_to_bf16():
    model = _port("llama3_2_1b", _reference("llama3_2_1b", "bfloat16")[2], "bfloat16")
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    state = adamw_init(params)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    adamw_update(params, grads, state, AdamWConfig(peak_lr=1e-2, warmup_steps=1))
    assert all(p.dtype == torch.bfloat16 and not torch.equal(p, before[k])
               for k, p in params.items())
    assert all(m.dtype == torch.float32 for m in state["mu"].values())


@pytest.mark.parametrize("arch,stacked", [("llama3_2_1b", ("blocks", "ln1")),
                                          ("mamba2_1_3b", ("blocks", "mamba", "a_log"))])
def test_c7_reference_decays_stacked_vectors_and_the_port_does_not(arch, stacked):
    """ROADMAP C7: with zero gradients a step only decays.  The reference's
    ``ndim >= 2`` counts the stacked layer axis, so its stacked 1-D leaves
    move (and the unstacked ``final_norm`` does not); the port's do not.  A
    matrix is decayed in both."""
    cfg, params, tree = _reference(arch)
    kw = dict(peak_lr=1e-3, warmup_steps=1, weight_decay=0.1)
    zeros = jax.tree.map(jnp.zeros_like, params)
    new, _, _ = _jax_adamw(**kw)(params, zeros, j_adamw_init(params))

    def leaf(t, path):
        for k in path:
            t = t[k]
        return np.asarray(t, np.float32)
    moved = np.abs(leaf(new, stacked) - leaf(params, stacked)).max()
    assert moved == pytest.approx(1e-4 * np.abs(leaf(params, stacked)).max(), rel=1e-3)
    assert np.array_equal(leaf(new, ("final_norm",)), leaf(params, ("final_norm",)))

    model = _port(arch, tree)
    p = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in p.items()}
    adamw_update(p, {k: torch.zeros_like(v) for k, v in p.items()}, adamw_init(p),
                 AdamWConfig(**kw))
    for k, v in p.items():
        if v.ndim == 1:
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v, before[k]), k
    assert torch.equal(p["final_norm"], before["final_norm"])


# -- data ------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=16, global_batch=4),
                                dict(vocab_size=512, seq_len=33, global_batch=8, seed=7,
                                     host_index=1, host_count=2),
                                "file"])
def test_token_stream_is_byte_equal_to_the_reference(kw, tmp_path):
    if kw == "file":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 1 << 20, 5000).astype(np.int32).tofile(path)
        kw = dict(vocab_size=1000, seq_len=20, global_batch=3, path=str(path))
    got, want = TD.TokenStream(TD.DataConfig(**kw)), JD.TokenStream(JD.DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
    it = TD.PrefetchIterator(got, start_step=3)
    try:
        s, batch = next(it)
    finally:
        it.close()
    assert s == 3 and batch["tokens"].tobytes() == want.batch_at(3)["tokens"].tobytes()


# -- checkpoints -----------------------------------------------------------------
def test_checkpoint_round_trip_retention_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        TK.save_checkpoint(d, s, tree, keep=2)
    assert TK.list_checkpoints(d) == [4, 5] and TK.latest_checkpoint(d) == 5
    assert not any(n.startswith(".tmp") for n in os.listdir(d))
    step, got = TK.restore_checkpoint(d, 5, tree)
    assert step == 5 and got["b"]["c"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], tree[k]) for k in ("a", "step"))
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError):
        TK.restore_checkpoint(d, 5, {"a": torch.zeros(4, 3)})
    with pytest.raises(KeyError):
        TK.restore_checkpoint(d, 5, {"z": torch.zeros(1)})


def test_async_checkpoint_is_a_snapshot(tmp_path):
    x = torch.zeros(1000)
    t = TK.save_checkpoint(str(tmp_path), 1, {"x": x}, async_write=True)
    x.add_(1)                      # the caller updates in place at once
    t.join(30)
    assert not t.is_alive()
    assert torch.equal(TK.restore_checkpoint(str(tmp_path), 1, {"x": x})[1]["x"],
                       torch.zeros(1000))


def test_c6_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """ROADMAP C6: ``np.savez`` stores a bfloat16 leaf as raw ``|V2``, which
    the reference's ``restore_checkpoint`` cannot cast back."""
    tree = {"a": jnp.ones((2, 3), jnp.bfloat16)}
    JK.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError):
        JK.restore_checkpoint(str(tmp_path), 1, tree)


def _bits(x) -> np.ndarray:
    """The raw bits of a bfloat16 (JAX, ml_dtypes or torch) or fp32 array."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(np.atleast_1d(np.asarray(x))).view(np.uint8)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_lite_16b"])
def test_c6_bf16_checkpoints_cross_both_ways(arch, tmp_path):
    """A bf16 model's checkpoint (after one step, so the moments are not
    zero) written by the port restores in the reference, and the
    reference's restores in the port, bit for bit; DeepSeek's unheld
    ``mlp``/``moe`` slices are zeros on the way out and skipped on the way
    back."""
    cfg, params, tree = _reference(arch, "bfloat16")
    model = _port(arch, tree, "bfloat16")
    step = make_train_step(model.cfg, AdamWConfig(peak_lr=1e-2, warmup_steps=1))
    model, opt, _ = step(model, adamw_init(dict(model.named_parameters())),
                         _torch_batch(_batch(cfg)))
    ours = launch_train.state_tree(model, opt)
    TK.save_checkpoint(str(tmp_path / "port"), 1, ours)
    j_like = {"params": params, "opt": j_adamw_init(params)}
    got_step, got = JK.restore_checkpoint(str(tmp_path / "port"), 1, j_like)
    assert got_step == 1
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert len(flat_got) == len(flat_ours)
    for path, leaf in flat_got:
        assert np.array_equal(_bits(leaf), _bits(flat_ours[path])), path

    # the reference's checkpoint of the same state, back into a fresh port model
    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    JK.save_checkpoint(str(tmp_path / "jax"), 1, jax.tree.map(to_jax, ours))
    fresh = _port(arch, tree, "bfloat16")
    fresh_opt = adamw_init(dict(fresh.named_parameters()))
    _, back = TK.restore_checkpoint(str(tmp_path / "jax"), 1,
                                    launch_train.state_tree(fresh, fresh_opt))
    load_tree(fresh, back["params"])
    load_tree(fresh, back["opt"]["mu"], values=fresh_opt["mu"])
    load_tree(fresh, back["opt"]["nu"], values=fresh_opt["nu"])
    assert int(back["opt"]["step"]) == 1
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name
        assert torch.equal(opt["mu"][name], fresh_opt["mu"][name]), name
        assert torch.equal(opt["nu"][name], fresh_opt["nu"][name]), name


# -- the launcher ----------------------------------------------------------------
def _launch(ckpt, *extra, steps=6):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3_2_1b",
            "--reduced", "--device", "cpu", "--steps", str(steps), "--ckpt-dir", ckpt,
            "--ckpt-every", "2", "--batch", "2", "--seq", "16", "--quiet", *extra]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_kill_and_resume_bitwise(tmp_path):
    """``tests/test_train_infra.py``'s preemption test on the port: kill -9
    a run (``python -m repro_torch.launch.train``) after its first
    checkpoint, resume it to the end, and every array of the last checkpoint
    equals an uninterrupted run's (the two in this process)."""
    ckpt = str(tmp_path / "ckpt")
    assert launch_train.main(_launch(ckpt + "_full")[3:]) == 0
    p = subprocess.Popen(_launch(ckpt, "--sleep-per-step", "0.4"), env=_env(),
                         cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    while time.time() < deadline and TK.latest_checkpoint(ckpt) is None:
        time.sleep(0.3)
    time.sleep(0.5)
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=30)
    killed_at = TK.latest_checkpoint(ckpt)
    assert killed_at is not None and killed_at < 6, "no checkpoint before the kill"
    assert launch_train.main(_launch(ckpt)[3:]) == 0
    assert TK.latest_checkpoint(ckpt + "_full") == TK.latest_checkpoint(ckpt) == 6
    full = np.load(os.path.join(ckpt + "_full", "step_00000006", "arrays.npz"))
    res = np.load(os.path.join(ckpt, "step_00000006", "arrays.npz"))
    assert sorted(full.files) == sorted(res.files)
    assert "params::blocks::attn::wq" in full.files and "opt::step" in full.files
    for k in full.files:
        np.testing.assert_array_equal(full[k], res[k])


def test_resumed_in_process_equals_uninterrupted_and_the_reference_reads_it(
        tmp_path, monkeypatch):
    """The launcher's ``main`` in this process: six steps, and six steps
    stopped by a SIGTERM after the third (the same schedule), then resumed,
    leave equal arrays; the JAX package's restore reads the port's last
    checkpoint into its own parameter tree."""
    import repro_torch.train as train_pkg

    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    assert launch_train.main(_launch(full)[3:]) == 0
    real = train_pkg.make_train_step

    def stopping(*args, **kw):
        step = real(*args, **kw)
        done = []

        def counted(*a):
            out = step(*a)
            done.append(1)
            if len(done) == 3:
                signal.raise_signal(signal.SIGTERM)
            return out
        return counted
    monkeypatch.setattr(train_pkg, "make_train_step", stopping)
    previous = signal.getsignal(signal.SIGTERM)
    assert launch_train.main(_launch(part)[3:]) == 0
    assert signal.getsignal(signal.SIGTERM) is previous
    assert TK.latest_checkpoint(part) == 3
    monkeypatch.setattr(train_pkg, "make_train_step", real)
    assert launch_train.main(_launch(part)[3:]) == 0
    a = np.load(os.path.join(full, "step_00000006", "arrays.npz"))
    b = np.load(os.path.join(part, "step_00000006", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    cfg = JC.get_reduced_config("llama3_2_1b")
    p = j_init_params(cfg, jax.random.PRNGKey(0))
    step, got = JK.restore_checkpoint(full, 6, {"params": p, "opt": j_adamw_init(p)})
    assert step == 6 and int(got["opt"]["step"]) == 6
    np.testing.assert_array_equal(got["params"]["embed"], a["params::embed"])


@pytest.mark.parametrize("argv,what", [
    (["--arch", "whisper_medium", "--reduced", "--device", "cpu"], "stubbed"),
    # --model-parallel N trains on a mesh since ROADMAP A14(e) (tests/test_torch_mesh.py);
    # the case keeps its id and checks the one value the launcher refuses
    pytest.param(["--arch", "llama3_2_1b", "--reduced", "--device", "cpu",
                  "--model-parallel", "0"], "--model-parallel", id="argv1-A14"),
    (["--arch", "no_such_arch", "--device", "cpu"], "unknown arch")])
def test_launcher_exits_2(argv, what, capsys):
    assert launch_train.main(argv) == 2
    assert what in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
                                  "mamba2_1_3b", "zamba2_1_2b", "internvl2_76b"])
def test_launcher_trains_every_family(arch, capsys):
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "step 2/2 loss=" in out and "done at step 2" in out


class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_chip_smoke_train_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 14 of ``chip_smoke.py`` at the reduced widths in bf16 on the
    CPU, the ``torch.cuda`` timing and memory calls faked: every part runs
    and passes its checks (here the "card" is the CPU too)."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location("_chip_smoke_train",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = TC.get_reduced_config("llama3_2_1b").with_(dtype="bfloat16")
    monkeypatch.setattr(TC, "get_config", lambda name: cfg)
    monkeypatch.setattr(cs, "TRAIN_PUBLISHED", (
        cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.d_ff,
        cfg.vocab_size, cfg.dtype, cfg.tie_embeddings))
    monkeypatch.setattr(cs, "release_pinned_cache", lambda: None)
    for name, fake in (("synchronize", lambda: None), ("empty_cache", lambda: None),
                       ("reset_peak_memory_stats", lambda: None),
                       ("max_memory_allocated", lambda: 0), ("Event", _FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, fake)
    cs.train_phase("cpu", device=CPU, argv=("--steps", "6", "--batch", "2", "--seq", "16",
                                            "--microbatches", "2"))
    recs = {}
    for line in capsys.readouterr().out.splitlines():
        rec = json.loads(line)
        recs.setdefault(rec["phase"], []).append(rec)
    full = recs["train_full"][0]
    assert full["tokens_per_step"] == 32 and len(full["ms_per_step"]) == 6
    assert full["batch0_loss_after"] < full["batch0_loss_before"]
    assert len(full["optimizer_ms"]) == 6
    assert recs["train_determinism"][0]["default_bit_identical"]
    parity = recs["train_parity"][0]
    assert parity["loss_ok"] and parity["grads_ok"] and parity["adamw_ok"]
    assert parity["remat_bit_identical"] and parity["adamw_max_abs_diff"] == 0.0
    assert recs["train_resume"][0]["bit_identical"]
    assert sorted(r["arch"] for r in recs["train_family"]) == sorted(
        list(cs.TRAIN_FAMILIES) + ["whisper_medium"])
    assert recs["train_done"][0]["launches"] == {"stencil2d": 0, "stencil3d": 0,
                                                 "chain2d": 0}
    assert not cs.TRAIN_CKPT.exists()
