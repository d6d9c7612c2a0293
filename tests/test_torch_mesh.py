"""The port's mesh paths (``repro_torch.distributed``, ``forward``/
``loss_fn``/``make_train_step`` with a mesh, expert-parallel ``moe_ffn``,
``launch/train.py --model-parallel``) on gloo CPU ranks against the JAX
package on the 8 forced host devices of ``tests/conftest.py``.

Two spawns run every rank-side case (``tests/_torch_mesh_worker.py``; torch
only): four ranks as (data=2, model=2), (pod=4) and the launcher, and
eight ranks as (data=2, model=4) and (data=1, model=8).  The reduced
archs' weights come from the JAX package's trees through
``models/weights.py`` (norm scales perturbed so they are seen) and are
sharded by ``shard_params``.  Besides the reduced Llama and Qwen3-MoE,
``forward`` and three decode steps of DeepSeek-V2-Lite (MLA, its latent
cache's positions over model), Qwen3-MoE, Mamba2 (the ssm state's heads
over model), Zamba2 (and its shared block's cache) and Whisper (encoder,
cross-attention, seeded ``enc_k``/``enc_v``), and the vlm's ``forward``
with patches, on (2, 2) against JAX's ``forward`` and ``make_serve_step``
on the same mesh; six decode steps of the Llama against caches whose
positions are split over data (batch 1 on (2, 2)), model (2 K/V heads on
(2, 4)) or both (batch 1 on (2, 4)); two microbatches of the Qwen3-MoE
(the global rows the reference takes, loss and gradients against JAX's
``make_train_step``).  Held, in fp32 at rtol 1e-4 / atol 1e-5
unless said: each rank's local shard equal to the JAX array's shard at the
same mesh coordinate; ``forward`` with heads over ``model``, with K/V heads
sliced from replicated ones, and sequence parallel (the head count does
not divide ``model``), against JAX's ``forward`` on the same mesh and the
port's unsharded ``forward``; the loss (rtol 1e-4) and every gradient
(rtol 1e-3 / atol 1e-5, phase 14's gate) against ``jax.value_and_grad`` of
``loss_fn`` with the mesh; ``adamw_update`` on DTensors fed JAX's gradients
against the unsharded update (atol 1e-6); one ``make_train_step`` step's
loss and gradient norm against JAX's ``train_step``; the int8 pod
all-reduce's payloads equal and its mean at rtol 1e-6; the expert-parallel
FFN against JAX's ``_moe_sublayer`` under ``shard_map`` with every rank's
routing equal; a checkpoint saved on (2, 2) restored on one rank bit for
bit; the launcher on four ranks exiting 0.
"""
import functools
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402
import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.distributed import compression as JCOMP  # noqa: E402
from repro.distributed.sharding import param_specs as j_param_specs  # noqa: E402
from repro.models import forward as j_forward, init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models.moe import router_probs as j_router_probs  # noqa: E402
from repro.models.transformer import _moe_sublayer as j_moe_sublayer  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig, adamw_init as j_adamw_init  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.launch.train import state_tree  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models.weights import load_tree, params_from_numpy  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train import checkpoint as TK  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
# the 6-layer hybrid's fp32 logits: JAX's own forward on the (2, 2) mesh is
# 1.04e-5 from its unsharded forward on these inputs, and the port's
# unsharded forward 1.55e-5 from JAX's, so atol 1e-5 is below the rounding
HYBRID_F32 = dict(rtol=1e-4, atol=2e-5)
GRADS = dict(rtol=1e-3, atol=1e-5)
PERTURBED = ("ln1", "ln2", "final_norm")
B, S = 4, 16
S_ENC = 8                                  # the encoder inputs' length (encdec)
LR = dict(peak_lr=1e-3, warmup_steps=1)


def _reference(arch, seed=0):
    """The JAX config and its parameter tree as numpy, norm scales moved
    from 1."""
    cfg = JC.get_reduced_config(arch)
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(seed)))

    def perturb(path, leaf):
        if getattr(path[-1], "key", "") in PERTURBED:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    return cfg, jax.tree_util.tree_map_with_path(perturb, tree)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Everything the ranks read, and the reference trees."""
    lcfg, ltree = _reference("llama3_2_1b")
    qcfg, qtree = _reference("qwen3_moe_30b_a3b", seed=3)
    refs = {"llama": (lcfg, ltree), "qwen": (qcfg, qtree)}
    for seed, (arch, prefix) in enumerate(W.FAMILIES, start=5):
        refs.setdefault(prefix, _reference(arch, seed=seed))
    wcfg = refs["whisper"][0]
    rng = np.random.default_rng(7)
    chunk = rng.integers(0, lcfg.vocab_size, (B, S + 1)).astype(np.int32)
    enc_kv = (wcfg.num_layers, B, S_ENC, wcfg.kv_heads, wcfg.hdim)
    flat = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:],
            "pod_x": rng.standard_normal((4, 3, 37)).astype(np.float32),
            "moe_h": rng.standard_normal((B, 8, qcfg.d_model)).astype(np.float32),
            "moe_r": rng.standard_normal((B, 8, qcfg.d_model)).astype(np.float32),
            "patches": rng.standard_normal(
                (B, refs["internvl"][0].vision_patches, lcfg.d_model)).astype(np.float32),
            "enc_inputs": rng.standard_normal((B, S_ENC, wcfg.d_model)).astype(np.float32),
            "enc_k": rng.standard_normal(enc_kv).astype(np.float32),
            "enc_v": rng.standard_normal(enc_kv).astype(np.float32)}
    for prefix, (_, tree) in refs.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return {"lcfg": lcfg, "ltree": ltree, "qcfg": qcfg, "qtree": qtree, "refs": refs,
            "flat": flat}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, cases, work, extra=None):
    np.savez(work / "inputs.npz", **_inputs()["flat"], **(extra or {}))
    torch.multiprocessing.spawn(W.run, args=(world, _free_port(), cases, str(work)),
                                nprocs=world, join=True)
    outs = []
    for r in range(world):
        with np.load(work / f"out{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def _jax_mesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} XLA devices (conftest forces 8)")
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """JAX's loss and gradients of the reduced Llama on (2, 2)."""
    d = _inputs()
    mesh = _jax_mesh((2, 2))
    params = jax.tree.map(jnp.asarray, d["ltree"])
    f = jax.jit(jax.value_and_grad(
        lambda p, t, lab: j_loss_fn(p, d["lcfg"], t, lab, mesh=mesh, remat=True)))
    loss, grads = f(params, d["flat"]["tokens"], d["flat"]["labels"])
    return float(loss), jax.tree.map(np.asarray, grads)


def _stacked_grads_flat():
    _, grads = _jax_grads()
    return {"jgrad/" + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The four-rank spawn's outputs, and its work directory."""
    work = tmp_path_factory.mktemp("mesh4")
    return _spawn(4, ["shards", "forward22", "train22", "adamw22", "trainpod", "serve22",
                      "families", "decode22b1", "trainmoe", "compress", "launcher"],
                  work, _stacked_grads_flat()), work


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh8")
    return _spawn(8, ["forward24", "forward18", "moe24", "decode24", "decode24b1"], work)


def _layer_leaf(tree, name):
    """The leaf of the reference's (stacked) tree that holds the port's
    parameter ``name``, and the layer index (None when unstacked)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks"):
        node = tree[parts[0]]
        for k in parts[2:]:
            node = node[k]
        return node, int(parts[1])
    node = tree
    for k in parts:
        node = node[k]
    return node, None


def _port_llama():
    return params_from_numpy(TC.get_reduced_config("llama3_2_1b"), _inputs()["ltree"],
                             device="cpu")


# -- local shards ---------------------------------------------------------------
def test_local_shards_equal_jax_shards(four):
    outs, _ = four
    d = _inputs()
    mesh = _jax_mesh((2, 2))
    specs = j_param_specs(d["ltree"], d["lcfg"], mesh)
    coords = {dev: (i, j) for (i, j), dev in np.ndenumerate(mesh.devices)}
    checked = 0
    for name in [k[len("shard/"):] for k in outs[0] if k.startswith("shard/")]:
        leaf, layer = _layer_leaf(d["ltree"], name)
        spec, _ = _layer_leaf(specs, name)
        arr = jax.device_put(leaf, NamedSharding(mesh, spec))
        for shard in arr.addressable_shards:
            i, j = coords[shard.device]
            got = outs[2 * i + j][f"shard/{name}"]
            want = np.asarray(shard.data)
            want = want[layer] if layer is not None else want
            np.testing.assert_array_equal(got, want, err_msg=name)
            checked += 1
    assert checked >= 4 * 20


# -- forward ----------------------------------------------------------------------
@pytest.mark.parametrize("key, shape", [("forward22", (2, 2)), ("forward24", (2, 4)),
                                        ("forward18", (1, 8))],
                         ids=["heads", "kv-sliced", "seq-parallel"])
def test_forward_on_a_mesh_equals_jax_and_unsharded(request, key, shape):
    outs = (request.getfixturevalue("four")[0] if key == "forward22"
            else request.getfixturevalue("eight"))
    d = _inputs()
    mesh = _jax_mesh(shape)
    want = jax.jit(lambda p, t: j_forward(p, d["lcfg"], t, mesh=mesh))(
        jax.tree.map(jnp.asarray, d["ltree"]), d["flat"]["tokens"])
    for r in (0, len(outs) - 1):
        np.testing.assert_allclose(outs[r][key], np.asarray(want), **F32)
    with torch.no_grad():
        plain = forward(_port_llama(), torch.from_numpy(d["flat"]["tokens"])).numpy()
    np.testing.assert_allclose(outs[0][key], plain, **F32)


def test_seq_parallel_branch_is_taken():
    """(1, 8): 4 heads do not divide 8, the 16 positions do."""
    d = _inputs()
    assert d["lcfg"].num_heads % 8 != 0 and S % 8 == 0
    assert d["lcfg"].num_heads % 4 == 0 and d["lcfg"].kv_heads % 4 != 0


# -- training -----------------------------------------------------------------------
def test_loss_and_gradients_on_a_mesh_equal_jax(four):
    outs, _ = four
    jloss, jgrads = _jax_grads()
    np.testing.assert_allclose(outs[0]["train22/loss"], jloss, rtol=1e-4)
    names = [k[len("train22/grad/"):] for k in outs[0] if k.startswith("train22/grad/")]
    assert len(names) == len(list(_port_llama().parameters()))
    for name in names:
        leaf, layer = _layer_leaf(jgrads, name)
        want = leaf[layer] if layer is not None else leaf
        for r in (0, 3):
            np.testing.assert_allclose(outs[r][f"train22/grad/{name}"], want, **GRADS,
                                       err_msg=name)


def test_adamw_on_dtensors_equals_unsharded(four):
    """``adamw_update`` on the sharded model fed JAX's gradients (one step,
    then the moments), against the same update on one rank."""
    outs, _ = four
    _, jgrads = _jax_grads()
    model = _port_llama()
    params = dict(model.named_parameters())
    grads = {}
    for name in params:
        leaf, layer = _layer_leaf(jgrads, name)
        grads[name] = torch.from_numpy(np.array(leaf[layer] if layer is not None else leaf))
    state = adamw_init(params)
    adamw_update(params, grads, state, AdamWConfig(**LR))
    for name, p in params.items():
        for key, want in (("param", p), ("mu", state["mu"][name]), ("nu", state["nu"][name])):
            np.testing.assert_allclose(outs[0][f"adamw22/{key}/{name}"],
                                       want.detach().numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{key} {name}")


def test_train_step_on_a_mesh_equals_jax(four):
    outs, _ = four
    d = _inputs()
    mesh = _jax_mesh((2, 2))
    params = jax.tree.map(jnp.asarray, d["ltree"])
    step = jax.jit(j_make_train_step(d["lcfg"], JAdamWConfig(**LR), mesh))
    batch = {k: jnp.asarray(d["flat"][k]) for k in ("tokens", "labels")}
    _, _, metrics = step(params, j_adamw_init(params), batch)
    np.testing.assert_allclose(outs[0]["train22/step_loss"], float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(outs[0]["train22/grad_norm"], float(metrics["grad_norm"]),
                               rtol=1e-4)


def test_train_step_with_the_compressed_pod_allreduce_equals_jax(four):
    """(pod=2, data=1, model=2), ``compress_pod_grads=True`` in both."""
    outs, _ = four
    d = _inputs()
    mesh = _jax_mesh((2, 1, 2), ("pod", "data", "model"))
    params = jax.tree.map(jnp.asarray, d["ltree"])
    step = jax.jit(j_make_train_step(d["lcfg"], JAdamWConfig(**LR), mesh,
                                     compress_pod_grads=True))
    batch = {k: jnp.asarray(d["flat"][k]) for k in ("tokens", "labels")}
    _, _, metrics = step(params, j_adamw_init(params), batch)
    for r in (0, 3):
        np.testing.assert_allclose(outs[r]["trainpod/loss"], float(metrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(outs[r]["trainpod/grad_norm"], float(metrics["grad_norm"]),
                                   rtol=1e-4)


def test_serve_and_prefill_steps_on_a_mesh_equal_jax(four):
    from repro.train.step import make_prefill_step as j_prefill, make_serve_step as j_serve
    from repro.models.transformer import init_cache as j_init_cache

    outs, _ = four
    d = _inputs()
    mesh = _jax_mesh((2, 2))
    params = jax.tree.map(jnp.asarray, d["ltree"])
    tokens = jnp.asarray(d["flat"]["tokens"])
    last = jax.jit(j_prefill(d["lcfg"], mesh))(params, {"tokens": tokens})
    np.testing.assert_allclose(outs[0]["serve22/prefill"], np.asarray(last), **F32)
    cache = j_init_cache(d["lcfg"], B, 8)
    step = jax.jit(j_serve(d["lcfg"], mesh))
    for t in range(3):
        logits, cache = step(params, cache, tokens[:, t])
        for r in (0, 3):
            np.testing.assert_allclose(outs[r][f"serve22/logits{t}"], np.asarray(logits), **F32)


def _jax_decode(cfg, params, mesh, batch, steps):
    """The logits of ``steps`` of JAX's ``make_serve_step`` with ``mesh``,
    on the worker's cache (``MAX_LEN``; encdec's ``enc_k``/``enc_v`` the
    inputs')."""
    from repro.models.transformer import init_cache as j_init_cache
    from repro.train.step import make_serve_step as j_serve

    flat = _inputs()["flat"]
    cache = j_init_cache(cfg, batch, W.MAX_LEN, enc_len=S_ENC if cfg.encdec else 0)
    if cfg.encdec:
        cache.update(enc_k=jnp.asarray(flat["enc_k"][:, :batch]),
                     enc_v=jnp.asarray(flat["enc_v"][:, :batch]))
    step = jax.jit(j_serve(cfg, mesh))
    tokens = jnp.asarray(flat["tokens"][:batch])
    out = []
    for t in range(steps):
        logits, cache = step(params, cache, tokens[:, t])
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch, prefix", W.FAMILIES, ids=[p for _, p in W.FAMILIES])
def test_family_forward_and_decode_on_a_mesh_equal_jax(four, arch, prefix):
    """MLA, the routed experts, Mamba-2 (its state's heads over model), the
    hybrid's shared block, encdec's encoder and cross-attention, and the vlm
    patches, on (2, 2) against JAX's ``forward`` and ``make_serve_step``
    with the same mesh."""
    outs, _ = four
    d = _inputs()
    cfg, tree = d["refs"][prefix]
    tol = HYBRID_F32 if cfg.family == "hybrid" else F32
    mesh = _jax_mesh((2, 2))
    params = jax.tree.map(jnp.asarray, tree)
    extra = {k: jnp.asarray(d["flat"][k]) for k, on in
             (("patches", cfg.family == "vlm"), ("enc_inputs", cfg.encdec)) if on}
    want = jax.jit(lambda p, t, e: j_forward(p, cfg, t, mesh=mesh, **e))(
        params, d["flat"]["tokens"], extra)
    for r in (0, 3):
        np.testing.assert_allclose(outs[r][f"{prefix}/forward"], np.asarray(want), **tol)
    if cfg.family == "vlm":
        return
    for t, w in enumerate(_jax_decode(cfg, params, mesh, B, 3)):
        for r in (0, 3):
            np.testing.assert_allclose(outs[r][f"{prefix}/decode/logits{t}"], w, **tol,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("key, shape, batch, seq", [
    ("decode22b1", (2, 2), 1, ("data",)), ("decode24", (2, 4), 4, ("model",)),
    ("decode24b1", (2, 4), 1, ("data", "model"))],
    ids=["seq-over-data", "seq-over-model", "seq-over-both"])
def test_sequence_split_decode_equals_jax(request, key, shape, batch, seq):
    """Six decode steps of the reduced Llama against a cache whose positions
    are split (8 over 2, 4 or 8 ranks, so the steps cross from one rank's
    positions to the next): the owning rank's write and the softmax combined
    across the ranks, against JAX's ``make_serve_step`` on the same mesh."""
    from repro.distributed.sharding import cache_specs as j_cache_specs

    outs = request.getfixturevalue("four" if shape == (2, 2) else "eight")
    if shape == (2, 2):
        outs = outs[0]
    d = _inputs()
    mesh = _jax_mesh(shape)
    seq_axes = j_cache_specs(d["lcfg"], mesh, batch)["k"][2]
    assert (seq_axes if isinstance(seq_axes, tuple) else (seq_axes,)) == seq
    params = jax.tree.map(jnp.asarray, d["ltree"])
    for t, w in enumerate(_jax_decode(d["lcfg"], params, mesh, batch, 6)):
        for r in (0, len(outs) - 1):
            np.testing.assert_allclose(outs[r][f"{key}/logits{t}"], w, **F32,
                                       err_msg=f"step {t}")


def test_microbatched_moe_train_step_on_a_mesh_equals_jax(four, monkeypatch):
    """Two microbatches of the reduced Qwen3-MoE on (2, 2): each the global
    rows the reference's reshape takes, and the loss, the gradient norm and
    the gradients AdamW is given against JAX's ``make_train_step``'s."""
    import repro.train.step as JSTEP

    outs, _ = four
    d = _inputs()
    tokens = d["flat"]["tokens"]
    for i in range(2):
        np.testing.assert_array_equal(outs[0][f"trainmoe/rows{i}"], tokens[2 * i:2 * i + 2])
    original = JSTEP.adamw_update

    def catch(params, grads, state, cfg):
        params, state, metrics = original(params, grads, state, cfg)
        return params, state, dict(metrics, grads=grads)
    monkeypatch.setattr(JSTEP, "adamw_update", catch)
    mesh = _jax_mesh((2, 2))
    params = jax.tree.map(jnp.asarray, d["qtree"])
    step = jax.jit(j_make_train_step(d["qcfg"], JAdamWConfig(**LR), mesh, microbatches=2))
    batch = {k: jnp.asarray(d["flat"][k]) for k in ("tokens", "labels")}
    _, _, metrics = step(params, j_adamw_init(params), batch)
    for r in (0, 3):
        np.testing.assert_allclose(outs[r]["trainmoe/loss"], float(metrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(outs[r]["trainmoe/grad_norm"], float(metrics["grad_norm"]),
                                   rtol=1e-4)
    names = [k[len("trainmoe/grad/"):] for k in outs[0] if k.startswith("trainmoe/grad/")]
    port = params_from_numpy(TC.get_reduced_config("qwen3_moe_30b_a3b"), d["qtree"],
                             device="cpu")
    assert len(names) == len(list(port.parameters()))
    for name in names:
        leaf, layer = _layer_leaf(metrics["grads"], name)
        want = np.asarray(leaf[layer] if layer is not None else leaf)
        np.testing.assert_allclose(outs[0][f"trainmoe/grad/{name}"], want, **GRADS,
                                   err_msg=name)


def test_checkpoint_saved_on_a_mesh_restores_on_one_rank(four):
    outs, work = four
    model = _port_llama()
    state = adamw_init(dict(model.named_parameters()))
    _, tree = TK.restore_checkpoint(str(work / "ckpt"), 1, state_tree(model, state))
    load_tree(model, tree["params"])
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), outs[0][f"train22/param/{name}"],
                                      err_msg=name)
    assert int(tree["opt"]["step"]) == 1


def test_launcher_model_parallel_on_four_ranks_exits_0(four):
    outs, _ = four
    assert [int(o["launcher/rc"]) for o in outs] == [0, 0, 0, 0]


# -- the int8 pod all-reduce ----------------------------------------------------------
def test_compressed_allreduce_payloads_and_mean_equal_jax(four):
    outs, _ = four
    x = _inputs()["flat"]["pod_x"]
    mesh = _jax_mesh((4,), ("pod",))

    def phases(xl):
        # the reference's two phases step by step, its own _quantize
        n = 4
        flat = jnp.pad(xl.reshape(-1), (0, (-xl.size) % n))
        q, scale = JCOMP._quantize(flat.reshape(n, -1))
        scales = lax.all_gather(scale, "pod")
        recv = lax.all_to_all(q, "pod", split_axis=0, concat_axis=0, tiled=False)
        summed = jnp.sum(recv.astype(jnp.float32) * scales[:, None], axis=0)
        q2, scale2 = JCOMP._quantize(summed[None, :])
        scales2 = lax.all_gather(scale2, "pod")
        return (q[None], scales[None], q2[None], scales2[None],
                JCOMP.compressed_allreduce_mean(xl[0], "pod")[None])
    spec = P("pod")
    got = shard_map(phases, mesh=mesh, in_specs=spec, out_specs=(spec,) * 5)(jnp.asarray(x))
    q, scales, q2, scales2, mean = (np.asarray(a) for a in got)
    for r in range(4):
        np.testing.assert_array_equal(outs[r]["compress/q"], q[r])
        np.testing.assert_array_equal(outs[r]["compress/scales"], scales[r])
        np.testing.assert_array_equal(outs[r]["compress/q2"], q2[r])
        np.testing.assert_array_equal(outs[r]["compress/scales2"], scales2[r])
        np.testing.assert_allclose(outs[r]["compress/mean"], mean[r], rtol=1e-6)
        np.testing.assert_array_equal(outs[r]["compress/tree"], outs[r]["compress/mean"])


# -- expert parallelism ------------------------------------------------------------------
def _jax_routing(router, x, cfg):
    """The reference's routing of tokens ``x`` (T, d) (``moe_ffn``'s first
    lines): top-k experts per token, then top-C tokens per expert."""
    T, E, k = x.shape[0], cfg.num_experts, cfg.experts_per_token
    probs = j_router_probs(x, router)
    topk_p, topk_idx = lax.top_k(probs, k)
    topk_p = topk_p / jnp.maximum(topk_p.sum(-1, keepdims=True), 1e-9)
    routed = jnp.full((T, E), -1.0, jnp.float32).at[jnp.arange(T)[:, None], topk_idx].set(topk_p)
    C = min(max(4, int(cfg.capacity_factor * T * k / E) + 1), T)
    _, tok_idx = lax.top_k(routed.T, C)
    return np.asarray(topk_idx), np.asarray(tok_idx)


def test_expert_parallel_moe_equals_jax_shard_map(eight):
    outs = eight
    d = _inputs()
    cfg = d["qcfg"]
    mesh = _jax_mesh((2, 4))
    blk = jax.tree.map(lambda a: jnp.asarray(a[0]), d["qtree"]["blocks"])
    h = jnp.asarray(d["flat"]["moe_h"])
    want = jax.jit(lambda b, x: j_moe_sublayer(b, x, cfg, mesh))(blk, h)
    np.testing.assert_allclose(outs[0]["moe24/out"], np.asarray(want), **F32)
    from repro.models.layers import rms_norm as j_rms_norm
    x = j_rms_norm(h, blk["ln2"], cfg.rms_eps)
    for r, o in enumerate(outs):
        rows = x[(r // 4) * 2:(r // 4 + 1) * 2].reshape(-1, cfg.d_model)
        topk_idx, tok_idx = _jax_routing(blk["moe"]["router"], rows, cfg)
        np.testing.assert_array_equal(o["moe24/topk_idx"], topk_idx)
        np.testing.assert_array_equal(o["moe24/tok_idx"], tok_idx)
    # the backward: JAX's shard_map transposes the replicated output, the
    # port scales each rank's copy by 1/4 and sums over model
    r_ = jnp.asarray(d["flat"]["moe_r"])
    gb, gh = jax.jit(jax.grad(lambda b, x_: jnp.sum(j_moe_sublayer(b, x_, cfg, mesh) * r_),
                              argnums=(0, 1)))(blk, h)
    np.testing.assert_allclose(outs[0]["moe24/grad/h"], np.asarray(gh), **GRADS)
    names = [k[len("moe24/grad/"):] for k in outs[0] if k.startswith("moe24/grad/")]
    assert len(names) == 1 + 1 + 1 + 3             # h, ln2, the router, the experts
    for name in names:
        if name == "h":
            continue
        parts = name.split(".")
        want = functools.reduce(lambda t, k: t[k], parts, gb)
        np.testing.assert_allclose(outs[0][f"moe24/grad/{name}"], np.asarray(want), **GRADS,
                                   err_msg=name)
