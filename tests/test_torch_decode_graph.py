"""The decode step with its position on the device (``models/transformer.py``:
``decode_tokens``, the step a ``models/graph.py::DecodeGraph`` captures) for
every family, at the reduced configs, on the CPU.

- It is bit for bit the host-int step it replaced (a copy of that step here:
  Python indices into the caches, a rope position and the encdec sinusoid
  made from the int, an int length), at every position of a short sequence.
- Driven as a graph drives it (one position tensor bumped in place, the
  tokens copied into one buffer, encdec's position table made once), it
  stays within ``tests/test_torch_models.py``'s fp32 tolerances of the JAX
  package's ``decode_step`` (rtol 1e-4 / atol 1e-5), the JAX weights carried
  across by ``params_from_numpy`` (norm scales, biases, ``dt_bias``,
  ``d_skip``, ``conv_b`` perturbed so the comparison sees them).
- Under a ``TorchDispatchMode``, one step runs no op that syncs with the
  host (``_local_scalar_dense``, ``nonzero``, ``masked_select``,
  ``unique``), and its ops, their shapes and their non-tensor arguments are
  the same at two positions: nothing position-dependent is baked in.
- ``DecodeGraph`` refuses a model on the CPU without running a step, and
  the launcher still serves every family with ``--device cpu``.

The replay itself needs a card: ``tests/test_torch_decode_graph_cuda.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import DecodeGraph, decode_step, init_cache  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import decode_attention, mla_decode_attention  # noqa: E402
from repro_torch.models.layers import apply_rope, rms_norm  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)
# one arch of each family: dense, vlm, moe (GQA), moe (MLA), ssm, hybrid, encdec
ARCHS = ["llama3_2_1b", "internvl2_76b", "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
         "mamba2_1_3b", "zamba2_1_2b", "whisper_medium"]
PERTURBED = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "ln_x": 1.0, "norm": 1.0,
             "final_norm": 1.0, "enc_norm": 1.0, "d_skip": 1.0, "dt_bias": 0.0,
             "conv_b": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0}
B, STEPS, MAX_LEN, ENC_LEN = 2, 5, 6, 5
SYNCING = ("_local_scalar_dense", "nonzero", "masked_select", "unique")


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX config, params and a numpy tree of them, PERTURBED leaves
    moved (the same objects for every test that asks: none writes to them)."""
    cfg = JC.get_reduced_config(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, params)

    def perturb(path, leaf):
        base = PERTURBED.get(getattr(path[-1], "key", ""))
        if base is None:
            return leaf
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _model(arch):
    return params_from_numpy(TC.get_reduced_config(arch), _reference(arch)[2], device=CPU)


def _tokens(cfg, seed=5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)


def _cache(cfg, seed=7):
    """A port cache; encdec's encoder K/V seeded (neither package fills them)."""
    cache = init_cache(cfg, B, MAX_LEN, enc_len=ENC_LEN, device=CPU)
    if cfg.encdec:
        rng = np.random.default_rng(seed)
        for key in ("enc_k", "enc_v"):
            cache[key].copy_(torch.from_numpy(
                rng.standard_normal(tuple(cache[key].shape)).astype(np.float32)))
    return cache


def _clone(cache):
    return {k: v if k == "len" else v.clone() for k, v in cache.items()}


def _equal(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] if k == "len" else torch.equal(a[k], b[k]) for k in a)


# -- the host-int step the device position replaced ---------------------------
def _host_int_step(model, cache, tokens):
    """``decode_step`` as it was with a host ``len``: the caches written at
    Python indices, the rope position and encdec's sinusoid made from the
    int, the attention length an int."""
    cfg = model.cfg
    cur = T.cache_position(cfg, cache)
    posv = torch.full((1,), cur, dtype=torch.int64)

    def attn(a, x, kc, vc, use_rope=True):
        q = torch.einsum("bsd,dhk->bshk", x, a.wq)
        k = torch.einsum("bsd,dhk->bshk", x, a.wk)
        v = torch.einsum("bsd,dhk->bshk", x, a.wv)
        if cfg.qkv_bias:
            q, k, v = q + a.bq, k + a.bk, v + a.bv
        if use_rope:
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
        kc[:, cur] = k[:, 0].to(kc.dtype)
        vc[:, cur] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, cur + 1)
        return torch.einsum("bshk,hkd->bsd", o, a.wo)

    def mla(a, x, ckv, kr):
        q_nope, q_rope, c_kv, k_rope = T._mla_project(a, x, cfg, posv)
        ckv[:, cur] = c_kv[:, 0].to(ckv.dtype)
        kr[:, cur] = k_rope[:, 0].to(kr.dtype)
        ctx = mla_decode_attention(a, q_nope, q_rope, ckv, kr, cur + 1, cfg)
        return torch.einsum("bshk,hkd->bsd", ctx, a.wo)

    def layer(blk, h, caches):
        x = rms_norm(h, blk.ln1, cfg.rms_eps)
        h = h + (mla if cfg.mla else attn)(blk.attn, x, *caches)
        return T._ffn_sublayer(blk, h, cfg)

    h = model.embed[tokens][:, None, :]
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        for idx, blk in enumerate(model.blocks):
            h = T._decode_mamba(blk, h, cfg, cache["ssm"][idx], cache["conv"][idx])
            if cfg.family == "hybrid" and idx % every == every - 1:
                site = idx // every
                h = layer(model.shared_block, h, (cache["sk"][site], cache["sv"][site]))
    elif cfg.encdec:
        h = h + T._positions(cur + 1, cfg, h)[cur]
        for li, blk in enumerate(model.blocks):
            x = rms_norm(h, blk.ln1, cfg.rms_eps)
            h = h + attn(blk.attn, x, cache["k"][li], cache["v"][li], use_rope=False)
            q = torch.einsum("bsd,dhk->bshk", rms_norm(h, blk.ln_x, cfg.rms_eps), blk.xattn.wq)
            enc_k = cache["enc_k"][li]
            o = decode_attention(q, enc_k, cache["enc_v"][li], enc_k.shape[1])
            h = h + torch.einsum("bshk,hkd->bsd", o, blk.xattn.wo)
            h = T._ffn_sublayer(blk, h, cfg)
    else:
        for li, blk in enumerate(model.blocks):
            h = layer(blk, h, T.layer_caches(cfg, cache, li))
    cache["len"] = cur + 1
    return T._head(model, h)[:, 0, :], cache


@pytest.mark.parametrize("arch", ARCHS)
def test_device_position_step_equals_the_host_int_step(arch):
    """At every position of the sequence, from the same cache: logits and
    every cache tensor ``torch.equal`` (``decode_step``, whose device work
    is ``decode_tokens`` at a position tensor, against the host-int copy)."""
    model = _model(arch)
    tokens = torch.from_numpy(_tokens(model.cfg)).long()
    got_c = _cache(model.cfg)
    want_c = _clone(got_c)
    for t in range(STEPS):
        got, got_c = decode_step(model, got_c, tokens[:, t])
        want, want_c = _host_int_step(model, want_c, tokens[:, t])
        assert torch.equal(got, want), (arch, t)
        assert _equal(got_c, want_c), (arch, t)
    assert got_c["len"] == STEPS


# -- against the JAX package, driven as a graph drives it -----------------------
@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    return jax.jit(lambda p, c, t: j_decode_step(p, cfg, c, t))


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_driven_steps_match_the_reference(arch):
    """One position tensor bumped in place after each step, the tokens
    copied into one buffer, encdec's table made once (``DecodeGraph``'s
    static inputs), against ``jax.jit(decode_step)`` at fp32 rtol 1e-4 /
    atol 1e-5, logits and caches."""
    cfg, params, _ = _reference(arch)
    model = _model(arch)
    tokens = _tokens(cfg)
    tc = _cache(model.cfg)
    jc = j_init_cache(cfg, B, MAX_LEN, enc_len=ENC_LEN)
    if cfg.encdec:
        jc.update(enc_k=jnp.asarray(tc["enc_k"].numpy()), enc_v=jnp.asarray(tc["enc_v"].numpy()))
    pos = torch.zeros((), dtype=torch.int64)
    buf = torch.zeros(B, dtype=torch.int64)
    pe = T.position_table(model, tc)
    for t in range(STEPS):
        jl, jc = _jax_step(cfg)(params, jc, jnp.asarray(tokens[:, t]))
        buf.copy_(torch.from_numpy(tokens[:, t]))
        tl = T.decode_tokens(model, tc, buf, pos, pe)
        pos.add_(1)
        assert tl.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert int(pos) == int(jc["len"]) == STEPS
    for key in tc:
        if key != "len":
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32)


# -- what one step dispatches ---------------------------------------------------
class _OpLog(TorchDispatchMode):
    """Every aten op of the block with its tensors' shapes and dtypes and its
    other arguments as they are."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        self.ops.append((str(func), tuple(
            ("tensor", tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x
            for x in leaves)))
        return func(*args, **kwargs)


def _logged_step(model, cache, tokens, at: int):
    """The ops of ``decode_tokens`` at position ``at``, after steps up to it."""
    pe = T.position_table(model, cache)
    for t in range(at):
        T.decode_tokens(model, cache, tokens[:, t], torch.tensor(t), pe)
    tok, pos = tokens[:, at].clone(), torch.tensor(at)
    with _OpLog() as log:
        T.decode_tokens(model, cache, tok, pos, pe)
    return log.ops


@pytest.mark.parametrize("arch", ARCHS)
def test_step_syncs_with_no_host_and_bakes_in_no_position(arch):
    """No op of a step reads a device value on the host, and the step at
    position 1 and at position 4 dispatches the same ops with the same
    shapes and non-tensor arguments: a graph captured at one serves all."""
    model = _model(arch)
    tokens = torch.from_numpy(_tokens(model.cfg)).long()
    early = _logged_step(model, _cache(model.cfg), tokens, 1)
    late = _logged_step(model, _cache(model.cfg), tokens, 4)
    names = {name for name, _ in early}
    assert not [n for n in names if any(s in n for s in SYNCING)], sorted(names)
    assert len(early) > 20
    assert early == late


# -- DecodeGraph and the launcher ----------------------------------------------
def test_decode_graph_refuses_the_cpu_and_runs_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(T, "decode_tokens", lambda *a, **k: calls.append(a))
    model = _model("llama3_2_1b")
    cache = _cache(model.cfg)
    kept = _clone(cache)
    with pytest.raises(ValueError, match="on one CUDA device, not on \\['cpu'\\]"):
        DecodeGraph(model, cache)
    assert calls == [] and _equal(cache, kept)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_every_family_on_the_cpu(arch, capsys):
    """``--device cpu``: the eager step (a graph needs a card), exit 0."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--prompt-len", "4",
            "--gen-tokens", "3"]
    assert launch_serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={TC.get_reduced_config(arch).name} ")
    assert "device=cpu" in line and "graph_capture" not in line
