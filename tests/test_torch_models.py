"""The port's model substrate (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's ``repro.configs`` and ``repro.models``.

The same seeded numpy inputs go through both: the ten architecture configs,
the layers, attention, and ``forward`` / ``decode_step`` of four reduced
dense and vlm architectures, with the JAX package's weights carried across by
``models.weights.params_from_numpy``; plus one layer of TinyLlama at its
published widths.  Tolerances: fp32 rtol 1e-4 / atol 1e-5 for attention and
the models (the JAX package's own offload tolerance), rtol 1e-5 / atol 1e-6
for the single layers, bf16 atol 2e-2 (one bf16 rounding of values near 1),
and the JAX package's incremental-against-full 2e-2 / 2e-3.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CacheFullError,
    decode_step,
    forward,
    init_cache,
    init_params,
)
from repro_torch.models.weights import params_from_numpy, params_to_numpy  # noqa: E402

CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)
LAYER_F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, LAYER_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
MODEL_ARCHS = ["llama3_2_1b", "tinyllama_1_1b", "qwen2_5_14b", "internvl2_76b"]


@pytest.fixture(autouse=True)
def _exact_fp32():
    """fp32 matmuls in fp32 (no TF32 where a card would allow it)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arr: np.ndarray, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


# -- configs -------------------------------------------------------------------
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_configs_match_the_reference(arch):
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for getter in ("get_config", "get_reduced_config"):
        j, t = getattr(JC, getter)(arch), getattr(TC, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.kv_heads, t.hdim, t.d_inner, t.ssm_heads) == (
            j.kv_heads, j.hdim, j.d_inner, j.ssm_heads)
        assert str(t.torch_dtype).split(".")[-1] == jnp.dtype(j.jdtype).name
        assert dataclasses.asdict(t.with_(num_layers=1)) == dataclasses.asdict(
            j.with_(num_layers=1))
    assert ([dataclasses.asdict(s) for s in TC.shape_cells(arch)]
            == [dataclasses.asdict(s) for s in JC.shape_cells(arch)])
    assert [(a, s.name) for a, s in TC.all_cells()] == [(a, s.name) for a, s in JC.all_cells()]


# -- layers --------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(scale, dtype)
    got, want = TL.rms_norm(tx, ts, 1e-5), JL.rms_norm(jx, js, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np32(got), _np32(want), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_rope_matches_the_reference(dtype, per_batch):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = (rng.integers(0, 4096, (2, 7)) if per_batch else np.arange(7) + 3)
    jx, tx = _pair(x, dtype)
    for theta in (10000.0, 500000.0):
        got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
        want = JL.apply_rope(jx, jnp.asarray(pos), theta)
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np32(got), _np32(want),
                                   **(BF16 if dtype == "bfloat16" else F32))
    np.testing.assert_allclose(TL.rope_freqs(32, 500000.0).numpy(),
                               np.asarray(JL.rope_freqs(32, 500000.0)), **LAYER_F32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_matches_the_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((48, 96), (48, 96), (96, 48))]
    jw, tw = zip(*(_pair(w, dtype) for w in ws))
    jx, tx = _pair(x, dtype)
    got, want = TL.swiglu(tx, *tw), JL.swiglu(jx, *jw)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16
    np.testing.assert_allclose(_np32(got), _np32(want), **tol)


def test_sinusoidal_positions_and_initialisers():
    np.testing.assert_allclose(TL.sinusoidal_positions(24, 64).numpy(),
                               np.asarray(JL.sinusoidal_positions(24, 64)), **LAYER_F32)
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (256, 4, 64), torch.float32)
    assert w.shape == (256, 4, 64) and abs(float(w.std()) - 256 ** -0.5) < 2e-3
    e = TL.embed_init(g, (512, 64), torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) < 1e-3
    again = TL.dense_init(torch.Generator().manual_seed(0), (256, 4, 64), torch.float32)
    assert torch.equal(w, again)


# -- attention -----------------------------------------------------------------
def _qkv(rng, B, Sq, Skv, Hq, Hkv, D):
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0), (True, 6)])
def test_flash_attention_matches_the_reference(groups, causal, q_offset):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 7, 19, 2 * groups, 2, 16)   # 19 KV rows: chunks of 8, padded
    got = TA.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                             q_offset=q_offset, chunk=8)
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              q_offset=q_offset, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_the_reference(groups, per_row):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 1, 12, 2 * groups, 2, 16)
    cur = np.array([5, 12, 1], np.int32) if per_row else np.array(9, np.int32)
    got = TA.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(cur).long())
    want = JA.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(cur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if not per_row:
        same = TA.decode_attention(*map(torch.from_numpy, (q, k, v)), 9)
        assert torch.equal(same, got)


# -- the models ----------------------------------------------------------------
def _reference(arch: str, cfg=None, seed: int = 0):
    """The JAX config, params and a numpy tree of them, with the norms' scales
    and the qkv biases perturbed from their initial ones and zeros so that the
    comparison sees them."""
    cfg = cfg or JC.get_reduced_config(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, params)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            base = 1.0 if name.startswith(("ln", "final")) else 0.0
            return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _patches(cfg, B, seed=6):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)


def _port(arch, tree, cfg=None):
    return params_from_numpy(cfg or TC.get_reduced_config(arch), tree, device=CPU)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_matches_the_reference(arch):
    cfg, params, tree = _reference(arch)
    model = _port(arch, tree)
    tokens, patches = _tokens(cfg, 2, 12), _patches(cfg, 2)
    want = j_forward(params, cfg, jnp.asarray(tokens),
                     patches=None if patches is None else jnp.asarray(patches))
    got = forward(model, torch.from_numpy(tokens).long(),
                  patches=None if patches is None else torch.from_numpy(patches))
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _decode_both(cfg, params, model, tokens, max_len):
    """Decode ``tokens`` one step at a time through both packages; the
    per-step logits and both final caches."""
    B, T = tokens.shape
    jstep = jax.jit(lambda p, c, t: j_decode_step(p, cfg, c, t))
    jc = j_init_cache(cfg, B, max_len)
    tc = init_cache(model.cfg, B, max_len, device=CPU)
    steps = []
    for t in range(T):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, t]))
        tl, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
        steps.append((tl, jl))
    return steps, tc, jc


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_steps_match_the_reference(arch):
    cfg, params, tree = _reference(arch)
    model = _port(arch, tree)
    tokens = _tokens(cfg, 2, 6)
    steps, tc, jc = _decode_both(cfg, params, model, tokens, max_len=8)
    for got, want in steps:
        assert got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert tc["len"] == int(jc["len"]) == 6
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_incremental_decode_equals_full_forward(arch):
    cfg = TC.get_reduced_config(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(3), device=CPU)
    tokens = torch.from_numpy(_tokens(cfg, 1, 8, seed=7)).long()
    full = forward(model, tokens)
    cache = init_cache(cfg, 1, 8, device=CPU)
    inc = []
    for t in range(8):
        logits, cache = decode_step(model, cache, tokens[:, t])
        inc.append(logits)
    np.testing.assert_allclose(full.numpy(), torch.stack(inc, 1).numpy(),
                               rtol=2e-2, atol=2e-3)


def test_one_layer_at_published_widths_matches_the_reference():
    """TinyLlama 1.1B's published widths (d 2048, 32 heads over 4 KV heads,
    ff 5632, vocabulary 32000), one layer, fp32: two decode steps."""
    jcfg = JC.get_config("tinyllama_1_1b").with_(num_layers=1, dtype="float32")
    cfg, params, tree = _reference("tinyllama_1_1b", cfg=jcfg)
    model = _port("tinyllama_1_1b", tree,
                  TC.get_config("tinyllama_1_1b").with_(num_layers=1, dtype="float32"))
    steps, tc, jc = _decode_both(cfg, params, model, _tokens(cfg, 2, 2), max_len=4)
    for got, want in steps:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **F32)


# -- C4: a decode step past the cache ------------------------------------------
def test_decode_past_the_cache_raises_where_the_reference_clamps():
    """ROADMAP C4.  The reference writes the new K/V with
    ``lax.dynamic_update_slice``, which clamps its start: with 3 slots, steps
    4 and 5 overwrite the last slot, and ``len`` ends at 5 with finite logits.
    The port raises ``CacheFullError`` at step 4."""
    cfg, params, tree = _reference("llama3_2_1b")
    tokens = _tokens(cfg, 2, 5)
    jc = j_init_cache(cfg, 2, 3)
    ks = []
    for t in range(5):
        jl, jc = j_decode_step(params, cfg, jc, jnp.asarray(tokens[:, t]))
        ks.append(np.asarray(jc["k"])[:, :, 2].copy())
    assert int(jc["len"]) == 5 and np.isfinite(np.asarray(jl)).all()
    assert not np.array_equal(ks[2], ks[4])          # slot 2 was overwritten

    model = _port("llama3_2_1b", tree)
    tc = init_cache(model.cfg, 2, 3, device=CPU)
    for t in range(3):
        _, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
    kept = tc["k"].clone()
    with pytest.raises(CacheFullError, match="len 3: the cache holds 3"):
        decode_step(model, tc, torch.from_numpy(tokens[:, 3]).long())
    assert tc["len"] == 3 and torch.equal(tc["k"], kept)


# -- weights and families ------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weights_round_trip(dtype):
    jcfg = JC.get_reduced_config("qwen2_5_14b").with_(dtype=dtype)
    params = j_init_params(jcfg, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(TC.get_reduced_config("qwen2_5_14b").with_(dtype=dtype),
                              tree, device=CPU)
    assert model.embed.dtype == DTYPES[dtype][1]
    back = params_to_numpy(model)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(flat_back[path], leaf.astype(np.float32))
    assert len(flat_back) == len(jax.tree.leaves(tree))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(model.cfg, bad, device=CPU)
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(model.cfg, bad, device=CPU)

