"""The port's ssm, hybrid and encdec families (``repro_torch.models.ssm``,
their branches of ``models/transformer.py`` and ``models/weights.py``, the
launcher) against the JAX package's ``repro.models``.

The same seeded numpy inputs go through both: the Mamba-2 pieces
(``_depthwise_causal_conv``, ``ssd_chunked`` over several chunks and a
ragged tail, ``ssd_decode_step``, ``mamba2_forward``, ``mamba2_decode``), then
``forward`` and ``decode_step`` of the reduced Mamba2 1.3B, Zamba2 1.2B and
Whisper medium with the JAX package's weights carried across by
``params_from_numpy`` (norm scales, ``dt_bias``, ``d_skip`` and ``conv_b``
perturbed so that the comparison sees them).  No Pallas kernel is involved:
``ssd_chunked`` is ``jnp`` under XLA there and torch ops here.  Tolerances:
fp32 rtol 1e-4 / atol 1e-5 for the models, rtol 1e-5 / atol 1e-6 for the
single layers, bf16 atol 2e-2 (one bf16 rounding of values near 1), and the
JAX package's incremental-against-full 2e-2 / 2e-3.  On the card,
``chip_smoke.py --ssm`` runs the same path at the published widths.
"""
import functools
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CacheFullError,
    decode_step,
    forward,
    init_cache,
    init_params,
)
from repro_torch.models.transformer import Mamba  # noqa: E402
from repro_torch.models.weights import params_from_numpy, params_to_numpy  # noqa: E402

CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)
LAYER_F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0, atol=2e-2)
INC = dict(rtol=2e-2, atol=2e-3)
DTYPES = {"float32": (jnp.float32, torch.float32, LAYER_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
ARCHS = ["mamba2_1_3b", "zamba2_1_2b", "whisper_medium"]
SCAN_ARCHS = ["mamba2_1_3b", "zamba2_1_2b"]
# The leaves perturbed from their initial values, and the value each is
# perturbed around.
PERTURBED = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "ln_x": 1.0, "norm": 1.0,
             "final_norm": 1.0, "enc_norm": 1.0, "d_skip": 1.0, "dt_bias": 0.0,
             "conv_b": 0.0}


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


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- the Mamba-2 pieces ----------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_depthwise_causal_conv_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_normal(rng, 2, 9, 12), dtype)
    jw, tw = _pair(_normal(rng, 4, 12, scale=0.5), dtype)
    got = TS._depthwise_causal_conv(tx, tw)
    want = JS._depthwise_causal_conv(jx, jw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 9, 12)
    np.testing.assert_allclose(_np32(got), _np32(want), **DTYPES[dtype][2])


def test_softplus_matches_the_reference_in_fp32():
    """``F.softplus`` returns ``x`` above its threshold of 20, where
    ``jax.nn.softplus`` computes ``logaddexp(x, 0)``: in fp32 they agree."""
    x = np.concatenate([np.linspace(-30, 30, 601), [19.99, 20.0, 20.01, 25.0, 88.0]])
    x = x.astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **LAYER_F32)
    np.testing.assert_array_equal(got[x > 20], want[x > 20])


def _ssd_inputs(B, S, H, P, N, seed=1, state=False):
    rng = np.random.default_rng(seed)
    arrays = dict(x=_normal(rng, B, S, H, P),
                  dt=np.log1p(np.exp(_normal(rng, B, S, H))).astype(np.float32),
                  A=-np.exp(_normal(rng, H, scale=0.5)),
                  Bm=_normal(rng, B, S, N, scale=0.5), Cm=_normal(rng, B, S, N, scale=0.5),
                  D=_normal(rng, H) + 1.0)
    if state:
        arrays["init_state"] = _normal(rng, B, H, P, N)
    return arrays


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk,S", [(4, 10), (4, 8), (3, 2), (16, 10)])
def test_ssd_chunked_matches_the_reference(chunk, S, with_state):
    """Several chunks with a ragged tail (chunk 4, S 10: three chunks, two
    padded steps), whole chunks, and one chunk shorter than ``chunk``."""
    a = _ssd_inputs(2, S, 3, 4, 5, state=with_state)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    init = "init_state" in a
    want_y, want_s = JS.ssd_chunked(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"], j["D"], chunk,
                                    j["init_state"] if init else None)
    got_y, got_s = TS.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"], chunk,
                                  t["init_state"] if init else None)
    assert got_y.shape == (2, S, 3, 4) and got_s.shape == (2, 3, 4, 5)
    assert got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **LAYER_F32)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LAYER_F32)


def test_ssd_chunked_equals_the_recurrence():
    """The chunked scan over 10 steps (chunk 4) equals 10 decode steps."""
    a = _ssd_inputs(2, 10, 3, 4, 5, state=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, final = TS.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"], 4,
                              t["init_state"])
    state = t["init_state"]
    for s in range(10):
        ys, state = TS.ssd_decode_step(state, t["x"][:, s], t["dt"][:, s], t["A"],
                                       t["Bm"][:, s], t["Cm"][:, s], t["D"])
        np.testing.assert_allclose(ys.numpy(), y[:, s].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), final.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_step_matches_the_reference(dtype):
    rng = np.random.default_rng(2)
    B, H, P, N = 3, 4, 5, 6
    state = _normal(rng, B, H, P, N)
    jx, tx = _pair(_normal(rng, B, H, P), dtype)
    jdt, tdt = _pair(np.log1p(np.exp(_normal(rng, B, H))).astype(np.float32), dtype)
    jb, tb = _pair(_normal(rng, B, N), dtype)
    jc, tc = _pair(_normal(rng, B, N), dtype)
    A, D = -np.exp(_normal(rng, H, scale=0.5)), _normal(rng, H) + 1.0
    want_y, want_s = JS.ssd_decode_step(jnp.asarray(state), jx, jdt, jnp.asarray(A), jb, jc,
                                        jnp.asarray(D))
    got_y, got_s = TS.ssd_decode_step(torch.from_numpy(state), tx, tdt, torch.from_numpy(A),
                                      tb, tc, torch.from_numpy(D))
    assert got_y.dtype == DTYPES[dtype][1] and got_s.dtype == torch.float32
    np.testing.assert_allclose(_np32(got_y), _np32(want_y), **DTYPES[dtype][2])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LAYER_F32)


def _mamba_weights(cfg, seed):
    """A mixer's weights as numpy fp32, with ``dt_bias``, ``d_skip`` and
    ``conv_b`` away from their initial values so that they are seen."""
    rng = np.random.default_rng(seed)
    d, di, N, H, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {"in_proj": _normal(rng, d, 2 * di + 2 * N + H, scale=d ** -0.5),
            "conv_w": _normal(rng, K, di + 2 * N, scale=0.5),
            "conv_b": _normal(rng, di + 2 * N, scale=0.1),
            "dt_bias": _normal(rng, H, scale=0.5),
            "a_log": np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
            "d_skip": 1.0 + _normal(rng, H, scale=0.3),
            "norm": 1.0 + _normal(rng, di, scale=0.1),
            "out_proj": _normal(rng, di, d, scale=di ** -0.5)}


_FP32_LEAVES = ("dt_bias", "a_log", "d_skip")


def _both_mambas(cfg, w, dtype):
    """The reference's mixer dict and the port's ``Mamba``, the three fp32
    leaves fp32 in both whatever ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k in _FP32_LEAVES else jdt)
          for k, v in w.items()}
    tm = Mamba(cfg, tdt, torch.device(CPU))
    for name, p in tm.named_parameters():
        p.copy_(torch.from_numpy(w[name]))
    assert tm.dt_bias.dtype == tm.a_log.dtype == tm.d_skip.dtype == torch.float32
    return jp, tm


@functools.lru_cache(maxsize=None)
def _jax_mamba(cfg):
    return jax.jit(lambda p, x, s: JS.mamba2_forward(p, x, cfg, s))


def _ssm_cfg(dtype, chunk=4):
    return TC.get_reduced_config("mamba2_1_3b").with_(dtype=dtype, ssm_chunk=chunk)


def _mamba_inputs(cfg, dtype, with_state, seed=4):
    rng = np.random.default_rng(seed)
    jx, tx = _pair(_normal(rng, 2, 10, cfg.d_model), dtype)
    state = (_normal(rng, 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
             if with_state else None)
    return (jx, None if state is None else jnp.asarray(state),
            tx, None if state is None else torch.from_numpy(state))


def test_mamba2_forward_matches_the_reference():
    cfg = _ssm_cfg("float32")
    jp, tm = _both_mambas(cfg, _mamba_weights(cfg, 3), "float32")
    jx, js, tx, ts = _mamba_inputs(cfg, "float32", True)
    want, want_s = _jax_mamba(cfg)(jp, jx, js)
    got, got_s = TS.mamba2_forward(tm, tx, cfg, ts)
    assert got.dtype == torch.float32 and got.shape == (2, 10, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32)
    # dt_bias and d_skip are seen: moving either moves the output
    for name in ("dt_bias", "d_skip"):
        p = getattr(tm, name)
        kept = p.clone()
        p.add_(0.5)
        assert not torch.allclose(TS.mamba2_forward(tm, tx, cfg, ts)[0], got)
        p.copy_(kept)


def _reference_silu(x):
    """``jax.nn.silu`` as the installed JAX lowers it: ``x * (1 / (1 +
    exp(-x)))``, each op rounded to ``x``'s dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def test_mamba2_forward_bf16_equals_the_reference_but_for_silu_rounding(monkeypatch):
    """In bf16 the port's ``F.silu`` rounds once where the reference's
    rounds its sigmoid's exp, add and divide in turn; over the scan that
    moves a few outputs by up to two bf16 steps (0.033 at 2.4 here).  With
    the reference's rounding put in its place, the port's bf16 forward
    (conv, bias and ``silu`` in bf16, the scan in fp32) is bit for bit the
    reference's run op by op (under ``jax.jit`` XLA fuses the fp32 conv
    sum, which moves its bf16 rounding too)."""
    cfg = _ssm_cfg("bfloat16")
    jp, tm = _both_mambas(cfg, _mamba_weights(cfg, 3), "bfloat16")
    jx, js, tx, ts = _mamba_inputs(cfg, "bfloat16", True)
    np.testing.assert_array_equal(_np32(_reference_silu(tx)), _np32(jax.nn.silu(jx)))
    want, want_s = JS.mamba2_forward(jp, jx, cfg, js)
    monkeypatch.setattr(torch.nn.functional, "silu", _reference_silu)
    got, got_s = TS.mamba2_forward(tm, tx, cfg, ts)
    assert got.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(_np32(got), _np32(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_decode_matches_the_reference(dtype):
    cfg = _ssm_cfg(dtype)
    jp, tm = _both_mambas(cfg, _mamba_weights(cfg, 5), dtype)
    rng = np.random.default_rng(6)
    B, H, P, N = 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    ssm_state = _normal(rng, B, H, P, N)
    jx, tx = _pair(_normal(rng, B, cfg.d_model), dtype)
    jconv, tconv = _pair(_normal(rng, B, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), dtype)
    want = jax.jit(lambda p, x, st, cv: JS.mamba2_decode(p, x, cfg, st, cv))(
        jp, jx, jnp.asarray(ssm_state), jconv)
    got = TS.mamba2_decode(tm, tx, cfg, torch.from_numpy(ssm_state), tconv)
    tol = DTYPES[dtype][2]
    assert got[0].dtype == DTYPES[dtype][1] and got[1].dtype == torch.float32
    assert got[2].shape == (B, cfg.ssm_conv - 1, cfg.d_inner + 2 * N)
    np.testing.assert_allclose(_np32(got[0]), _np32(want[0]),
                               **(F32 if dtype == "float32" else tol))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **(F32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(_np32(got[2]), _np32(want[2]), **tol)


# -- the models ----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32", seed=0):
    """The JAX config, params and a numpy tree of them, with the leaves of
    PERTURBED moved from their initial values (the same objects for every
    test that asks: none of them writes to them)."""
    cfg = JC.get_reduced_config(arch).with_(dtype=dtype)
    params = j_init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, params)

    def perturb(path, leaf):
        base = PERTURBED.get(getattr(path[-1], "key", ""))
        if base is None:
            return leaf
        moved = base + 0.1 * rng.standard_normal(leaf.shape)
        return np.asarray(jnp.asarray(moved.astype(np.float32)).astype(leaf.dtype))
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(lambda p, t, e: j_forward(p, cfg, t, enc_inputs=e))


@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    return jax.jit(lambda p, c, t: j_decode_step(p, cfg, c, t))


def _port(arch, tree, dtype="float32"):
    return params_from_numpy(TC.get_reduced_config(arch).with_(dtype=dtype), tree,
                             device=CPU)


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _enc_inputs(cfg, B, S, seed=6):
    if not cfg.encdec:
        return None
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    cfg, params, tree = _reference(arch)
    model = _port(arch, tree)
    tokens, enc = _tokens(cfg, 2, 12), _enc_inputs(cfg, 2, 7)
    want = _jax_forward(cfg)(params, jnp.asarray(tokens),
                             None if enc is None else jnp.asarray(enc))
    got = forward(model, torch.from_numpy(tokens).long(),
                  enc_inputs=None if enc is None else torch.from_numpy(enc))
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _stub(cache, value):
    """encdec's encoder K/V as the launchers fill them: ``value`` everywhere,
    or seeded values (``value`` None), the same in both packages."""
    out = dict(cache)
    for seed, key in enumerate(("enc_k", "enc_v")):
        if value is None:
            arr = np.random.default_rng(seed).standard_normal(cache[key].shape)
            arr = arr.astype(np.float32)
        else:
            arr = np.full(cache[key].shape, value, np.float32)
        out[key] = (torch.from_numpy(arr) if isinstance(cache[key], torch.Tensor)
                    else jnp.asarray(arr))
    return out


def _decode_both(arch, tokens, max_len, enc_value=0.01):
    """Decode ``tokens`` one step at a time through both packages (encdec's
    encoder K/V stubbed alike); the per-step logits and both final caches."""
    cfg, params, tree = _reference(arch)
    model = _port(arch, tree)
    B, T = tokens.shape
    jstep = _jax_step(cfg)
    jc, tc = j_init_cache(cfg, B, max_len, enc_len=5), init_cache(model.cfg, B, max_len,
                                                                   enc_len=5, device=CPU)
    if cfg.encdec:
        jc, tc = _stub(jc, enc_value), _stub(tc, enc_value)
    steps = []
    for t in range(T):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, t]))
        tl, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
        steps.append((tl, jl))
    return steps, tc, jc


@pytest.mark.parametrize("arch,enc_value", [("mamba2_1_3b", None), ("zamba2_1_2b", None),
                                            ("whisper_medium", 0.01),
                                            ("whisper_medium", None)])
def test_decode_steps_match_the_reference(arch, enc_value):
    """encdec decode is held against the JAX ``decode_step`` only (neither
    package computes ``enc_k``/``enc_v`` from an encoder pass): with the
    launchers' 0.01 stub and with seeded values."""
    cfg = JC.get_reduced_config(arch)
    tokens = _tokens(cfg, 2, 6)
    steps, tc, jc = _decode_both(arch, tokens, max_len=8, enc_value=enc_value)
    for got, want in steps:
        assert got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert tc["len"] == int(jc["len"]) == 6
    assert sorted(tc) == sorted(jc)
    for key in tc:
        if key != "len":
            assert tc[key].shape == jc[key].shape and tc[key].dtype == _torch_dtype(jc[key])
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32)


def _torch_dtype(a):
    return {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}[a.dtype]


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_incremental_decode_equals_full_forward(arch):
    """The port's decode against its own forward, for both scan archs (the
    JAX package's test covers only mamba2), over more than one chunk."""
    cfg = TC.get_reduced_config(arch).with_(ssm_chunk=3)
    model = init_params(cfg, generator=torch.Generator().manual_seed(3), device=CPU)
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, seed=7)).long()
    full = forward(model, tokens)
    cache = init_cache(cfg, 2, 8, device=CPU)
    inc = []
    for t in range(8):
        logits, cache = decode_step(model, cache, tokens[:, t])
        inc.append(logits)
    np.testing.assert_allclose(full.numpy(), torch.stack(inc, 1).numpy(), **INC)


def test_bf16_model_keeps_its_fp32_leaves_and_states():
    cfg = TC.get_reduced_config("zamba2_1_2b").with_(dtype="bfloat16")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    m = model.blocks[0].mamba
    assert m.in_proj.dtype == m.conv_w.dtype == torch.bfloat16
    assert m.dt_bias.dtype == m.a_log.dtype == m.d_skip.dtype == torch.float32
    assert model.shared_block.attn.wq.dtype == torch.bfloat16
    cache = init_cache(cfg, 2, 4, device=CPU)
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    sites = cfg.num_layers // cfg.shared_attn_every
    assert cache["sk"].shape == (sites, 2, 4, cfg.kv_heads, cfg.hdim)
    logits, cache = decode_step(model, cache, torch.zeros(2, dtype=torch.long))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    assert cache["ssm"].dtype == torch.float32 and cache["ssm"].abs().sum() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(arch, dtype):
    """The reference's tree through the port and back: the hybrid's nested
    ``shared_block``, encdec's stacked ``enc_blocks`` and the fp32
    ``dt_bias``/``a_log``/``d_skip`` of a bf16 model come back as they were
    (bf16 as float32, exactly), and the JAX forward of the tree that comes
    back equals the original's."""
    jcfg, params, tree = _reference(arch, dtype)
    model = _port(arch, tree, dtype)
    if jcfg.ssm:
        m = model.blocks[0].mamba
        assert m.dt_bias.dtype == torch.float32 and m.in_proj.dtype == DTYPES[dtype][1]
    back = params_to_numpy(model)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat.keys()
    assert set(back) == set(tree)
    for path, leaf in flat.items():
        assert flat_back[path].dtype == np.float32
        np.testing.assert_array_equal(flat_back[path], leaf.astype(np.float32))
    if dtype == "float32":
        tokens, enc = jnp.asarray(_tokens(jcfg, 2, 12)), _enc_inputs(jcfg, 2, 7)
        enc = None if enc is None else jnp.asarray(enc)
        fwd = _jax_forward(jcfg)
        np.testing.assert_array_equal(
            np.asarray(fwd(jax.tree.map(jnp.asarray, back), tokens, enc)),
            np.asarray(fwd(params, tokens, enc)))
    key = "enc_blocks" if jcfg.encdec else "blocks"
    short = dict(tree, **{key: jax.tree.map(lambda a: a[:-1], tree[key])})
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_numpy(model.cfg, short, device=CPU)


# -- C4: a decode step past the cache ------------------------------------------
def _clamping_reference(arch, tokens, slots, key):
    """The JAX package's decode of ``tokens`` on a cache of ``slots``
    positions: it runs past the end, and the last slot of ``key`` is
    overwritten."""
    cfg, params, _ = _reference(arch)
    jc = j_init_cache(cfg, tokens.shape[0], slots, enc_len=3)
    jstep = _jax_step(cfg)
    last = []
    for t in range(tokens.shape[1]):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, t]))
        last.append(np.asarray(jc[key])[:, :, slots - 1].copy())
    assert int(jc["len"]) == tokens.shape[1] and np.isfinite(np.asarray(jl)).all()
    assert not np.array_equal(last[slots - 1], last[-1])


@pytest.mark.parametrize("arch,key", [("zamba2_1_2b", "sk"), ("whisper_medium", "k")])
def test_decode_past_the_cache_raises_where_the_reference_clamps(arch, key):
    """ROADMAP C4 at the hybrid's shared-block cache and encdec's
    self-attention cache (and its position slice): the reference clamps (a
    reduced Zamba2 with 3 slots ends 5 steps at ``len`` 5 with finite
    logits); the port raises ``CacheFullError`` at step 4 before any state
    is written: ``ssm``, ``conv``, ``sk``, ``sv`` (or ``k``, ``v``) as the
    third step left them."""
    cfg = JC.get_reduced_config(arch)
    tokens = _tokens(cfg, 2, 5)
    _clamping_reference(arch, tokens, 3, key)
    _, _, tree = _reference(arch)
    model = _port(arch, tree)
    tc = init_cache(model.cfg, 2, 3, enc_len=3, device=CPU)
    for t in range(3):
        _, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
    kept = {k: v.clone() for k, v in tc.items() if k != "len"}
    with pytest.raises(CacheFullError, match="len 3: the cache holds 3"):
        decode_step(model, tc, torch.from_numpy(tokens[:, 3]).long())
    assert tc["len"] == 3
    assert all(torch.equal(tc[k], v) for k, v in kept.items()), sorted(kept)


def test_pure_ssm_cache_decodes_past_max_len_as_the_reference():
    """A Mamba-2 stack's cache has no length in either package: 5 steps on
    a cache made for 3 run, and equal the reference's."""
    tokens = _tokens(JC.get_reduced_config("mamba2_1_3b"), 2, 5)
    steps, tc, jc = _decode_both("mamba2_1_3b", tokens, max_len=3)
    for got, want in steps:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert tc["len"] == int(jc["len"]) == 5
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]), **F32)


# -- the launcher --------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_decodes_and_refuses_offload(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen-tokens", "4"]
    assert launch_serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={JC.get_config(arch).name} batch=2 device=cpu")
    assert launch_serve.main(argv + ["--offload"]) == 2
    family = JC.get_config(arch).family
    assert f"--offload supports dense/vlm families, not {family}" in capsys.readouterr().err


# -- chip_smoke.py's phase 13 --------------------------------------------------
class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_ssm_decode_runs_on_the_cpu(arch, monkeypatch, capsys):
    """Phase 13's ``ssm_decode`` at the reduced widths in bf16 on the CPU,
    the ``torch.cuda`` timing and memory calls faked: the resident decode
    finite, the step's byte bound as counted here, the fp32 checks passed
    (here CPU against CPU, both as far from the fp64 run), forward against
    decode for the scan archs and encdec's forward with its encoder inputs."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_ssm", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = TC.get_reduced_config(arch).with_(dtype="bfloat16")
    monkeypatch.setattr(TC, "get_config", lambda name: cfg)
    monkeypatch.setitem(cs.SSM_PUBLISHED, arch, cs._ssm_published(cfg))
    for name, fake in (("synchronize", lambda: None), ("empty_cache", lambda: None),
                       ("reset_peak_memory_stats", lambda: None),
                       ("max_memory_allocated", lambda: 0), ("Event", _FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, fake)
    cs.ssm_decode(arch, "cpu", batch=4, prompt_len=6, gen_tokens=5, device=CPU)
    recs = {}
    for line in capsys.readouterr().out.splitlines():
        rec = json.loads(line)
        recs[rec["phase"]] = rec
    res, fp32 = recs["ssm_resident"], recs["ssm_fp32"]
    assert res["family"] == cfg.family and len(res["decode_ms_per_token"]) == 5 - 1
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert res["bytes_bound"] == cs.ssm_step_bytes(model, 4)
    es, d = 2, cfg.d_model
    head = cfg.vocab_size * d * es
    if cfg.family == "ssm":
        per_layer = sum(p.numel() * p.element_size() for p in model.blocks[0].parameters())
        assert res["bytes_bound"]["weights"] == (cfg.num_layers * per_layer + d * es
                                                 + head + 4 * d * es)
    assert (res["bytes_bound"]["state"] > 0) == (cfg.family != "encdec")
    assert fp32["within_tolerance"] and fp32["steps"] == cs.FP32_STEPS
    assert fp32["as_accurate_as_cpu"] and fp32["card_vs_fp64"] == fp32["cpu_vs_fp64"]
    if cfg.family == "encdec":
        assert fp32["forward_ok"] and fp32["forward_shape"] == [4, 6, cfg.vocab_size]
        assert "forward_vs_decode_ok" not in fp32
    else:
        assert fp32["forward_vs_decode_ok"] and fp32["forward_vs_decode_steps"] == 6
