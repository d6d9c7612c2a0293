"""The port's moe family (``repro_torch.models.moe``, MLA in
``models/attention.py``, the moe branches of ``models/transformer.py`` and
``models/weights.py``) against the JAX package's ``repro.models``.

The same seeded numpy inputs go through both; the JAX weights come across by
``params_from_numpy``, with the norms' scales perturbed so that the
comparison sees them.  Routing is compared first: the port's ``topk_idx``
and ``tok_idx`` equal the reference's ``lax.top_k`` selections
(``_jax_routing`` below repeats ``src/repro/models/moe.py:56-70`` in JAX,
which does not return them).  Tolerances: fp32 rtol 1e-4 / atol 1e-5; bf16
``moe_ffn`` atol 2e-2 (one bf16 rounding of values near 1).  On the card,
``chip_smoke.py --moe`` runs the same path at the published widths of
Qwen3-MoE 30B-A3B and DeepSeek-V2-Lite.
"""
import functools
import importlib.util
import json
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.offload import StreamedDecoder as JStreamedDecoder  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CacheFullError,
    decode_step,
    forward,
    init_cache,
    init_params,
)
from repro_torch.models.offload import StreamedDecoder  # noqa: E402
from repro_torch.models.transformer import Block, MoE  # noqa: E402
from repro_torch.models.weights import params_from_numpy, params_to_numpy  # noqa: E402

CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0, atol=2e-2)
MOE_ARCHS = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]


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


# -- moe_ffn -------------------------------------------------------------------
def _moe_weights(cfg, seed):
    """The reference's moe tree as numpy fp32 (router, experts, shared)."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    tree = {"router": w(d, E),
            "experts": {"w_gate": w(E, d, f), "w_up": w(E, d, f), "w_down": w(E, f, d)}}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        tree["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    return tree


def _jax_moe(tree, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if path[-1].key == "router" else jdt),
        tree)


def _port_moe(tree, cfg):
    """A port ``MoE`` module holding ``tree`` (router fp32, the rest in the
    config's dtype)."""
    m = MoE(cfg, cfg.torch_dtype, torch.device(CPU))
    for name, p in m.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        p.copy_(torch.from_numpy(leaf))
    return m


def _jax_routing(router, tokens, cfg):
    """``topk_idx`` and ``tok_idx`` as the reference selects them
    (``src/repro/models/moe.py:56-70``): two ``lax.top_k``."""
    T, E, k = tokens.shape[0], cfg.num_experts, cfg.experts_per_token
    probs = JMOE.router_probs(tokens, router)
    topk_p, topk_idx = lax.top_k(probs, k)
    if cfg.norm_topk:
        topk_p = topk_p / jnp.maximum(topk_p.sum(-1, keepdims=True), 1e-9)
    routed = jnp.full((T, E), -1.0, jnp.float32)
    routed = routed.at[jnp.arange(T)[:, None], topk_idx].set(topk_p)
    C = min(max(4, int(cfg.capacity_factor * T * k / E) + 1), T)
    gate_w, tok_idx = lax.top_k(routed.T, C)
    return np.asarray(topk_idx), np.asarray(tok_idx), np.asarray(gate_w > 0)


def _moe_cfg(norm_topk, shared, capacity_factor=1.25, dtype="float32"):
    return TC.get_reduced_config("qwen3_moe_30b_a3b").with_(
        norm_topk=norm_topk, num_shared_experts=shared,
        capacity_factor=capacity_factor, dtype=dtype)


def _moe_input(cfg, B, S, distinct=None, seed=3):
    """(B, S, d); with ``distinct`` only that many different rows, repeated,
    so that the capacity selection meets ties."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rows = rng.standard_normal((distinct, cfg.d_model)).astype(np.float32)
    return rows[np.arange(B * S) % distinct].reshape(B, S, cfg.d_model)


MOE_CASES = {
    # name: (norm_topk, shared experts, capacity factor, B, S, distinct rows)
    "norm_topk": (True, 0, 1.25, 2, 8, None),
    "no_norm_shared": (False, 2, 1.25, 2, 8, None),
    "capacity_drops": (True, 2, 0.5, 4, 16, None),
    "ties_under_capacity": (False, 0, 0.5, 4, 8, 3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_the_reference(case, dtype):
    norm_topk, shared, cf, B, S, distinct = MOE_CASES[case]
    cfg = _moe_cfg(norm_topk, shared, cf, dtype)
    tree = _moe_weights(cfg, seed=len(case))
    x = _moe_input(cfg, B, S, distinct)
    jmoe, tmoe = _jax_moe(tree, dtype), _port_moe(tree, cfg)
    jx = jnp.asarray(x).astype(jmoe["experts"]["w_gate"].dtype)
    tx = torch.from_numpy(x).to(cfg.torch_dtype)

    tokens = tx.reshape(-1, cfg.d_model)
    r = TMOE.route(tmoe.router, tokens, cfg)
    topk_idx, tok_idx, valid = _jax_routing(jmoe["router"], jx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(r.topk_idx.numpy(), topk_idx)
    np.testing.assert_array_equal(r.tok_idx.numpy(), tok_idx)
    np.testing.assert_array_equal(r.valid.numpy(), valid)
    kept = int(valid.sum())
    if case in ("capacity_drops", "ties_under_capacity"):
        assert kept < B * S * cfg.experts_per_token      # capacity drops tokens
    if distinct is not None:
        # a dropped token that is equal to a kept one: the tie order decides
        routed = np.zeros((cfg.num_experts, B * S), bool)
        routed[topk_idx, np.arange(B * S)[:, None]] = True
        dropped = routed.sum(1) > valid.sum(1)
        assert dropped.any()

    got = TMOE.moe_ffn(tmoe, tx, cfg)
    want = JMOE.moe_ffn(jmoe, jx, cfg)
    assert got.dtype == cfg.torch_dtype and got.shape == x.shape
    np.testing.assert_allclose(_np32(got), _np32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_topk_breaks_ties_toward_the_lower_index():
    """``lax.top_k``'s order on the example of ROADMAP A14(b)."""
    x = [1.0, 3.0, 3.0, -1.0, -1.0, 3.0]
    _, idx = TMOE._top(torch.tensor(x), 4)
    assert idx.tolist() == np.asarray(lax.top_k(jnp.asarray(x), 4)[1]).tolist() == [1, 2, 5, 0]


def test_combine_adds_in_the_reference_order():
    """Each token's contributions are added expert ascending, then slot, in
    the updates' dtype: bf16 sums that differ by order come out as the
    reference's left-to-right ones."""
    T, k, d = 3, 3, 4
    cfg = types.SimpleNamespace(experts_per_token=k)
    tok_idx = torch.tensor([[0, 2], [2, 0], [1, 0], [0, 1]])          # (E=4, C=2)
    valid = torch.tensor([[True, True], [True, False], [True, True], [True, False]])
    rng = np.random.default_rng(0)
    upd = torch.from_numpy(rng.standard_normal((4, 2, d)).astype(np.float32) * 100)
    upd = upd.to(torch.bfloat16) * valid[..., None]
    r = types.SimpleNamespace(tok_idx=tok_idx, valid=valid)
    got = TMOE._combine(upd, r, T, cfg.experts_per_token)
    want = torch.zeros((T, d), dtype=torch.bfloat16)
    for e in range(4):
        for c in range(2):
            if valid[e, c]:
                want[tok_idx[e, c]] = want[tok_idx[e, c]] + upd[e, c]
    assert torch.equal(got, want)


def test_router_probs_and_load_balance_loss_match_the_reference():
    cfg = _moe_cfg(True, 0)
    tree = _moe_weights(cfg, seed=7)
    x = _moe_input(cfg, 3, 5)
    got = TMOE.router_probs(torch.from_numpy(x), torch.from_numpy(tree["router"]))
    want = JMOE.router_probs(jnp.asarray(x), jnp.asarray(tree["router"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _, idx = lax.top_k(want, cfg.experts_per_token)
    lb = TMOE.load_balance_loss(got, torch.from_numpy(np.array(idx)).long(),
                                cfg.num_experts)
    jlb = JMOE.load_balance_loss(want, idx, cfg.num_experts)
    np.testing.assert_allclose(float(lb), float(jlb), **F32)


def test_expert_parallelism_names_its_roadmap_item():
    """Expert parallelism is ported (ROADMAP A14(e), held against the JAX
    package on CPU ranks by tests/test_torch_mesh.py): an axis of size 1
    runs the local path, and an axis that names no process group raises."""
    cfg = _moe_cfg(True, 0)
    tmoe = _port_moe(_moe_weights(cfg, seed=1), cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, cfg.d_model))
                         .astype(np.float32))
    assert torch.equal(TMOE.moe_ffn(tmoe, x, cfg, axis="model", axis_size=1),
                       TMOE.moe_ffn(tmoe, x, cfg))
    with pytest.raises(RuntimeError, match="model"):
        TMOE.moe_ffn(tmoe, torch.zeros(1, 4, cfg.d_model), cfg, axis="model", axis_size=2)


# -- MLA -----------------------------------------------------------------------
def _mla_inputs(B, L, seed=11):
    cfg = TC.get_reduced_config("deepseek_v2_lite_16b")
    H, r, dn, dr, dv = (cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_dim,
                        cfg.qk_rope_dim, cfg.v_head_dim)
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    w = {"w_uk": n(r, H, dn) / np.float32(np.sqrt(r)),
         "w_uv": n(r, H, dv) / np.float32(np.sqrt(r))}
    arrays = dict(q_nope=n(B, 1, H, dn), q_rope=n(B, 1, H, dr), ckv=n(B, L, r),
                  kr=n(B, L, dr))
    tw = types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in w.items()})
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    return cfg, arrays, tw, jw


def _mla_decode(arrays, tw, cfg, cur):
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return TA.mla_decode_attention(tw, a["q_nope"], a["q_rope"], a["ckv"], a["kr"], cur, cfg)


def _j_mla_decode(arrays, jw, cfg, cur):
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    return JA.mla_decode_attention(jw, a["q_nope"], a["q_rope"], a["ckv"], a["kr"],
                                   jnp.asarray(cur, jnp.int32), cfg)


def test_mla_expand_matches_the_reference():
    cfg, arrays, tw, jw = _mla_inputs(2, 7)
    got = TA.mla_expand(tw, torch.from_numpy(arrays["ckv"]))
    want = JA.mla_expand(jw, jnp.asarray(arrays["ckv"]), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("cur", [1, 5, 9])
def test_mla_decode_attention_matches_the_reference(cur):
    cfg, arrays, tw, jw = _mla_inputs(3, 9)
    got = _mla_decode(arrays, tw, cfg, cur)
    want = _j_mla_decode(arrays, jw, cfg, cur)
    assert got.shape == (3, 1, cfg.num_heads, cfg.v_head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert torch.equal(_mla_decode(arrays, tw, cfg, torch.tensor(cur)), got)


@pytest.mark.parametrize("B,L", [(3, 3), (2, 5)])
def test_mla_per_row_lengths_mask_each_row(B, L):
    """ROADMAP C5.  Per-row lengths give each row what a scalar call with its
    own length gives.  The reference builds a (1, L) mask from a (B,) length,
    comparing position j with ``cur_len[j]``: at B = L = 3 with lengths
    [1, 2, 3] its row 0 attends to all three positions, and with B != L it
    raises."""
    cfg, arrays, tw, jw = _mla_inputs(B, L)
    lens = np.arange(1, B + 1, dtype=np.int32)
    got = _mla_decode(arrays, tw, cfg, torch.from_numpy(lens).long())
    for b, n in enumerate(lens):
        row = {k: v[b:b + 1] for k, v in arrays.items()}
        np.testing.assert_allclose(got[b:b + 1].numpy(),
                                   _mla_decode(row, tw, cfg, int(n)).numpy(), **F32)
        np.testing.assert_allclose(got[b:b + 1].numpy(),
                                   np.asarray(_j_mla_decode(row, jw, cfg, int(n))), **F32)
    if B == L:
        ref = np.asarray(_j_mla_decode(arrays, jw, cfg, lens))
        assert not np.allclose(ref[0], got[0].numpy(), **F32)
        full = _mla_decode({k: v[:1] for k, v in arrays.items()}, tw, cfg, L)
        np.testing.assert_allclose(ref[0:1], full.numpy(), **F32)   # row 0 saw all L
    else:
        with pytest.raises((ValueError, TypeError)):
            _j_mla_decode(arrays, jw, cfg, lens)


# -- the models ----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0):
    """The JAX config, params and a numpy tree of them, with the norms'
    scales perturbed from their initial ones (the same objects for every
    test that asks: none of them writes to them)."""
    cfg = JC.get_reduced_config(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(np.asarray, params)

    def perturb(path, leaf):
        if getattr(path[-1], "key", "") in ("ln1", "ln2", "final_norm"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(lambda p, t: j_forward(p, cfg, t))


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_the_reference(arch):
    cfg, params, tree = _reference(arch)
    model = params_from_numpy(TC.get_reduced_config(arch), tree, device=CPU)
    tokens = _tokens(cfg, 2, 12)
    want = _jax_forward(cfg)(params, jnp.asarray(tokens))
    got = forward(model, torch.from_numpy(tokens).long())
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_steps_match_the_reference(arch):
    cfg, params, tree = _reference(arch)
    model = params_from_numpy(TC.get_reduced_config(arch), tree, device=CPU)
    B, T, max_len = 2, 6, 8
    tokens = _tokens(cfg, B, T)
    jstep = jax.jit(lambda p, c, t: j_decode_step(p, cfg, c, t))
    jc, tc = j_init_cache(cfg, B, max_len), init_cache(model.cfg, B, max_len, device=CPU)
    keys = ("ckv", "kr") if cfg.mla else ("k", "v")
    assert sorted(tc) == sorted(("len",) + keys)
    for t in range(T):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, t]))
        tl, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert tc["len"] == int(jc["len"]) == T
    for key in keys:
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_incremental_decode_equals_full_forward_without_drops(arch):
    """Only where no token is dropped: a full forward routes all B·S tokens
    jointly with the capacity of B·S, and drops tokens that a decode step
    (C = T = B) keeps.  A capacity factor of E / k makes C = T in both."""
    base = TC.get_reduced_config(arch)
    cfg = base.with_(capacity_factor=base.num_experts / base.experts_per_token)
    model = init_params(cfg, generator=torch.Generator().manual_seed(3), device=CPU)
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, seed=7)).long()
    assert TMOE.capacity(cfg, tokens.numel()) == tokens.numel()
    full = forward(model, tokens)
    cache = init_cache(cfg, 2, 8, device=CPU)
    inc = []
    for t in range(8):
        logits, cache = decode_step(model, cache, tokens[:, t])
        inc.append(logits)
    np.testing.assert_allclose(full.numpy(), torch.stack(inc, 1).numpy(),
                               rtol=2e-2, atol=2e-3)


def test_blocks_hold_only_the_ffn_their_layer_runs():
    cfg = TC.get_reduced_config("deepseek_v2_lite_16b").with_(dtype="bfloat16")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert [hasattr(b, "mlp") for b in model.blocks] == [True, False, False]
    assert [hasattr(b, "moe") for b in model.blocks] == [False, True, True]
    assert all(isinstance(b, Block) for b in model.blocks)
    assert model.blocks[0].mlp.w_gate.shape == (cfg.d_model, cfg.dense_d_ff)
    assert model.blocks[1].moe.shared.w_gate.shape == (cfg.d_model, 2 * cfg.moe_d_ff)
    # the router stays fp32 in a bf16 model, and so does its product
    assert model.blocks[1].moe.router.dtype == torch.float32
    assert model.blocks[1].moe.experts.w_gate.dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(cfg, 2, 4)).long()
    cache = init_cache(cfg, 2, 4, device=CPU)
    logits, _ = decode_step(model, cache, tokens[:, 0])
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    x = torch.randn(2, 3, cfg.d_model, dtype=torch.bfloat16)
    r = TMOE.route(model.blocks[1].moe.router, x.reshape(-1, cfg.d_model), cfg)
    assert r.probs.dtype == torch.float32
    expect = torch.softmax(x.reshape(-1, cfg.d_model).float()
                           @ model.blocks[1].moe.router, dim=-1)
    assert torch.equal(r.probs, expect)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip_with_the_unused_copies(dtype):
    """DeepSeek's tree gives every layer ``moe`` and ``mlp``.  The port loads
    the one a layer runs, and writes the others back as zeros: the tree it
    returns has the reference's structure and the same JAX forward."""
    jcfg, params, tree = _reference("deepseek_v2_lite_16b")
    if dtype == "bfloat16":      # the reference's bf16 tree: the router stays fp32
        tree = jax.tree_util.tree_map_with_path(
            lambda path, a: a if path[-1].key == "router"
            else np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    cfg = TC.get_reduced_config("deepseek_v2_lite_16b").with_(dtype=dtype)
    model = params_from_numpy(cfg, tree, device=CPU)
    assert model.blocks[1].moe.router.dtype == torch.float32
    assert model.blocks[1].moe.experts.w_up.dtype == cfg.torch_dtype
    back = params_to_numpy(model)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat.keys()
    for path, leaf in flat.items():
        names = [getattr(p, "key", None) for p in path]
        got = flat_back[path]
        assert got.shape == leaf.shape
        if "mlp" in names:
            np.testing.assert_array_equal(got[:1], leaf[:1].astype(np.float32))
            assert not got[1:].any()
        elif "moe" in names:
            np.testing.assert_array_equal(got[1:], leaf[1:].astype(np.float32))
            assert not got[:1].any()
        else:
            np.testing.assert_array_equal(got, leaf.astype(np.float32))
    if dtype == "float32":
        tokens = jnp.asarray(_tokens(jcfg, 2, 12))
        np.testing.assert_array_equal(
            np.asarray(_jax_forward(jcfg)(jax.tree.map(jnp.asarray, back), tokens)),
            np.asarray(_jax_forward(jcfg)(params, tokens)))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(cfg, bad, device=CPU)
    blocks = dict(tree["blocks"], moe={k: v for k, v in tree["blocks"]["moe"].items()
                                       if k != "router"})
    with pytest.raises(ValueError, match="router"):
        params_from_numpy(cfg, dict(tree, blocks=blocks), device=CPU)
    attn = dict(tree["blocks"]["attn"], w_dkv=tree["blocks"]["attn"]["w_dkv"][:, :, :-1])
    with pytest.raises(ValueError, match="w_dkv"):
        params_from_numpy(cfg, dict(tree, blocks=dict(tree["blocks"], attn=attn)), device=CPU)


def test_mla_decode_past_the_cache_raises_where_the_reference_clamps():
    """ROADMAP C4 on the MLA caches.  The reference writes ``ckv``/``kr``
    with the same clamping ``lax.dynamic_update_slice``
    (``src/repro/models/transformer.py:579-582``): with 3 slots, steps 4 and
    5 overwrite the last slot.  The port raises ``CacheFullError`` at step 4."""
    cfg, params, tree = _reference("deepseek_v2_lite_16b")
    tokens = _tokens(cfg, 2, 5)
    jc = j_init_cache(cfg, 2, 3)
    jstep = jax.jit(lambda p, c, t: j_decode_step(p, cfg, c, t))
    ckv = []
    for t in range(5):
        jl, jc = jstep(params, jc, jnp.asarray(tokens[:, t]))
        ckv.append(np.asarray(jc["ckv"])[:, :, 2].copy())
    assert int(jc["len"]) == 5 and np.isfinite(np.asarray(jl)).all()
    assert not np.array_equal(ckv[2], ckv[4])        # slot 2 was overwritten

    model = params_from_numpy(TC.get_reduced_config("deepseek_v2_lite_16b"), tree,
                              device=CPU)
    tc = init_cache(model.cfg, 2, 3, device=CPU)
    for t in range(3):
        _, tc = decode_step(model, tc, torch.from_numpy(tokens[:, t]).long())
    kept = tc["ckv"].clone()
    with pytest.raises(CacheFullError, match="len 3: the cache holds 3"):
        decode_step(model, tc, torch.from_numpy(tokens[:, 3]).long())
    assert tc["len"] == 3 and torch.equal(tc["ckv"], kept)


# -- streaming and the launcher ------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_streamed_decoder_rejects_moe(arch):
    cfg = TC.get_reduced_config(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="dense and vlm families, not moe"):
        StreamedDecoder(model)
    # the reference's streamer refuses it too, at its first step
    jcfg, params, _ = _reference(arch)
    jsd = JStreamedDecoder(params, jcfg)
    with pytest.raises(AssertionError, match="dense families"):
        jsd.decode(j_init_cache(jcfg, 1, 2), jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_decodes_moe_and_refuses_offload(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen-tokens", "4"]
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={JC.get_config(arch).name}" in out and "tok/s" in out
    assert launch_serve.main(argv + ["--offload"]) == 2
    assert "--offload supports dense/vlm families, not moe" in capsys.readouterr().err


# -- chip_smoke.py's phase 12 --------------------------------------------------
class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_chip_smoke_moe_decode_runs_on_the_cpu(arch, monkeypatch, capsys):
    """Phase 12's ``moe_decode`` at the reduced widths in bf16 on the CPU,
    the ``torch.cuda`` timing and memory calls faked: both decode runs equal
    step for step, the weight bytes as counted, the fp32 check's routing
    equal and its logits within tolerance (here CPU against CPU)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_moe", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = TC.get_reduced_config(arch).with_(dtype="bfloat16")
    monkeypatch.setattr(TC, "get_config", lambda name: cfg)
    monkeypatch.setitem(cs.MOE_PUBLISHED, arch, cs._published(cfg))
    for name, fake in (("synchronize", lambda: None), ("empty_cache", lambda: None),
                       ("reset_peak_memory_stats", lambda: None),
                       ("max_memory_allocated", lambda: 0),
                       ("mem_get_info", lambda: (1 << 40, 1 << 40)),
                       ("Event", _FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, fake)
    cs.moe_decode(arch, "cpu", batch=4, prompt_len=6, gen_tokens=5, device=CPU)
    recs = {}
    for line in capsys.readouterr().out.splitlines():
        rec = json.loads(line)
        recs[rec["phase"]] = rec
    res, fp32 = recs["moe_resident"], recs["moe_fp32"]
    assert res["steps_equal"] == 6 + 5 - 1
    assert res["weight_bytes"] == cs.moe_weight_bytes(cfg)
    assert res["capacity"] == 4
    assert fp32["routing_equal"] and fp32["within_tolerance"]
    assert fp32["routing_calls"] == cs.FP32_STEPS * (cs.MOE_FP32_LAYERS
                                                    - cfg.first_dense_layers)
