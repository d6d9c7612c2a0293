"""Model assembly for the dense, vlm and moe families: init, forward
(prefill) and decode_step (serving).

Ported from ``src/repro/models/transformer.py``, as ``nn.Module``s that keep
the reference's layouts, so that weights carry across without a transpose
(``models/weights.py``): attention projections ``wq/wk/wv`` are
``(d, heads, head_dim)`` and ``wo`` is ``(heads, head_dim, d)``; MLA's
``w_q`` is ``(d, H, dn + dr)``, ``w_dkv`` ``(d, r + dr)``, ``w_uk``/``w_uv``
``(r, H, dn/dv)``; the MLP's ``w_gate/w_up`` are ``(d, ff)`` and ``w_down``
``(ff, d)``; a MoE layer's experts stack them along a leading expert axis,
and its router is ``(d, E)`` in fp32 whatever the model's dtype.  The
reference stacks the layers along a leading axis for ``lax.scan``; here they
are a ``ModuleList`` run in a Python loop.

Families:
  dense   — pre-norm GQA + SwiGLU (llama/qwen/granite/tinyllama)
  vlm     — a dense LM whose first ``vision_patches`` positions take patch
            embeddings from the (stubbed) vision frontend
  moe     — GQA or MLA attention + routed experts (qwen3-moe, deepseek-v2);
            the first ``first_dense_layers`` layers run a dense MLP

A moe block holds only what its layer runs: ``mlp`` in the first
``first_dense_layers`` layers and ``moe`` in the others.  The reference gives
every layer both (one ``lax.scan`` covers the stack and ``lax.cond`` picks
one), which at DeepSeek-V2-Lite's widths is 2.3 B parameters never read.

Every other family raises ``NotImplementedError`` naming the ROADMAP item
that ports it.  ``forward``'s ``mesh`` and ``remat`` are left out (sharding
and training are later slices), and so is ``loss_fn``.

Decode differs from the reference in one place on purpose: the caches (K/V,
or MLA's ``ckv``/``kr``) are written in place at ``cache["len"]``, and a step
at ``len >= max_len`` raises ``CacheFullError`` where the reference's
``lax.dynamic_update_slice`` clamps its start and silently overwrites the
last slot (ROADMAP fault C4).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceSpec, resolve_device
from .attention import decode_attention, flash_attention, mla_decode_attention, mla_expand
from .config import ModelConfig
from .layers import apply_rope, dense_init, embed_init, rms_norm, swiglu
from .moe import moe_ffn

# The families this port runs, and the ROADMAP item that ports each other one.
FAMILIES = ("dense", "vlm", "moe")
_LATER = {"ssm": "A14(c)", "hybrid": "A14(c)", "encdec": "A14(c)"}


class CacheFullError(IndexError):
    """A decode step at ``len >= max_len``: the cache has no slot left."""


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of a family this port runs (dense, vlm, moe)."""
    if cfg.family not in FAMILIES:
        item = _LATER.get(cfg.family, "A14")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP {item}); "
            f"repro_torch.models runs the dense, vlm and moe families")


def _weight(shape, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# =============================== modules ======================================
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim
        self.wq = _weight((d, Hq, Dh), dtype, device)
        self.wk = _weight((d, Hkv, Dh), dtype, device)
        self.wv = _weight((d, Hkv, Dh), dtype, device)
        self.wo = _weight((Hq, Dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _weight((Hq, Dh), dtype, device)
            self.bk = _weight((Hkv, Dh), dtype, device)
            self.bv = _weight((Hkv, Dh), dtype, device)


class MLAAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention: ``w_q``, ``w_dkv`` (down to
    the rank-r latent and the shared rope key), ``w_uk``, ``w_uv``, ``wo``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.w_q = _weight((d, H, dn + dr), dtype, device)
        self.w_dkv = _weight((d, r + dr), dtype, device)
        self.w_uk = _weight((r, H, dn), dtype, device)
        self.w_uv = _weight((r, H, dv), dtype, device)
        self.wo = _weight((H, dv, d), dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
                 ff: Optional[int] = None, experts: Optional[int] = None):
        super().__init__()
        d, ff = cfg.d_model, ff or cfg.d_ff
        lead = (experts,) if experts else ()
        self.w_gate = _weight(lead + (d, ff), dtype, device)
        self.w_up = _weight(lead + (d, ff), dtype, device)
        self.w_down = _weight(lead + (ff, d), dtype, device)


class MoE(nn.Module):
    """``router`` (d, E), always fp32; ``experts``, an MLP stacked over the E
    experts; ``shared``, one MLP of ``num_shared_experts`` times the expert
    width, when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.router = _weight((cfg.d_model, cfg.num_experts), torch.float32, device)
        self.experts = MLP(cfg, dtype, device, ff=cfg.moe_d_ff, experts=cfg.num_experts)
        if cfg.num_shared_experts:
            self.shared = MLP(cfg, dtype, device,
                              ff=cfg.moe_d_ff * cfg.num_shared_experts)


class Block(nn.Module):
    """ln1, ln2, attn (``MLAAttention`` when the config has MLA, else GQA
    ``Attention`` with ``wq/wk/wv/wo`` and optional ``bq/bk/bv``), and the
    FFN its layer runs: ``mlp`` of width ``dense_d_ff or d_ff`` when
    ``dense``, else ``moe``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
                 dense: bool = True):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device)
        self.ln2 = _weight((cfg.d_model,), dtype, device)
        self.attn = (MLAAttention if cfg.mla else Attention)(cfg, dtype, device)
        if dense:
            self.mlp = MLP(cfg, dtype, device, ff=cfg.dense_d_ff or cfg.d_ff)
        else:
            self.moe = MoE(cfg, dtype, device)


class Transformer(nn.Module):
    """embed, final_norm, ``blocks``, and ``lm_head`` unless the config ties
    its embeddings (the head is then ``embed.T``).  Parameters are allocated
    uninitialised on ``device``; ``init_params`` or
    ``weights.params_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceSpec = "cuda"):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.d_model), dt, dev)
        self.final_norm = _weight((cfg.d_model,), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab_size), dt, dev)
        # Every layer is dense but a moe model's after its first_dense_layers.
        self.blocks = nn.ModuleList(
            Block(cfg, dt, dev, dense=cfg.family != "moe" or li < cfg.first_dense_layers)
            for li in range(cfg.num_layers))


# =============================== init =========================================
def _init_attn(a: Attention, cfg: ModelConfig, g: torch.Generator) -> None:
    dt = a.wq.dtype
    d, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim
    a.wq.copy_(dense_init(g, (d, Hq, Dh), dt))
    a.wk.copy_(dense_init(g, (d, Hkv, Dh), dt))
    a.wv.copy_(dense_init(g, (d, Hkv, Dh), dt))
    a.wo.copy_(dense_init(g, (Hq, Dh, d), dt, scale=1.0 / np.sqrt(Hq * Dh)))
    if cfg.qkv_bias:
        a.bq.zero_()
        a.bk.zero_()
        a.bv.zero_()


def _init_mla(a: MLAAttention, cfg: ModelConfig, g: torch.Generator) -> None:
    dt = a.w_q.dtype
    H, dv = cfg.num_heads, cfg.v_head_dim
    for w in (a.w_q, a.w_dkv, a.w_uk, a.w_uv):
        w.copy_(dense_init(g, w.shape, dt))
    a.wo.copy_(dense_init(g, a.wo.shape, dt, scale=1.0 / np.sqrt(H * dv)))


def _init_mlp(m: MLP, g: torch.Generator) -> None:
    """The reference's ``_init_mlp`` (or, stacked, its experts)."""
    dt, ff = m.w_gate.dtype, m.w_down.shape[-2]
    m.w_gate.copy_(dense_init(g, m.w_gate.shape, dt))
    m.w_up.copy_(dense_init(g, m.w_up.shape, dt))
    m.w_down.copy_(dense_init(g, m.w_down.shape, dt, scale=1.0 / np.sqrt(ff)))


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: DeviceSpec = "cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the reference's initialisers, drawn
    in the reference's order from ``generator`` (on the generator's device,
    then moved).  The values are not the JAX package's: its weights come
    across through ``weights.params_from_numpy``.  A moe layer draws only the
    FFN it holds, not the reference's unused copy."""
    model = Transformer(cfg, device=device)
    dt = cfg.torch_dtype
    d = cfg.d_model
    g = generator
    model.embed.copy_(embed_init(g, (cfg.vocab_size, d), dt))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(g, (d, cfg.vocab_size), dt))
    for blk in model.blocks:
        blk.ln1.fill_(1)
        blk.ln2.fill_(1)
        if isinstance(blk.attn, MLAAttention):
            _init_mla(blk.attn, cfg, g)
        else:
            _init_attn(blk.attn, cfg, g)
        if hasattr(blk, "moe"):
            blk.moe.router.copy_(dense_init(g, blk.moe.router.shape, torch.float32))
            # dense_init takes the fan-in from the first axis: for the
            # stacked experts that is E, as in the reference.
            _init_mlp(blk.moe.experts, g)
            if cfg.num_shared_experts:
                _init_mlp(blk.moe.shared, g)
        else:
            _init_mlp(blk.mlp, g)
    return model



# =============================== forward ======================================
def _attn_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal GQA attention over a full sequence."""
    S = h.shape[1]
    a = blk.attn
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    pos = torch.arange(S, device=h.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True)
    return h + torch.einsum("bshk,hkd->bsd", o, a.wo)


def _mla_project(a: MLAAttention, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor):
    """q_nope, q_rope, c_kv and k_rope of normed ``x`` (B, S, d) at ``pos``,
    rope applied; k_rope is (B, S, dr), shared by every head."""
    dn, r = cfg.qk_nope_dim, cfg.kv_lora_rank
    q = torch.einsum("bsd,dhk->bshk", x, a.w_q)                 # (B,S,H,dn+dr)
    ckv_kr = x @ a.w_dkv                                        # (B,S,r+dr)
    q_rope = apply_rope(q[..., dn:], pos, cfg.rope_theta)
    k_rope = apply_rope(ckv_kr[:, :, None, r:], pos, cfg.rope_theta)[:, :, 0, :]
    return q[..., :dn], q_rope, ckv_kr[..., :r], k_rope


def _mla_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal MLA over a full sequence, through the expanded K/V (the
    reference also returns the latent cache, which its forward drops)."""
    B, S, _ = h.shape
    a = blk.attn
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    pos = torch.arange(S, device=h.device)
    q_nope, q_rope, c_kv, k_rope = _mla_project(a, x, cfg, pos)
    k_nope, v = mla_expand(a, c_kv)                             # (B,S,H,dn),(B,S,H,dv)
    H, dr = cfg.num_heads, cfg.qk_rope_dim
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, v, causal=True,
                        scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    return h + torch.einsum("bshk,hkd->bsd", o, a.wo)


def _ffn_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's MLP, or its routed experts: the reference's ``lax.cond``."""
    x = rms_norm(h, blk.ln2, cfg.rms_eps)
    if hasattr(blk, "moe"):
        return h + moe_ffn(blk.moe, x, cfg)
    m = blk.mlp
    return h + swiglu(x, m.w_gate, m.w_up, m.w_down)


def lm_logits(h: torch.Tensor, cfg: ModelConfig, embed: torch.Tensor,
              final_norm: torch.Tensor, lm_head: Optional[torch.Tensor]) -> torch.Tensor:
    """Final norm and head: (B, S, d) -> (B, S, vocab), in the weights' dtype."""
    h = rms_norm(h, final_norm, cfg.rms_eps)
    head = embed.T if cfg.tie_embeddings else lm_head
    return torch.einsum("bsd,dv->bsv", h, head)


def _head(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    return lm_logits(h, model.cfg, model.embed, model.final_norm,
                     getattr(model, "lm_head", None))


def forward(model: Transformer, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward of ``tokens`` (B, S); returns logits (B, S, vocab).
    vlm: ``patches`` (B, n_patch, d) take the first ``n_patch`` positions.
    moe: each layer routes all B·S tokens jointly, with the capacity of B·S
    tokens, so a token dropped here may be kept by a decode step."""
    cfg = model.cfg
    h = model.embed[tokens]
    if cfg.family == "vlm" and patches is not None:
        npatch = patches.shape[1]
        h = torch.cat([patches.to(h.dtype), h[:, npatch:]], dim=1)
    for blk in model.blocks:
        if cfg.mla:
            h = _mla_sublayer(blk, h, cfg)
        else:
            h = _attn_sublayer(blk, h, cfg)
        h = _ffn_sublayer(blk, h, cfg)
    return _head(model, h)


# =============================== decode =======================================
def _cache_keys(cfg: ModelConfig) -> Tuple[str, str]:
    return ("ckv", "kr") if cfg.mla else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceSpec = "cuda", dtype: Optional[torch.dtype] = None
               ) -> Dict[str, Any]:
    """The serving cache and ``len``, a host int (the reference's is a device
    scalar): ``k``/``v`` of (L, batch, max_len, kv_heads, head_dim), or for
    MLA the latent ``ckv`` (L, batch, max_len, r) and the rope key ``kr``
    (L, batch, max_len, dr)."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    L = cfg.num_layers
    if cfg.mla:
        shapes = ((L, batch, max_len, cfg.kv_lora_rank), (L, batch, max_len, cfg.qk_rope_dim))
    else:
        shapes = ((L, batch, max_len, cfg.kv_heads, cfg.hdim),) * 2
    cache: Dict[str, Any] = {"len": 0}
    for key, shape in zip(_cache_keys(cfg), shapes):
        cache[key] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def layer_caches(cfg: ModelConfig, cache: Dict[str, Any], li: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``li``'s two cache tensors: K and V, or MLA's ``ckv`` and ``kr``."""
    return tuple(cache[key][li] for key in _cache_keys(cfg))


def cache_position(cfg: ModelConfig, cache: Dict[str, Any]) -> int:
    """The slot the next token's cache entries go to; raises
    ``CacheFullError`` when there is none (the reference clamps and
    overwrites the last slot)."""
    cur, max_len = int(cache["len"]), cache[_cache_keys(cfg)[0]].shape[2]
    if cur >= max_len:
        raise CacheFullError(
            f"decode step at len {cur}: the cache holds {max_len} positions")
    return cur


def _decode_attn(a: Attention, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur: int, posv: torch.Tensor) -> torch.Tensor:
    """GQA for one token of normed ``x``: its K/V written in place at ``cur``."""
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    k_cache[:, cur] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cur] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, cur + 1)
    return torch.einsum("bshk,hkd->bsd", o, a.wo)


def _decode_mla(a: MLAAttention, x: torch.Tensor, cfg: ModelConfig, ckv_cache: torch.Tensor,
                kr_cache: torch.Tensor, cur: int, posv: torch.Tensor) -> torch.Tensor:
    """MLA for one token of normed ``x``: its latent and rope key written in
    place at ``cur``, attention in the latent space."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(a, x, cfg, posv)
    ckv_cache[:, cur] = c_kv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, cur] = k_rope[:, 0].to(kr_cache.dtype)
    ctx = mla_decode_attention(a, q_nope, q_rope, ckv_cache, kr_cache, cur + 1, cfg)
    return torch.einsum("bshk,hkd->bsd", ctx, a.wo)


def decode_layer(blk: Block, h: torch.Tensor, cfg: ModelConfig,
                 caches: Tuple[torch.Tensor, torch.Tensor], cur: int) -> torch.Tensor:
    """One layer for one token: attention against the layer's ``caches``
    (``layer_caches``; written in place at ``cur``), then the MLP or the
    routed experts.  h: (B, 1, d)."""
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    posv = torch.full((1,), cur, dtype=torch.int64, device=h.device)
    attend = _decode_mla if cfg.mla else _decode_attn
    h = h + attend(blk.attn, x, cfg, *caches, cur, posv)
    return _ffn_sublayer(blk, h, cfg)


def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume one token per sequence (``tokens`` (B,)),
    return logits (B, vocab) and ``cache``, updated in place."""
    cfg = model.cfg
    cur = cache_position(cfg, cache)
    h = model.embed[tokens][:, None, :]
    for li, blk in enumerate(model.blocks):
        h = decode_layer(blk, h, cfg, layer_caches(cfg, cache, li), cur)
    logits = _head(model, h)[:, 0, :]
    cache["len"] = cur + 1
    return logits, cache
