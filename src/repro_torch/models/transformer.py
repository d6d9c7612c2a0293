"""Model assembly for the dense and vlm families: init, forward (prefill) and
decode_step (serving).

Ported from ``src/repro/models/transformer.py``, as ``nn.Module``s that keep
the reference's layouts, so that weights carry across without a transpose
(``models/weights.py``): attention projections ``wq/wk/wv`` are
``(d, heads, head_dim)`` and ``wo`` is ``(heads, head_dim, d)``; the MLP's
``w_gate/w_up`` are ``(d, ff)`` and ``w_down`` ``(ff, d)``.  The reference
stacks the layers along a leading axis for ``lax.scan``; here they are a
``ModuleList`` run in a Python loop.

Families:
  dense   — pre-norm GQA + SwiGLU (llama/qwen/granite/tinyllama)
  vlm     — a dense LM whose first ``vision_patches`` positions take patch
            embeddings from the (stubbed) vision frontend

Every other family raises ``NotImplementedError`` naming the ROADMAP item
that ports it.  ``forward``'s ``mesh`` and ``remat`` are left out (sharding
and training are later slices), and so is ``loss_fn``.

Decode differs from the reference in one place on purpose: the KV caches are
written in place at ``cache["len"]``, and a step at ``len >= max_len`` raises
``CacheFullError`` where the reference's ``lax.dynamic_update_slice`` clamps
its start and silently overwrites the last slot (ROADMAP fault C4).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceSpec, resolve_device
from .attention import decode_attention, flash_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, embed_init, rms_norm, swiglu

# The ROADMAP items that port the other families.
_LATER = {"moe": "A14(b)", "ssm": "A14(c)", "hybrid": "A14(c)", "encdec": "A14(c)"}


class CacheFullError(IndexError):
    """A decode step at ``len >= max_len``: the cache has no slot left."""


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of a family this port runs (dense, vlm)."""
    if cfg.family not in ("dense", "vlm"):
        item = _LATER.get(cfg.family, "A14")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP {item}); "
            f"repro_torch.models runs the dense and vlm families")


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


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.w_gate = _weight((d, ff), dtype, device)
        self.w_up = _weight((d, ff), dtype, device)
        self.w_down = _weight((ff, d), dtype, device)


class DenseBlock(nn.Module):
    """ln1, ln2, attn (``wq/wk/wv/wo``, optional ``bq/bk/bv``), mlp."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device)
        self.ln2 = _weight((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


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
        self.blocks = nn.ModuleList(DenseBlock(cfg, dt, dev) for _ in range(cfg.num_layers))


# =============================== init =========================================
@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: DeviceSpec = "cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the reference's initialisers, drawn
    in the reference's order from ``generator`` (on the generator's device,
    then moved).  The values are not the JAX package's: its weights come
    across through ``weights.params_from_numpy``."""
    model = Transformer(cfg, device=device)
    dt = cfg.torch_dtype
    d, Hq, Hkv, Dh, ff = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim, cfg.d_ff
    g = generator
    model.embed.copy_(embed_init(g, (cfg.vocab_size, d), dt))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(g, (d, cfg.vocab_size), dt))
    for blk in model.blocks:
        blk.ln1.fill_(1)
        blk.ln2.fill_(1)
        a, m = blk.attn, blk.mlp
        a.wq.copy_(dense_init(g, (d, Hq, Dh), dt))
        a.wk.copy_(dense_init(g, (d, Hkv, Dh), dt))
        a.wv.copy_(dense_init(g, (d, Hkv, Dh), dt))
        a.wo.copy_(dense_init(g, (Hq, Dh, d), dt, scale=1.0 / np.sqrt(Hq * Dh)))
        if cfg.qkv_bias:
            a.bq.zero_()
            a.bk.zero_()
            a.bv.zero_()
        m.w_gate.copy_(dense_init(g, (d, ff), dt))
        m.w_up.copy_(dense_init(g, (d, ff), dt))
        m.w_down.copy_(dense_init(g, (ff, d), dt, scale=1.0 / np.sqrt(ff)))
    return model


# =============================== forward ======================================
def _attn_sublayer(blk: DenseBlock, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
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


def _mlp_sublayer(blk: DenseBlock, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(h, blk.ln2, cfg.rms_eps)
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
    vlm: ``patches`` (B, n_patch, d) take the first ``n_patch`` positions."""
    cfg = model.cfg
    h = model.embed[tokens]
    if cfg.family == "vlm" and patches is not None:
        npatch = patches.shape[1]
        h = torch.cat([patches.to(h.dtype), h[:, npatch:]], dim=1)
    for blk in model.blocks:
        h = _attn_sublayer(blk, h, cfg)
        h = _mlp_sublayer(blk, h, cfg)
    return _head(model, h)


# =============================== decode =======================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceSpec = "cuda", dtype: Optional[torch.dtype] = None
               ) -> Dict[str, Any]:
    """The serving cache: ``k``/``v`` of (L, batch, max_len, kv_heads,
    head_dim) and ``len``, a host int (the reference's is a device scalar)."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.hdim)
    return {"len": 0, "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def cache_position(cache: Dict[str, Any]) -> int:
    """The slot the next token's K/V go to; raises ``CacheFullError`` when
    there is none (the reference clamps and overwrites the last slot)."""
    cur, max_len = int(cache["len"]), cache["k"].shape[2]
    if cur >= max_len:
        raise CacheFullError(
            f"decode step at len {cur}: the cache holds {max_len} positions")
    return cur


def decode_layer(blk: DenseBlock, h: torch.Tensor, cfg: ModelConfig,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, cur: int) -> torch.Tensor:
    """One layer for one token: attention against the layer's cache (its
    K/V written in place at ``cur``), then the MLP.  h: (B, 1, d)."""
    a = blk.attn
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    posv = torch.full((1,), cur, dtype=torch.int64, device=h.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    k_cache[:, cur] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cur] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, cur + 1)
    h = h + torch.einsum("bshk,hkd->bsd", o, a.wo)
    return _mlp_sublayer(blk, h, cfg)


def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume one token per sequence (``tokens`` (B,)),
    return logits (B, vocab) and ``cache``, updated in place."""
    cfg = model.cfg
    cur = cache_position(cache)
    h = model.embed[tokens][:, None, :]
    for li, blk in enumerate(model.blocks):
        h = decode_layer(blk, h, cfg, cache["k"][li], cache["v"][li], cur)
    logits = _head(model, h)[:, 0, :]
    cache["len"] = cur + 1
    return logits, cache
