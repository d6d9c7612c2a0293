"""Model assembly for every family: init, forward (training and prefill),
loss_fn and decode_step (serving).

Ported from ``src/repro/models/transformer.py``, as ``nn.Module``s that keep
the reference's layouts, so that weights carry across without a transpose
(``models/weights.py``): attention projections ``wq/wk/wv`` are
``(d, heads, head_dim)`` and ``wo`` is ``(heads, head_dim, d)``; MLA's
``w_q`` is ``(d, H, dn + dr)``, ``w_dkv`` ``(d, r + dr)``, ``w_uk``/``w_uv``
``(r, H, dn/dv)``; the MLP's ``w_gate/w_up`` are ``(d, ff)`` and ``w_down``
``(ff, d)``; a MoE layer's experts stack them along a leading expert axis,
and its router is ``(d, E)`` in fp32 whatever the model's dtype; a Mamba-2
mixer's ``in_proj`` is ``(d, 2di + 2N + H)``, ``conv_w`` ``(K, di + 2N)``,
``out_proj`` ``(di, d)``, and its ``dt_bias``, ``a_log`` and ``d_skip``
``(H,)`` are fp32 whatever the model's dtype.  The reference stacks the
layers along a leading axis for ``lax.scan``; here they are a
``ModuleList`` run in a Python loop.

Families:
  dense   — pre-norm GQA + SwiGLU (llama/qwen/granite/tinyllama)
  vlm     — a dense LM whose first ``vision_patches`` positions take patch
            embeddings from the (stubbed) vision frontend
  moe     — GQA or MLA attention + routed experts (qwen3-moe, deepseek-v2);
            the first ``first_dense_layers`` layers run a dense MLP
  ssm     — a Mamba-2 stack (mamba2-1.3b), ``models/ssm.py``
  hybrid  — Mamba-2 layers + one shared attention+MLP block applied after
            every ``shared_attn_every``-th layer (zamba2)
  encdec  — whisper: a bidirectional encoder without rope and a causal
            decoder with cross-attention, sinusoidal positions on both

A moe block holds only what its layer runs: ``mlp`` in the first
``first_dense_layers`` layers and ``moe`` in the others.  The reference gives
every layer both (one ``lax.scan`` covers the stack and ``lax.cond`` picks
one), which at DeepSeek-V2-Lite's widths is 2.3 B parameters never read.

Training: ``forward(remat=True)`` runs each layer body through
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps each
``lax.scan`` body in ``jax.checkpoint``: the hybrid's checkpointed body
holds its shared block at the sites, and encdec checkpoints its encoder and
decoder bodies separately.  ``loss_fn`` is the reference's NLL plus a 1e-4
z-loss.  Parameters are made with ``requires_grad=False`` (serving runs
under ``torch.inference_mode``); the trainer turns gradients on
(``train/step.py``).  Encdec decode reads ``enc_k``/``enc_v`` as
already-projected K/V that the caller fills, as in the reference, whose
launcher stubs them; neither package computes them from an encoder pass.

Decode differs from the reference in one place on purpose: the caches (K/V,
MLA's ``ckv``/``kr``, the hybrid's shared ``sk``/``sv``, the ssm and conv
states) are written in place, and a step at ``len >= max_len`` raises
``CacheFullError`` before any of them is written, where the reference's
``lax.dynamic_update_slice`` (and encdec's position slice) clamps its start
and silently overwrites the last slot (ROADMAP fault C4).  A pure ssm cache
has no length, in either package: it decodes past ``max_len``.  The host
``len`` is the cache's truth; the single-device step's device work
(``decode_tokens``) reads it as a 0-d int64 tensor, as the reference reads
its device scalar, so one CUDA graph serves every position
(``models/graph.py``).

Meshes (``mesh=`` of ``forward``, ``loss_fn`` and ``decode_step``): the
parameters are DTensors on a ``DeviceMesh`` with named dims
(``distributed.sharding.shard_params``) and the inputs DTensors in the
reference's batch and cache layouts.  Between sublayers the activations
carry the reference's constraints (``_constrain``: the batch over the batch
axes, the logits' vocabulary over ``model``); each sublayer runs the
single-device code above on local shards under ``local_map``
(``distributed/spmd.py``): attention tensor parallel over its heads (K/V
heads sliced from replicated ones where they do not divide), or sequence
parallel where the heads do not divide ``model`` and the sequence does;
the MLP over its hidden width; the routed experts expert parallel over
``model``; the embedding and the head over the vocabulary.  Mamba-2, MLA
and cross-attention have no tensor-parallel path: they run on the batch
shard with their weights gathered whole.  Decode keeps the caches sharded
as ``cache_specs`` lays them out, heads over ``model`` or the sequence
split with the softmax combined across the ranks.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceSpec, resolve_device
from ..distributed import spmd
from .attention import (NEG_INF, decode_attention, flash_attention, mla_decode_attention,
                        mla_expand, repeat_kv)
from .config import ModelConfig
from .layers import apply_rope, dense_init, embed_init, rms_norm, sinusoidal_positions, swiglu
from .moe import moe_ffn
from .ssm import mamba2_decode, mamba2_forward

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


class CacheFullError(IndexError):
    """A decode step at ``len >= max_len``: the cache has no slot left."""


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
    ``dense``, else ``moe``.  An encdec decoder block (``cross``) also holds
    ``ln_x`` and ``xattn``, the cross-attention over the encoder."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device,
                 dense: bool = True, cross: bool = False):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device)
        self.ln2 = _weight((cfg.d_model,), dtype, device)
        self.attn = (MLAAttention if cfg.mla else Attention)(cfg, dtype, device)
        if dense:
            self.mlp = MLP(cfg, dtype, device, ff=cfg.dense_d_ff or cfg.d_ff)
        else:
            self.moe = MoE(cfg, dtype, device)
        if cross:
            self.ln_x = _weight((cfg.d_model,), dtype, device)
            self.xattn = Attention(cfg, dtype, device)


class Mamba(nn.Module):
    """The Mamba-2 mixer: ``in_proj``, ``conv_w``, ``conv_b``, ``norm``,
    ``out_proj`` in the model's dtype; ``dt_bias``, ``a_log`` and ``d_skip``
    in fp32."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * N
        self.in_proj = _weight((d, 2 * di + 2 * N + H), dtype, device)
        self.conv_w = _weight((cfg.ssm_conv, conv_ch), dtype, device)
        self.conv_b = _weight((conv_ch,), dtype, device)
        self.dt_bias = _weight((H,), torch.float32, device)
        self.a_log = _weight((H,), torch.float32, device)
        self.d_skip = _weight((H,), torch.float32, device)
        self.norm = _weight((di,), dtype, device)
        self.out_proj = _weight((di, d), dtype, device)


class MambaBlock(nn.Module):
    """``ln`` and ``mamba``: one layer of the ssm and hybrid families."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.ln = _weight((cfg.d_model,), dtype, device)
        self.mamba = Mamba(cfg, dtype, device)


class Transformer(nn.Module):
    """embed, final_norm, ``blocks``, and ``lm_head`` unless the config ties
    its embeddings (the head is then ``embed.T``).  ``blocks`` are
    ``MambaBlock``s in the ssm and hybrid families, and the hybrid adds
    ``shared_block``, one dense ``Block``; encdec adds ``enc_blocks`` (dense
    ``Block``s) and ``enc_norm``, and its decoder ``blocks`` hold
    cross-attention.  Parameters are allocated uninitialised on ``device``;
    ``init_params`` or ``weights.params_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceSpec = "cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        dev = resolve_device(device)
        dt = cfg.torch_dtype
        L = cfg.num_layers
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.d_model), dt, dev)
        self.final_norm = _weight((cfg.d_model,), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab_size), dt, dev)
        if cfg.family in ("ssm", "hybrid"):
            self.blocks = nn.ModuleList(MambaBlock(cfg, dt, dev) for _ in range(L))
            if cfg.family == "hybrid":
                self.shared_block = Block(cfg, dt, dev)
        elif cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(Block(cfg, dt, dev)
                                            for _ in range(cfg.enc_layers))
            self.enc_norm = _weight((cfg.d_model,), dt, dev)
            self.blocks = nn.ModuleList(Block(cfg, dt, dev, cross=True) for _ in range(L))
        else:
            # Every layer is dense but a moe model's after its first_dense_layers.
            self.blocks = nn.ModuleList(
                Block(cfg, dt, dev, dense=cfg.family != "moe" or li < cfg.first_dense_layers)
                for li in range(L))


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


def _init_block(blk: Block, cfg: ModelConfig, g: torch.Generator) -> None:
    """The reference's dense block (or moe layer): norms, attention, FFN."""
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


def _init_mamba(m: Mamba, cfg: ModelConfig, g: torch.Generator) -> None:
    """The reference's ``_init_mamba``: ``in_proj``, ``conv_w`` (scale 0.5)
    and ``out_proj`` drawn in that order; ``a_log = log(linspace(1, 16, H))``."""
    dt = m.in_proj.dtype
    m.in_proj.copy_(dense_init(g, m.in_proj.shape, dt))
    m.conv_w.copy_(dense_init(g, m.conv_w.shape, dt, scale=0.5))
    m.conv_b.zero_()
    m.dt_bias.zero_()
    m.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads, dtype=torch.float32)))
    m.d_skip.fill_(1)
    m.norm.fill_(1)
    m.out_proj.copy_(dense_init(g, m.out_proj.shape, dt))


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: DeviceSpec = "cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the reference's initialisers, drawn
    in the reference's order from ``generator`` (on the generator's device,
    then moved): the hybrid's blocks, then its shared block; encdec's encoder
    blocks, then each decoder block's dense part followed by its ``xattn``.
    The values are not the JAX package's: its weights come across through
    ``weights.params_from_numpy``.  A moe layer draws only the FFN it holds,
    not the reference's unused copy."""
    model = Transformer(cfg, device=device)
    dt = cfg.torch_dtype
    d = cfg.d_model
    g = generator
    model.embed.copy_(embed_init(g, (cfg.vocab_size, d), dt))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(g, (d, cfg.vocab_size), dt))
    if cfg.family in ("ssm", "hybrid"):
        for blk in model.blocks:
            blk.ln.fill_(1)
            _init_mamba(blk.mamba, cfg, g)
        if cfg.family == "hybrid":
            _init_block(model.shared_block, cfg, g)
    elif cfg.family == "encdec":
        for blk in model.enc_blocks:
            _init_block(blk, cfg, g)
        for blk in model.blocks:
            _init_block(blk, cfg, g)
            blk.ln_x.fill_(1)
            _init_attn(blk.xattn, cfg, g)
        model.enc_norm.fill_(1)
    else:
        for blk in model.blocks:
            _init_block(blk, cfg, g)
    return model


# =============================== forward ======================================
def _qkv(a, x: torch.Tensor, cfg: ModelConfig, use_rope: bool, q_pos0: int = 0,
         kv_pos0: int = 0):
    """q, k and v of normed ``x`` (B, S, d), biased, rope at positions
    ``q_pos0 + arange(S)`` (q) and ``kv_pos0 + arange(S)`` (k)."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    if use_rope:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos + q_pos0 if q_pos0 else pos, cfg.rope_theta)
        k = apply_rope(k, pos + kv_pos0 if kv_pos0 else pos, cfg.rope_theta)
    return q, k, v


def _attn_out(a, x: torch.Tensor, cfg: ModelConfig, *, causal: bool, use_rope: bool,
              kv_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention branch of normed ``x``: GQA over the full sequence and
    the output projection.  ``kv_idx``: the K/V head each of ``a.wq``'s
    heads reads (a rank's share of the heads against replicated K/V)."""
    q, k, v = _qkv(a, x, cfg, use_rope)
    if kv_idx is not None:
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    o = flash_attention(q, k, v, causal=causal)
    return torch.einsum("bshk,hkd->bsd", o, a.wo)


def _attn_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool = True, use_rope: bool = True, mesh=None) -> torch.Tensor:
    """GQA self-attention over a full sequence; with a mesh, tensor
    parallel over its heads, or sequence parallel where the head count
    does not divide ``model`` (``_attn_mesh``)."""
    if mesh is not None:
        return h + _attn_mesh(blk, h, cfg, causal=causal, use_rope=use_rope, mesh=mesh)
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    return h + _attn_out(blk.attn, x, cfg, causal=causal, use_rope=use_rope)


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


def _ffn_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """The block's MLP, or its routed experts: the reference's ``lax.cond``.
    With a mesh: the MLP tensor parallel over its hidden width, the experts
    expert parallel over ``model`` (``_ffn_mesh``)."""
    if mesh is not None:
        return h + _ffn_mesh(blk, h, cfg, mesh)
    x = rms_norm(h, blk.ln2, cfg.rms_eps)
    if hasattr(blk, "moe"):
        return h + moe_ffn(blk.moe, x, cfg)
    m = blk.mlp
    return h + swiglu(x, m.w_gate, m.w_up, m.w_down)


def _shared_attn_block(shared: Block, h: torch.Tensor, cfg: ModelConfig,
                       mesh=None) -> torch.Tensor:
    """The hybrid's shared block: causal attention with rope, then its MLP
    (without the sequence-parallel branch, as in the reference)."""
    if mesh is not None:
        h = h + _attn_mesh(shared, h, cfg, causal=True, use_rope=True, mesh=mesh,
                           seq_par_ok=False)
        return _ffn_sublayer(shared, h, cfg, mesh)
    return _ffn_sublayer(shared, _attn_sublayer(shared, h, cfg), cfg)


def _cross_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig,
                    enc: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from ``h``, K/V projected from the encoder
    output ``enc`` (B, S_enc, d) through ``xattn.wk``/``wv``; no rope, no
    bias, no mask."""
    a = blk.xattn
    x = rms_norm(h, blk.ln_x, cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", enc, a.wk)
    v = torch.einsum("bsd,dhk->bshk", enc, a.wv)
    o = flash_attention(q, k, v, causal=False)
    return h + torch.einsum("bshk,hkd->bsd", o, a.wo)


def _positions(length: int, cfg: ModelConfig, like: torch.Tensor) -> torch.Tensor:
    """encdec's sinusoidal positions (length, d) in ``like``'s dtype and device."""
    return sinusoidal_positions(length, cfg.d_model).to(device=like.device, dtype=like.dtype)


def lm_logits(h: torch.Tensor, cfg: ModelConfig, embed: torch.Tensor,
              final_norm: torch.Tensor, lm_head: Optional[torch.Tensor]) -> torch.Tensor:
    """Final norm and head: (B, S, d) -> (B, S, vocab), in the weights' dtype."""
    h = rms_norm(h, final_norm, cfg.rms_eps)
    head = embed.T if cfg.tie_embeddings else lm_head
    return torch.einsum("bsd,dv->bsv", h, head)


def _head(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    return lm_logits(h, model.cfg, model.embed, model.final_norm,
                     getattr(model, "lm_head", None))


def _layer(body, remat: bool):
    """``body`` as it is, or run through ``torch.utils.checkpoint`` so that
    its activations are recomputed in the backward pass (the reference's
    ``_maybe_ckpt``)."""
    if not remat:
        return body

    def checkpointed(*args):
        return checkpoint(body, *args, use_reentrant=False)
    return checkpointed


# =============================== mesh paths ===================================
def _bspec(mesh, batch: int):
    """Batch-axis names if they divide the batch, else None."""
    return spmd.bspec(mesh, batch)


def _constrain(x, mesh, spec):
    """Activation sharding constraint (the reference's
    ``with_sharding_constraint``): a DTensor redistributed to ``spec``; the
    input as it is without a mesh."""
    return spmd.constrain(x, mesh, spec)


def _view(names, tensors) -> SimpleNamespace:
    """A tree of namespaces holding ``tensors`` at the dotted ``names``: a
    module's parameters as local shards, for the single-device code."""
    root = SimpleNamespace()
    for name, t in zip(names, tensors):
        node = root
        *path, leaf = name.split(".")
        for p in path:
            if not hasattr(node, p):
                setattr(node, p, SimpleNamespace())
            node = getattr(node, p)
        setattr(node, leaf, t)
    return root


def _sublayer(fn, mesh, h, named, *, split: bool, specs=None, out_spec=None,
              extra=(), extra_specs=(), out_partial=None, grad_model=None):
    """``fn(h_local, view, *extra_local)`` on local shards: ``h`` in its own
    layout, the parameters ``named`` ((name, DTensor) pairs, viewed as a
    tree) in their compute layouts (``specs`` overrides some by name),
    ``extra`` DTensors in ``extra_specs``.  ``split``: the ranks of
    ``model`` each compute a share of the output, which is then ``Partial``
    on ``model`` (unless ``out_partial`` says otherwise), as are the
    gradients of ``h`` and of the replicated parameters.  ``grad_model``
    (default ``split``): the gradients of the replicated parameters are
    ``Partial`` on ``model`` (its ranks compute different rows)."""
    act = spmd.spec_of(h)
    batch = tuple(a for a in spmd._names(act[0]))
    grad_model = split if grad_model is None else grad_model
    part = batch + (("model",) if grad_model else ())
    names = [n for n, _ in named]
    ws = [w for _, w in named]
    wspecs = [(specs or {}).get(n) or spmd.use_spec(w) for n, w in named]
    n = len(ws)

    def local(h_l, *rest):
        return fn(h_l, _view(names, rest[:n]), *rest[n:])
    return spmd.spmd(
        local, mesh, (h, *ws, *extra), [act, *wspecs, *extra_specs],
        [("model",) if split else ()] + [part] * n + [("model",) if split else ()] * len(extra),
        out_spec or act, ("model",) if split and out_partial is None else (out_partial or ()))


def _named(module: nn.Module, prefix: str = ""):
    return [(prefix + n, p) for n, p in module.named_parameters()]


def _full(named):
    """Compute specs that gather the parameters whole (replicated on every
    axis): the layout of the sublayers that have no tensor-parallel path."""
    return {n: (None,) * w.ndim for n, w in named}


def _attn_mesh(blk: Block, h, cfg: ModelConfig, *, causal: bool, use_rope: bool, mesh,
               seq_par_ok: bool = True):
    """The attention branch of ``_attn_sublayer`` on a mesh.  Heads that
    divide ``model``: each rank computes its heads (the K/V heads it reads,
    sliced from replicated ones when the K/V head count does not divide),
    and the output is ``Partial`` on ``model``.  Otherwise, where the
    sequence divides ``model``, sequence parallel as in the reference: q
    over the rank's rows of the sequence, K/V gathered over ``model``, the
    output gathered back to the batch layout.  Otherwise replicated."""
    B, S, _ = h.shape
    M = spmd.model_size(mesh)
    named = [("ln1", blk.ln1)] + _named(blk.attn, "attn.")
    seq_par = (seq_par_ok and M > 1 and cfg.num_heads % M != 0 and S % M == 0)
    if not seq_par:
        split = spmd.sharded_on(spmd.use_spec(blk.attn.wq), "model")
        kv_split = spmd.sharded_on(spmd.use_spec(blk.attn.wk), "model")
        groups = cfg.num_heads // cfg.kv_heads

        def local(h_l, v):
            x = rms_norm(h_l, v.ln1, cfg.rms_eps)
            kv_idx = None
            if split and not kv_split:
                hq = v.attn.wq.shape[1]
                first = spmd.model_rank(mesh) * hq
                kv_idx = torch.arange(first, first + hq, device=x.device) // groups
            return _attn_out(v.attn, x, cfg, causal=causal, use_rope=use_rope, kv_idx=kv_idx)
        return _sublayer(local, mesh, h, named, split=split)

    bs = _bspec(mesh, B)
    S_l = S // M
    h_seq = _constrain(h, mesh, (bs, "model", None))

    def project(h_l, v):
        x = rms_norm(h_l, v.ln1, cfg.rms_eps)
        start = spmd.model_rank(mesh) * S_l
        return _qkv(v.attn, x, cfg, use_rope, q_pos0=start, kv_pos0=start)
    rows = (bs, "model", None, None)
    proj = [n for n in named if n[0] != "attn.wo"]
    q, k, v = _sublayer(project, mesh, h_seq, proj, split=False, out_spec=[rows] * 3,
                        grad_model=True)
    # the reference's seq-par constraints: q by rows, K/V replicated on model
    q = _constrain(q, mesh, rows)
    k = _constrain(k, mesh, (bs, None, None, None))
    v = _constrain(v, mesh, (bs, None, None, None))

    def attend(q_l, w, k_l, v_l):
        o = flash_attention(q_l, k_l, v_l, causal=causal,
                            q_offset=spmd.model_rank(mesh) * S_l)
        return torch.einsum("bshk,hkd->bsd", o, w.wo)
    full = (bs, None, None, None)
    out = spmd.spmd(
        lambda q_l, wo, k_l, v_l: attend(q_l, SimpleNamespace(wo=wo), k_l, v_l),
        mesh, (q, blk.attn.wo, k, v), [rows, spmd.use_spec(blk.attn.wo), full, full],
        [(), (bs or ()) + ("model",), ("model",), ("model",)], (bs, "model", None))
    return _constrain(out, mesh, (bs, None, None))


def _ffn_mesh(blk: Block, h, cfg: ModelConfig, mesh):
    """The FFN branch of ``_ffn_sublayer`` on a mesh.  The MLP: its hidden
    width over ``model`` where it divides (the output ``Partial`` there).
    The routed experts: expert parallel over ``model`` as the reference's
    ``shard_map`` runs them (the tokens of the batch shard on every rank of
    ``model``, the experts split, two ``all_to_all``s; the router and the
    shared experts whole), the output replicated on ``model``."""
    if not hasattr(blk, "moe"):
        named = [("ln2", blk.ln2)] + _named(blk.mlp, "mlp.")
        split = spmd.sharded_on(spmd.use_spec(blk.mlp.w_gate), "model")

        def local(h_l, v):
            x = rms_norm(h_l, v.ln2, cfg.rms_eps)
            return swiglu(x, v.mlp.w_gate, v.mlp.w_up, v.mlp.w_down)
        return _sublayer(local, mesh, h, named, split=split)

    # expert parallel where the experts shard over model (the rules drop
    # the sharding when E does not divide, where the reference's shard_map
    # would fail): the experts are then whole on every rank
    ep = spmd.sharded_on(spmd.use_spec(blk.moe.experts.w_gate), "model")
    M = spmd.model_size(mesh) if ep else 1
    named = [("ln2", blk.ln2)] + _named(blk.moe, "moe.")
    specs = _full([n for n in named if not n[0].startswith("moe.experts.")])
    group = mesh.get_group("model") if ep else None

    def local(h_l, v):
        x = rms_norm(h_l, v.ln2, cfg.rms_eps)
        out = moe_ffn(v.moe, x, cfg, axis=group, axis_size=M)
        # every rank of model computes the whole output for the same tokens:
        # each carries 1/M of its gradient, and the gradients of the tokens
        # and of the replicated weights are summed over model
        return spmd.scale_grad(out, 1.0 / M)
    return _sublayer(local, mesh, h, named, split=M > 1, specs=specs, out_partial=())


def _replicated_sublayer(fn, mesh, h, named, extra=(), extra_specs=()):
    """``fn(h_local, view, *extra_local)`` with the parameters gathered
    whole: the layers with no tensor-parallel path here (Mamba-2, MLA,
    cross-attention) run on the batch shard, replicated over ``model``."""
    return _sublayer(fn, mesh, h, named, split=False, specs=_full(named),
                     extra=extra, extra_specs=extra_specs)


def _embed_mesh(model: "Transformer", tokens, mesh, act):
    """The embedding lookup on a mesh: each rank of ``model`` looks up the
    tokens in its rows of a vocabulary-sharded table (zeros for the
    others), and the constraint sums them."""
    w = model.embed
    vsplit = spmd.sharded_on(spmd.use_spec(w), "model")

    def local(tok_l, w_l):
        if tok_l.ndim == 1:                        # decode: one token a sequence
            tok_l = tok_l[:, None]
        if not vsplit:
            return F.embedding(tok_l, w_l)
        rows = w_l.shape[0]
        first = spmd.model_rank(mesh) * rows
        hit = (tok_l >= first) & (tok_l < first + rows)
        idx = torch.where(hit, tok_l - first, 0)
        return F.embedding(idx, w_l) * hit[..., None].to(w_l.dtype)
    batch = tuple(spmd._names(act[0]))
    h = spmd.spmd(local, mesh, (tokens, w), [act[:tokens.ndim], spmd.use_spec(w)],
                  [(), batch], act, ("model",) if vsplit else ())
    return _constrain(h, mesh, act)


def _head_mesh(model: "Transformer", h, mesh):
    """Final norm and head on a mesh: logits (B, S, vocab), the vocabulary
    over ``model`` where it divides (the reference's last constraint)."""
    cfg = model.cfg
    bs = spmd.spec_of(h)[0]
    named = [("final_norm", model.final_norm)] + (
        [("embed", model.embed)] if cfg.tie_embeddings else [("lm_head", model.lm_head)])
    head_spec = spmd.use_spec(named[1][1])
    vsplit = spmd.sharded_on(head_spec, "model")
    out_spec = (bs, None, "model" if vsplit else None)

    def local(h_l, v):
        return lm_logits(h_l, cfg, getattr(v, "embed", None), v.final_norm,
                         getattr(v, "lm_head", None))
    logits = _sublayer(local, mesh, h, named, split=vsplit, out_spec=out_spec,
                       out_partial=())
    return _constrain(logits, mesh, out_spec)


def _forward_mesh(model: "Transformer", tokens, *, patches, enc_inputs, remat: bool, mesh):
    """``forward`` on a mesh: ``model``'s parameters DTensors
    (``distributed.sharding.shard_params``), ``tokens`` (and ``patches``/
    ``enc_inputs``) DTensors in ``batch_specs``' layout.  The activations
    carry the reference's constraints: the batch over the batch axes after
    the embedding and after every layer, the logits' vocabulary over
    ``model``."""
    cfg = model.cfg
    bs = _bspec(mesh, tokens.shape[0])
    act = (bs, None, None)
    h = _embed_mesh(model, tokens, mesh, act)
    if cfg.family == "vlm" and patches is not None:
        npatch = patches.shape[1]
        h = spmd.spmd(lambda p_l, h_l: torch.cat([p_l.to(h_l.dtype), h_l[:, npatch:]], dim=1),
                      mesh, (patches, h), [act, act], [(), ()], act)

    def c(x):
        return _constrain(x, mesh, act)

    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every

        def mamba_body(h, blk, shared):
            def local(h_l, v):
                y, _ = mamba2_forward(v.mamba, rms_norm(h_l, v.ln, cfg.rms_eps), cfg)
                return h_l + y
            h = _replicated_sublayer(local, mesh, h, _named(blk))
            if shared is not None:
                h = _shared_attn_block(shared, h, cfg, mesh)
            return c(h)
        body = _layer(mamba_body, remat)
        for idx, blk in enumerate(model.blocks):
            site = cfg.family == "hybrid" and idx % every == every - 1
            h = body(h, blk, model.shared_block if site else None)
    elif cfg.family == "encdec":
        if enc_inputs is None:
            raise ValueError(f"{cfg.name}: encdec needs enc_inputs")

        def add_positions(x):
            return spmd.spmd(lambda x_l: x_l + _positions(x_l.shape[1], cfg, x_l),
                             mesh, (x,), [act], [()], act)

        def enc_body(enc, blk):
            enc = _attn_sublayer(blk, enc, cfg, causal=False, use_rope=False, mesh=mesh)
            return c(_ffn_sublayer(blk, enc, cfg, mesh))

        def dec_body(h, blk, enc):
            h = _attn_sublayer(blk, h, cfg, use_rope=False, mesh=mesh)
            named = [("ln_x", blk.ln_x)] + _named(blk.xattn, "xattn.")
            h = _replicated_sublayer(
                lambda h_l, v, e_l: _cross_sublayer(v, h_l, cfg, e_l), mesh, h, named,
                extra=(enc,), extra_specs=(act,))
            return c(_ffn_sublayer(blk, h, cfg, mesh))
        h = add_positions(h)
        enc = add_positions(spmd.spmd(lambda e_l: e_l.to(cfg.torch_dtype), mesh,
                                      (enc_inputs,), [act], [()], act))
        body = _layer(enc_body, remat)
        for blk in model.enc_blocks:
            enc = body(enc, blk)
        enc = _replicated_sublayer(
            lambda e_l, v: rms_norm(e_l, v.enc_norm, cfg.rms_eps), mesh, enc,
            [("enc_norm", model.enc_norm)])
        body = _layer(dec_body, remat)
        for blk in model.blocks:
            h = body(h, blk, enc)
    else:
        def body(h, blk):
            if cfg.mla:
                h = _replicated_sublayer(lambda h_l, v: _mla_sublayer(v, h_l, cfg), mesh, h,
                                         [("ln1", blk.ln1)] + _named(blk.attn, "attn."))
            else:
                h = _attn_sublayer(blk, h, cfg, mesh=mesh)
            return c(_ffn_sublayer(blk, h, cfg, mesh))
        body = _layer(body, remat)
        for blk in model.blocks:
            h = body(h, blk)
    return _head_mesh(model, h, mesh)


def forward(model: Transformer, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            enc_inputs: Optional[torch.Tensor] = None,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """Full-sequence forward of ``tokens`` (B, S); returns logits (B, S, vocab).
    vlm: ``patches`` (B, n_patch, d) take the first ``n_patch`` positions.
    moe: each layer routes all B·S tokens jointly, with the capacity of B·S
    tokens, so a token dropped here may be kept by a decode step.
    encdec: ``enc_inputs`` (B, S_enc, d) are the (stubbed) frontend's frame
    embeddings that the encoder runs over; without them it raises
    ``ValueError``.  ``remat``: recompute each layer's activations in the
    backward pass instead of keeping them.  ``mesh``: a ``DeviceMesh``
    with named dims, the parameters and inputs DTensors on it
    (``_forward_mesh``); the logits are then a DTensor too."""
    if mesh is not None:
        return _forward_mesh(model, tokens, patches=patches, enc_inputs=enc_inputs,
                             remat=remat, mesh=mesh)
    cfg = model.cfg
    # F.embedding, not ``embed[tokens]``: its backward adds the rows in an
    # order fixed by the indices (sorted on CUDA), where indexing's
    # accumulating ``index_put_`` adds them in thread order on the CPU, so
    # two equal steps could differ in the last bits.
    h = F.embedding(tokens, model.embed)
    if cfg.family == "vlm" and patches is not None:
        npatch = patches.shape[1]
        h = torch.cat([patches.to(h.dtype), h[:, npatch:]], dim=1)
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every

        def mamba_body(h, blk, shared):
            y, _ = mamba2_forward(blk.mamba, rms_norm(h, blk.ln, cfg.rms_eps), cfg)
            h = h + y
            return h if shared is None else _shared_attn_block(shared, h, cfg)
        body = _layer(mamba_body, remat)
        for idx, blk in enumerate(model.blocks):
            site = cfg.family == "hybrid" and idx % every == every - 1
            h = body(h, blk, model.shared_block if site else None)
    elif cfg.family == "encdec":
        if enc_inputs is None:
            raise ValueError(
                f"{cfg.name}: encdec needs enc_inputs, the frame embeddings of its "
                f"audio frontend, which is stubbed in both packages")

        def enc_body(enc, blk):
            enc = _attn_sublayer(blk, enc, cfg, causal=False, use_rope=False)
            return _ffn_sublayer(blk, enc, cfg)

        def dec_body(h, blk, enc):
            h = _attn_sublayer(blk, h, cfg, use_rope=False)
            h = _cross_sublayer(blk, h, cfg, enc)
            return _ffn_sublayer(blk, h, cfg)
        h = h + _positions(h.shape[1], cfg, h)
        enc = enc_inputs.to(h.dtype)
        enc = enc + _positions(enc.shape[1], cfg, enc)
        body = _layer(enc_body, remat)
        for blk in model.enc_blocks:
            enc = body(enc, blk)
        enc = rms_norm(enc, model.enc_norm, cfg.rms_eps)
        body = _layer(dec_body, remat)
        for blk in model.blocks:
            h = body(h, blk, enc)
    else:
        def body(h, blk):
            h = _mla_sublayer(blk, h, cfg) if cfg.mla else _attn_sublayer(blk, h, cfg)
            return _ffn_sublayer(blk, h, cfg)
        body = _layer(body, remat)
        for blk in model.blocks:
            h = body(h, blk)
    return _head(model, h)


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            enc_inputs: Optional[torch.Tensor] = None,
            remat: bool = True, mesh=None) -> torch.Tensor:
    """The reference's training loss, a 0-d fp32 tensor: the mean over
    every position of the NLL of ``labels`` (B, S) under fp32 logits plus
    the PaLM z-loss ``1e-4 * logsumexp**2``.  The picked logit is a gather
    (the reference's masked sum over the vocabulary adds only zeros beside
    it, so the two are equal).  With a mesh (``labels`` a DTensor like
    ``tokens``), ``_loss_mesh``: the loss comes back whole on every rank."""
    logits = forward(model, tokens, patches=patches, enc_inputs=enc_inputs,
                     remat=remat, mesh=mesh)
    if mesh is not None:
        return _loss_mesh(logits, labels, mesh)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    zloss = 1e-4 * torch.square(lse)
    return torch.mean(nll + zloss)


def _loss_mesh(logits, labels, mesh) -> torch.Tensor:
    """``loss_fn``'s reduction over vocabulary-sharded logits, as the
    reference has the partitioner do it: each rank of ``model`` takes the
    max, the sum of exponentials and the masked sum of the picked logit over
    its columns; the max is all-reduced, the two sums summed by the
    constraints, so the (B, S, V) logits are never gathered."""
    lspec = spmd.spec_of(logits)
    rows = lspec[:2]
    vsplit = spmd.sharded_on(lspec, "model")
    group = mesh.get_group("model") if vsplit else None

    def stats(lg_l, lab_l):
        x = lg_l.float()
        m = x.amax(dim=-1).detach()
        if vsplit:
            m = spmd.all_reduce(m, "max", group)
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        cols = x.shape[-1]
        first = spmd.model_rank(mesh) * cols if vsplit else 0
        iota = torch.arange(first, first + cols, device=x.device)
        picked = torch.where(iota == lab_l[..., None].long(), x, 0.0).sum(dim=-1)
        return m, s, picked
    part = ("model",) if vsplit else ()
    m, s, picked = spmd.spmd(stats, mesh, (logits, labels), [lspec, rows],
                             [(), ()], [rows] * 3, [(), part, part])
    lse = m + torch.log(_constrain(s, mesh, rows))
    nll = lse - _constrain(picked, mesh, rows)
    zloss = 1e-4 * torch.square(lse)
    return torch.mean(nll + zloss).full_tensor()


# =============================== decode =======================================
def _cache_keys(cfg: ModelConfig) -> Tuple[str, str]:
    """The two cache tensors of a decoder layer's attention."""
    return ("ckv", "kr") if cfg.mla else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0,
               device: DeviceSpec = "cuda", dtype: Optional[torch.dtype] = None
               ) -> Dict[str, Any]:
    """The serving cache and ``len``, a host int (the reference's is a device
    scalar), by family:

    - dense, vlm, moe: ``k``/``v`` of (L, batch, max_len, kv_heads,
      head_dim), or for MLA the latent ``ckv`` (L, batch, max_len, r) and
      the rope key ``kr`` (L, batch, max_len, dr);
    - ssm, hybrid: ``ssm`` (L, batch, H, P, N), fp32 whatever ``dtype``,
      and ``conv`` (L, batch, K - 1, di + 2N), the last conv inputs; the
      hybrid adds ``sk``/``sv`` (sites, batch, max_len, kv_heads, head_dim)
      for its ``num_layers // shared_attn_every`` shared-block sites;
    - encdec: ``k``/``v`` for the decoder's self-attention and ``enc_k``/
      ``enc_v`` (L, batch, enc_len, kv_heads, head_dim), zeros for the
      caller to fill."""
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    L = cfg.num_layers
    kv = (batch, max_len, cfg.kv_heads, cfg.hdim)
    if cfg.family in ("ssm", "hybrid"):
        shapes = {"ssm": ((L, batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                          torch.float32),
                  "conv": ((L, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state), dt)}
        if cfg.family == "hybrid":
            sites = cfg.num_layers // cfg.shared_attn_every
            shapes.update(sk=((sites,) + kv, dt), sv=((sites,) + kv, dt))
    elif cfg.mla:
        shapes = {"ckv": ((L, batch, max_len, cfg.kv_lora_rank), dt),
                  "kr": ((L, batch, max_len, cfg.qk_rope_dim), dt)}
    else:
        shapes = {"k": ((L,) + kv, dt), "v": ((L,) + kv, dt)}
        if cfg.family == "encdec":
            enc = (L, batch, enc_len, cfg.kv_heads, cfg.hdim)
            shapes.update(enc_k=(enc, dt), enc_v=(enc, dt))
    cache: Dict[str, Any] = {"len": 0}
    for key, (shape, kdt) in shapes.items():
        cache[key] = torch.zeros(shape, dtype=kdt, device=dev)
    return cache


def layer_caches(cfg: ModelConfig, cache: Dict[str, Any], li: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``li``'s two cache tensors: K and V, or MLA's ``ckv`` and ``kr``."""
    return tuple(cache[key][li] for key in _cache_keys(cfg))


def cache_position(cfg: ModelConfig, cache: Dict[str, Any]) -> int:
    """The slot the next token's cache entries go to; raises
    ``CacheFullError`` when there is none (the reference clamps and
    overwrites the last slot).  The limit is the attention caches' length
    (the hybrid's ``sk``); a pure ssm cache has none."""
    cur = int(cache["len"])
    if cfg.family == "ssm":
        return cur
    max_len = cache["sk" if cfg.family == "hybrid" else _cache_keys(cfg)[0]].shape[2]
    if cur >= max_len:
        raise CacheFullError(
            f"decode step at len {cur}: the cache holds {max_len} positions")
    return cur


def position(cur: int, device) -> torch.Tensor:
    """The host position ``cur`` as the 0-d int64 tensor the step reads."""
    return torch.full((), cur, dtype=torch.int64, device=device)


def position_table(model: "Transformer", cache: Dict[str, Any]) -> Optional[torch.Tensor]:
    """encdec's sinusoidal positions (max_len, d) for every slot of ``cache``,
    in the embedding's dtype and device, the table the reference slices at
    ``len``; ``None`` for the other families."""
    if model.cfg.family != "encdec":
        return None
    return _positions(cache["k"].shape[2], model.cfg, model.embed)


def _decode_attn(a: Attention, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor,
                 use_rope: bool = True) -> torch.Tensor:
    """GQA for one token of normed ``x``: its K/V written in place at the
    position ``pos`` (0-d int64 on the cache's device)."""
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    posv = pos.reshape(1)
    if use_rope:
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    k_cache.index_copy_(1, posv, k.to(k_cache.dtype))
    v_cache.index_copy_(1, posv, v.to(v_cache.dtype))
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return torch.einsum("bshk,hkd->bsd", o, a.wo)


def _decode_mla(a: MLAAttention, x: torch.Tensor, cfg: ModelConfig, ckv_cache: torch.Tensor,
                kr_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MLA for one token of normed ``x``: its latent and rope key written in
    place at ``pos``, attention in the latent space."""
    posv = pos.reshape(1)
    q_nope, q_rope, c_kv, k_rope = _mla_project(a, x, cfg, posv)
    ckv_cache.index_copy_(1, posv, c_kv.to(ckv_cache.dtype))
    kr_cache.index_copy_(1, posv, k_rope.to(kr_cache.dtype))
    ctx = mla_decode_attention(a, q_nope, q_rope, ckv_cache, kr_cache, pos + 1, cfg)
    return torch.einsum("bshk,hkd->bsd", ctx, a.wo)


def decode_layer(blk: Block, h: torch.Tensor, cfg: ModelConfig,
                 caches: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
    """One layer for one token: attention against the layer's ``caches``
    (``layer_caches``; written in place at ``pos``, the 0-d position
    tensor), then the MLP or the routed experts.  h: (B, 1, d)."""
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    attend = _decode_mla if cfg.mla else _decode_attn
    h = h + attend(blk.attn, x, cfg, *caches, pos)
    return _ffn_sublayer(blk, h, cfg)


def _decode_mamba(blk: MambaBlock, h: torch.Tensor, cfg: ModelConfig,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor) -> torch.Tensor:
    """One Mamba-2 layer for one token; its states updated in place."""
    y, ss, cs = mamba2_decode(blk.mamba, rms_norm(h, blk.ln, cfg.rms_eps)[:, 0, :], cfg,
                              ssm_state, conv_state)
    ssm_state.copy_(ss)
    conv_state.copy_(cs)
    return h + y[:, None, :]


def _decode_encdec_layer(blk: Block, h: torch.Tensor, cfg: ModelConfig,
                         cache: Dict[str, Any], li: int, pos: torch.Tensor) -> torch.Tensor:
    """One decoder layer for one token: causal self-attention without rope
    (K/V written in place at ``pos``), cross-attention against the layer's
    ``enc_k``/``enc_v`` as they are, then the MLP."""
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    h = h + _decode_attn(blk.attn, x, cfg, cache["k"][li], cache["v"][li], pos,
                         use_rope=False)
    a = blk.xattn
    q = torch.einsum("bsd,dhk->bshk", rms_norm(h, blk.ln_x, cfg.rms_eps), a.wq)
    enc_k = cache["enc_k"][li]
    o = decode_attention(q, enc_k, cache["enc_v"][li], enc_k.shape[1])
    h = h + torch.einsum("bshk,hkd->bsd", o, a.wo)
    return _ffn_sublayer(blk, h, cfg)


# -- decode on a mesh -------------------------------------------------------------
def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    for g in groups:
        t = spmd.all_reduce(t, op, g)
    return t


def _softmax_av(scores: torch.Tensor, values: torch.Tensor, eq: str, groups) -> torch.Tensor:
    """softmax(scores) applied to ``values`` (``einsum(eq, p, values)``)
    where the last dim of ``scores`` and the values' positions are split
    over ``groups``: the partial max and sums of each rank are combined
    (the distributed flash-decode pattern the reference's partitioner
    lowers a sharded cache length to)."""
    m = _all_reduce(scores.amax(dim=-1, keepdim=True), "max", groups)
    p = torch.exp(scores - m)
    denom = _all_reduce(p.sum(dim=-1, keepdim=True), "sum", groups)
    return _all_reduce(torch.einsum(eq, p, values), "sum", groups) / denom


def _decode_attn_local(a, x: torch.Tensor, cfg: ModelConfig, kc: torch.Tensor,
                       vc: torch.Tensor, cur: int, *, s0: int, groups, use_rope: bool,
                       write: bool, n_valid: int) -> torch.Tensor:
    """``_decode_attn`` on a rank's shard of the cache: positions
    ``s0 .. s0 + len`` of it (the rank owning ``cur`` writes the new K/V),
    the softmax combined over ``groups``."""
    at = position(cur, x.device)
    posv = at.reshape(1)
    if not groups:
        if write:
            return _decode_attn(a, x, cfg, kc, vc, at, use_rope=use_rope)
        q = torch.einsum("bsd,dhk->bshk", x, a.wq)
        o = decode_attention(q, kc, vc, n_valid)
        return torch.einsum("bshk,hkd->bsd", o, a.wo)
    if write:
        q, k, v = _qkv(a, x, cfg, False)
        if use_rope:
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
        if s0 <= cur < s0 + kc.shape[1]:
            kc[:, cur - s0] = k[:, 0].to(kc.dtype)
            vc[:, cur - s0] = v[:, 0].to(vc.dtype)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    groups_ = q.shape[2] // kc.shape[2]
    k_r = repeat_kv(kc, groups_)
    v_r = repeat_kv(vc, groups_)
    scores = torch.einsum("bshd,bchd->bhsc", q.float(), k_r.float()) * q.shape[-1] ** -0.5
    pos = s0 + torch.arange(kc.shape[1], device=x.device)
    scores = torch.where((pos < n_valid)[None, None, None, :], scores, NEG_INF)
    o = _softmax_av(scores, v_r.float(), "bhsc,bchd->bhsd", groups)
    return torch.einsum("bshk,hkd->bsd", o.transpose(1, 2).to(q.dtype), a.wo)


def _decode_mla_local(a, x: torch.Tensor, cfg: ModelConfig, ckv: torch.Tensor,
                      kr: torch.Tensor, cur: int, *, s0: int, groups) -> torch.Tensor:
    """``_decode_mla`` on a rank's shard of the latent cache."""
    at = position(cur, x.device)
    posv = at.reshape(1)
    if not groups:
        return _decode_mla(a, x, cfg, ckv, kr, at)
    q_nope, q_rope, c_kv, k_rope = _mla_project(a, x, cfg, posv)
    if s0 <= cur < s0 + ckv.shape[1]:
        ckv[:, cur - s0] = c_kv[:, 0].to(ckv.dtype)
        kr[:, cur - s0] = k_rope[:, 0].to(kr.dtype)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.float(), a.w_uk.float())
    s = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bshr,blr->bhsl", q_eff, ckv.float())
              + torch.einsum("bshd,bld->bhsl", q_rope.float(), kr.float())) * s
    pos = s0 + torch.arange(ckv.shape[1], device=x.device)
    scores = torch.where((pos < cur + 1)[None, None, None, :], scores, NEG_INF)
    ctx_r = _softmax_av(scores, ckv.float(), "bhsl,blr->bhsr", groups).transpose(1, 2)
    ctx = torch.einsum("bshr,rhd->bshd", ctx_r, a.w_uv.float()).to(q_nope.dtype)
    return torch.einsum("bshk,hkd->bsd", ctx, a.wo)


def _seq_layout(mesh, spec):
    """The mesh axes a cache's sequence dim (dim 2 of the stacked layout) is
    split over, their process groups, and this rank's index along them."""
    axes = spmd._names(spec[2])
    sizes = spmd.mesh_axes(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
    return [mesh.get_group(a) for a in axes], index


def _decode_attn_mesh(attn_named, h, cfg: ModelConfig, caches, li: int, cur: int, mesh, *,
                      mla: bool = False, use_rope: bool = True, write: bool = True,
                      n_valid: Optional[int] = None):
    """One token's attention branch against the layer-``li`` slices of the
    stacked cache DTensors ``caches`` (``cache_specs``' layouts), written in
    place.  Heads over ``model`` where the cache shards them (the output
    ``Partial`` there); else the weights whole, and a sequence split over
    ``model`` and/or ``data`` combined by ``_softmax_av``."""
    spec = spmd.spec_of(caches[0])
    head_split = not mla and len(spec) > 3 and spmd.sharded_on(spec[3:4], "model")
    groups, index = _seq_layout(mesh, spec)
    ln = attn_named[0][0]
    specs = None if head_split else _full(attn_named)

    def local(h_l, v, *caches_l):
        x = rms_norm(h_l, getattr(v, ln), cfg.rms_eps)
        layer = [c[li] for c in caches_l]
        s0 = index * layer[0].shape[1]
        a = v.attn if hasattr(v, "attn") else v.xattn
        if mla:
            return _decode_mla_local(a, x, cfg, *layer, cur, s0=s0, groups=groups)
        return _decode_attn_local(a, x, cfg, *layer, cur, s0=s0, groups=groups,
                                  use_rope=use_rope, write=write,
                                  n_valid=cur + 1 if n_valid is None else n_valid)
    return _sublayer(local, mesh, h, attn_named, split=head_split, specs=specs,
                     extra=tuple(caches), extra_specs=tuple(spmd.spec_of(c) for c in caches))


def _decode_mesh(model: "Transformer", cache: Dict[str, Any], tokens, mesh):
    """``decode_step`` on a mesh: the parameters, ``tokens`` (B,) and the
    cache's tensors DTensors (``shard_params``, ``shard_cache``); the
    logits come back a DTensor (B, vocab), the vocabulary over ``model``.
    The FFNs run as in ``forward`` (the experts expert parallel, as the
    reference passes its mesh to ``_moe_sublayer``).  A Mamba-2 layer runs
    with its weights whole on the batch shard (``_decode_mamba_mesh``)."""
    cfg = model.cfg
    cur = cache_position(cfg, cache)
    bs = _bspec(mesh, tokens.shape[0])
    act = (bs, None, None)
    h = _embed_mesh(model, tokens, mesh, act)
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        shared = getattr(model, "shared_block", None)
        for idx, blk in enumerate(model.blocks):
            h = _decode_mamba_mesh(blk, h, cfg, cache, idx, mesh)
            if cfg.family == "hybrid" and idx % every == every - 1:
                named = [("ln1", shared.ln1)] + _named(shared.attn, "attn.")
                h = h + _decode_attn_mesh(named, h, cfg, [cache["sk"], cache["sv"]],
                                          idx // every, cur, mesh)
                h = _ffn_sublayer(shared, h, cfg, mesh)
        return _decode_logits(model, h, cache, cur, mesh)
    if cfg.family == "encdec":
        h = spmd.spmd(lambda h_l: h_l + _positions(cur + 1, cfg, h_l)[cur], mesh, (h,),
                      [act], [()], act)
    keys = _cache_keys(cfg)
    for li, blk in enumerate(model.blocks):
        named = [("ln1", blk.ln1)] + _named(blk.attn, "attn.")
        h = h + _decode_attn_mesh(named, h, cfg, [cache[k] for k in keys], li, cur, mesh,
                                  mla=cfg.mla, use_rope=cfg.family != "encdec")
        if cfg.family == "encdec":
            named = [("ln_x", blk.ln_x)] + _named(blk.xattn, "xattn.")
            h = h + _decode_attn_mesh(named, h, cfg, [cache["enc_k"], cache["enc_v"]], li,
                                      cur, mesh, use_rope=False, write=False,
                                      n_valid=cache["enc_k"].shape[2])
        h = _ffn_sublayer(blk, h, cfg, mesh)
    return _decode_logits(model, h, cache, cur, mesh)


def _decode_logits(model: "Transformer", h, cache: Dict[str, Any], cur: int, mesh):
    logits = _head_mesh(model, h, mesh)
    lspec = spmd.spec_of(logits)
    logits = spmd.spmd(lambda l_l: l_l[:, 0, :], mesh, (logits,), [lspec], [()],
                       (lspec[0], lspec[2]))
    cache["len"] = cur + 1
    return logits, cache


def _decode_mamba_mesh(blk: MambaBlock, h, cfg: ModelConfig, cache: Dict[str, Any],
                       idx: int, mesh):
    """``_decode_mamba`` on a mesh: the weights whole, the layer's ssm state
    gathered over its heads' split (``cache_specs`` shards them over
    ``model`` where they divide), the whole step computed on the batch
    shard, and each rank's heads of the new state written back."""
    ss, cs = cache["ssm"], cache["conv"]
    heads = spmd.sharded_on(spmd.spec_of(ss)[2:3], "model")
    group = mesh.get_group("model") if heads else None

    def local(h_l, v, ss_l, cs_l):
        state = ss_l[idx]
        if heads:
            state = spmd.all_gather(state, 1, group)
        state = state.clone()
        out = _decode_mamba(v, h_l, cfg, state, cs_l[idx])
        rows = ss_l.shape[2]
        first = spmd.model_rank(mesh) * rows if heads else 0
        ss_l[idx].copy_(state[:, first:first + rows])
        return out
    return _replicated_sublayer(local, mesh, h, _named(blk), extra=(ss, cs),
                                extra_specs=(spmd.spec_of(ss), spmd.spec_of(cs)))


def decode_tokens(model: Transformer, cache: Dict[str, Any], tokens: torch.Tensor,
                  pos: torch.Tensor, pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The device work of one single-device step: the logits (B, vocab) of
    ``tokens`` (B,), the caches written in place at ``pos``, a 0-d int64
    tensor equal to ``cache["len"]`` (the reference's device scalar);
    ``pe`` is encdec's ``position_table``.  It reads the position only
    through ``pos`` (``index_copy_``, ``index_select``, a length mask over
    the whole cache) and never syncs with the host, so the same launches
    serve every position: ``models/graph.py`` captures them once.  It
    leaves ``len`` to the caller."""
    cfg = model.cfg
    h = model.embed[tokens][:, None, :]
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        for idx, blk in enumerate(model.blocks):
            h = _decode_mamba(blk, h, cfg, cache["ssm"][idx], cache["conv"][idx])
            if cfg.family == "hybrid" and idx % every == every - 1:
                site = idx // every
                h = decode_layer(model.shared_block, h, cfg,
                                 (cache["sk"][site], cache["sv"][site]), pos)
    elif cfg.family == "encdec":
        # the sinusoidal position at len (the reference slices its table there)
        h = h + pe.index_select(0, pos.reshape(1))
        for li, blk in enumerate(model.blocks):
            h = _decode_encdec_layer(blk, h, cfg, cache, li, pos)
    else:
        for li, blk in enumerate(model.blocks):
            h = decode_layer(blk, h, cfg, layer_caches(cfg, cache, li), pos)
    return _head(model, h)[:, 0, :]


def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor, *, mesh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume one token per sequence (``tokens`` (B,)),
    return logits (B, vocab) and ``cache``, updated in place.  Raises
    ``CacheFullError`` before any state is written when the attention
    caches are full (``cache_position``).  The device work is
    ``decode_tokens`` at the host ``len``, run eagerly; ``DecodeGraph``
    replays it.  ``mesh``: ``_decode_mesh``."""
    if mesh is not None:
        return _decode_mesh(model, cache, tokens, mesh)
    cur = cache_position(model.cfg, cache)
    logits = decode_tokens(model, cache, tokens, position(cur, model.embed.device),
                           position_table(model, cache))
    cache["len"] = cur + 1
    return logits, cache
