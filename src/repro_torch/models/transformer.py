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
(``train/step.py``).  ``forward``'s ``mesh`` is left out (sharding is
ROADMAP A14(e)).  Encdec decode reads ``enc_k``/``enc_v`` as
already-projected K/V that the caller fills, as in the reference, whose
launcher stubs them; neither package computes them from an encoder pass.

Decode differs from the reference in one place on purpose: the caches (K/V,
MLA's ``ckv``/``kr``, the hybrid's shared ``sk``/``sv``, the ssm and conv
states) are written in place, and a step at ``len >= max_len`` raises
``CacheFullError`` before any of them is written, where the reference's
``lax.dynamic_update_slice`` (and encdec's position slice) clamps its start
and silently overwrites the last slot (ROADMAP fault C4).  A pure ssm cache
has no length, in either package: it decodes past ``max_len``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceSpec, resolve_device
from .attention import decode_attention, flash_attention, mla_decode_attention, mla_expand
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
def _attn_sublayer(blk: Block, h: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool = True, use_rope: bool = True) -> torch.Tensor:
    """GQA self-attention over a full sequence (the reference's
    ``_attn_sublayer`` without its mesh paths)."""
    S = h.shape[1]
    a = blk.attn
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    if use_rope:
        pos = torch.arange(S, device=h.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal)
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


def _shared_attn_block(shared: Block, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The hybrid's shared block: causal attention with rope, then its MLP."""
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


def forward(model: Transformer, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            enc_inputs: Optional[torch.Tensor] = None,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward of ``tokens`` (B, S); returns logits (B, S, vocab).
    vlm: ``patches`` (B, n_patch, d) take the first ``n_patch`` positions.
    moe: each layer routes all B·S tokens jointly, with the capacity of B·S
    tokens, so a token dropped here may be kept by a decode step.
    encdec: ``enc_inputs`` (B, S_enc, d) are the (stubbed) frontend's frame
    embeddings that the encoder runs over; without them it raises
    ``ValueError``.  ``remat``: recompute each layer's activations in the
    backward pass instead of keeping them."""
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
            remat: bool = True) -> torch.Tensor:
    """The reference's training loss, a 0-d fp32 tensor: the mean over
    every position of the NLL of ``labels`` (B, S) under fp32 logits plus
    the PaLM z-loss ``1e-4 * logsumexp**2``.  The picked logit is a gather
    (the reference's masked sum over the vocabulary adds only zeros beside
    it, so the two are equal)."""
    logits = forward(model, tokens, patches=patches, enc_inputs=enc_inputs,
                     remat=remat).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    zloss = 1e-4 * torch.square(lse)
    return torch.mean(nll + zloss)


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


def _decode_attn(a: Attention, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur: int, posv: torch.Tensor,
                 use_rope: bool = True) -> torch.Tensor:
    """GQA for one token of normed ``x``: its K/V written in place at ``cur``."""
    q = torch.einsum("bsd,dhk->bshk", x, a.wq)
    k = torch.einsum("bsd,dhk->bshk", x, a.wk)
    v = torch.einsum("bsd,dhk->bshk", x, a.wv)
    if cfg.qkv_bias:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    if use_rope:
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


def _decode_mamba(blk: MambaBlock, h: torch.Tensor, cfg: ModelConfig,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor) -> torch.Tensor:
    """One Mamba-2 layer for one token; its states updated in place."""
    y, ss, cs = mamba2_decode(blk.mamba, rms_norm(h, blk.ln, cfg.rms_eps)[:, 0, :], cfg,
                              ssm_state, conv_state)
    ssm_state.copy_(ss)
    conv_state.copy_(cs)
    return h + y[:, None, :]


def _decode_encdec_layer(blk: Block, h: torch.Tensor, cfg: ModelConfig,
                         cache: Dict[str, Any], li: int, cur: int) -> torch.Tensor:
    """One decoder layer for one token: causal self-attention without rope
    (K/V written in place at ``cur``), cross-attention against the layer's
    ``enc_k``/``enc_v`` as they are, then the MLP."""
    posv = torch.full((1,), cur, dtype=torch.int64, device=h.device)
    x = rms_norm(h, blk.ln1, cfg.rms_eps)
    h = h + _decode_attn(blk.attn, x, cfg, cache["k"][li], cache["v"][li], cur, posv,
                         use_rope=False)
    a = blk.xattn
    q = torch.einsum("bsd,dhk->bshk", rms_norm(h, blk.ln_x, cfg.rms_eps), a.wq)
    enc_k = cache["enc_k"][li]
    o = decode_attention(q, enc_k, cache["enc_v"][li], enc_k.shape[1])
    h = h + torch.einsum("bshk,hkd->bsd", o, a.wo)
    return _ffn_sublayer(blk, h, cfg)


def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume one token per sequence (``tokens`` (B,)),
    return logits (B, vocab) and ``cache``, updated in place.  Raises
    ``CacheFullError`` before any state is written when the attention
    caches are full (``cache_position``)."""
    cfg = model.cfg
    cur = cache_position(cfg, cache)
    h = model.embed[tokens][:, None, :]
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        for idx, blk in enumerate(model.blocks):
            h = _decode_mamba(blk, h, cfg, cache["ssm"][idx], cache["conv"][idx])
            if cfg.family == "hybrid" and idx % every == every - 1:
                site = idx // every
                h = decode_layer(model.shared_block, h, cfg,
                                 (cache["sk"][site], cache["sv"][site]), cur)
    elif cfg.family == "encdec":
        # the sinusoidal position at cur (the reference slices its table there)
        h = h + _positions(cur + 1, cfg, h)[cur]
        for li, blk in enumerate(model.blocks):
            h = _decode_encdec_layer(blk, h, cfg, cache, li, cur)
    else:
        for li, blk in enumerate(model.blocks):
            h = decode_layer(blk, h, cfg, layer_caches(cfg, cache, li), cur)
    logits = _head(model, h)[:, 0, :]
    cache["len"] = cur + 1
    return logits, cache
