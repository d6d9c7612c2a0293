"""Attention: chunked-flash (online softmax) for prefill, plain masked
attention for single-token decode, GQA throughout, and MLA (DeepSeek-V2)
with weight-absorbed decode against the compressed KV cache.

Ported from ``src/repro/models/attention.py``.  As there, no flash kernel is
used: the chunk loop is plain torch ops, the scores and the softmax state are
fp32, masked scores take ``NEG_INF = -1e30`` (not ``-inf``), the last chunk is
padded and masked by ``kv_pos < Skv``, and the output is ``o / max(l, 1e-30)``.
The reference also wraps the chunk body in ``jax.checkpoint``; here the only
recompute is ``forward(remat=True)``'s, a layer at a time, so a layer's
backward holds every chunk's fp32 scores (O(S^2) a layer, not O(S·chunk)).
All of it differentiates as written: training runs it under autograd,
serving under ``torch.inference_mode()``.

``mla_decode_attention`` masks a ``(B,)`` ``cur_len`` per row, as
``decode_attention`` does.  The reference's builds a ``(1, L)`` mask from
it, comparing position j with ``cur_len[j]`` (ROADMAP fault C5); its
decode step passes a scalar and never meets this.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D): q head h reads kv head h // groups."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, looping over KV chunks.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, Dk/Dv); returns (B, Sq, Hq, Dv).
    ``q_offset``: absolute position of q[0] (prefill-with-cache / decode).
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    k = repeat_kv(k, G)
    v = repeat_kv(v, G)
    Dv = v.shape[-1]
    s = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    qf = q.float()
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        k_i = k[:, c * chunk:(c + 1) * chunk]
        v_i = v[:, c * chunk:(c + 1) * chunk]
        scores = torch.einsum("bshd,bchd->bhsc", qf, k_i.float()) * s   # (B,Hq,Sq,C)
        kv_pos = c * chunk + torch.arange(chunk, device=dev)
        mask = (kv_pos < Skv)[None, None, None, :]
        if causal:
            mask = mask & (kv_pos[None, None, None, :] <= q_pos[None, :, None])
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhsc,bchd->bhsd", p, v_i.float())
        o = o * alpha[..., None] + pv
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.transpose(1, 2).to(q.dtype)                          # (B,Sq,Hq,Dv)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: Union[int, torch.Tensor],
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, Hq, D); k/v_cache: (B, L, Hkv, D); cur_len: an int, a 0-d or a
    (B,) tensor of valid lengths (the new token's K/V must already be written
    at cur_len-1).
    """
    B, L = k_cache.shape[0], k_cache.shape[1]
    Hq, D = q.shape[2], q.shape[-1]
    G = Hq // k_cache.shape[2]
    s = scale if scale is not None else D ** -0.5
    k_r = repeat_kv(k_cache, G)
    v_r = repeat_kv(v_cache, G)
    scores = torch.einsum("bshd,bchd->bhsc", q.float(), k_r.float()) * s  # (B,Hq,1,L)
    scores = torch.where(_length_mask(cur_len, B, L, q.device)[:, None, None, :],
                         scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhsc,bchd->bhsd", p, v_r.float())
    return o.transpose(1, 2).to(q.dtype)                          # (B,1,Hq,Dv)


def _length_mask(cur_len: Union[int, torch.Tensor], B: int, L: int,
                 device: torch.device) -> torch.Tensor:
    """(B, L): position j of row b is valid where j < cur_len (or cur_len[b])."""
    pos = torch.arange(L, device=device)
    if isinstance(cur_len, int) or cur_len.ndim == 0:
        return (pos[None, :] < cur_len).expand(B, L)
    return pos[None, :] < cur_len[:, None]


# -- MLA (DeepSeek-V2) ----------------------------------------------------------
def mla_expand(attn, c_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand the compressed cache (B, S, r) to per-head K_nope (B, S, H, dn)
    and V (B, S, H, dv) (the prefill path).  ``attn`` holds ``w_uk``
    (r, H, dn) and ``w_uv`` (r, H, dv)."""
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, attn.w_uk)
    v = torch.einsum("bsr,rhd->bshd", c_kv, attn.w_uv)
    return k_nope, v


def mla_decode_attention(
    attn,
    q_nope: torch.Tensor,       # (B,1,H,dn)
    q_rope: torch.Tensor,       # (B,1,H,dr), rope already applied
    ckv_cache: torch.Tensor,    # (B,L,r)
    krope_cache: torch.Tensor,  # (B,L,dr), rope already applied
    cur_len: Union[int, torch.Tensor],
    cfg,
) -> torch.Tensor:
    """Weight-absorbed MLA decode: attends in the compressed (rank-r) space,
    so the per-token cache is r + dr values, not H·(dn+dv).  ``cur_len``: an
    int, a 0-d or a (B,) tensor of valid lengths.  Returns the per-head
    context (B,1,H,dv) in ``q_nope``'s dtype."""
    # absorb W_uk into q: q_eff (B,1,H,r)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.float(), attn.w_uk.float())
    s = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bshr,blr->bhsl", q_eff, ckv_cache.float())
              + torch.einsum("bshd,bld->bhsl", q_rope.float(), krope_cache.float())) * s
    B, L = ckv_cache.shape[0], ckv_cache.shape[1]
    scores = torch.where(_length_mask(cur_len, B, L, q_nope.device)[:, None, None, :],
                         scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    ctx_r = torch.einsum("bhsl,blr->bshr", p, ckv_cache.float())       # (B,1,H,r)
    # absorb W_uv on the way out: (B,1,H,dv)
    ctx = torch.einsum("bshr,rhd->bshd", ctx_r, attn.w_uv.float())
    return ctx.to(q_nope.dtype)
