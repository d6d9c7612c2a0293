"""Mamba-2 (SSD, state-space duality) block: the chunked matmul-form scan and
the O(1) recurrent decode.

Ported from ``src/repro/models/ssm.py``.  As there, no kernel is used: the
scan is plain torch ops, fp32 inside, its chunks relayed by a Python loop
(the reference's ``lax.scan``).  The sequence is cut into chunks of Q
tokens; within a chunk the (Q x Q) semiseparable products are batched
matmuls, and the (headdim x state) chunk state is carried across chunks.
Decode updates the (heads, headdim, state) state one token at a time.

Each path keeps the reference's dtype flow as written: the forward's conv
returns the input dtype and adds its bias and ``silu`` there, while the
decode's conv is fp32 and is cast after ``silu``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import rms_norm


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv, summed in fp32 tap by
    tap in the reference's order (``w[0]`` multiplies the current sample),
    cast back to ``x``'s dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S, :].float() * w[K - 1 - i].float()
    return out.to(x.dtype)


def ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H), post-softplus
    A: torch.Tensor,     # (H,), negative
    Bm: torch.Tensor,    # (B, S, N) (one group, broadcast over heads)
    Cm: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,     # (H,)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in ``x``'s dtype, final_state (B, H, P, N)
    fp32).  The sequence is padded to a multiple of Q = min(chunk, S) with
    dt = 0, so padded steps leave the state as it was."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()
    Af = A.float()
    Df = D[None, None, :, None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, :, :, None]
    trif = tri.float()

    state = (init_state.float() if init_state is not None
             else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtq * Af[None, None, :]                       # (B,Q,H)
        cs = torch.cumsum(dA, dim=1)                       # (B,Q,H) inclusive
        total = cs[:, -1, :]                               # (B,H)
        # intra-chunk: L[i,j] = exp(cs_i - cs_j) for i >= j (B,Qi,Qj,H).
        # Masked BEFORE the exp, as the reference does: for i < j the
        # exponent is positive and large.
        seg = cs[:, :, None, :] - cs[:, None, :, :]
        Lmat = torch.exp(torch.where(tri, seg, -60.0)) * trif
        scores = torch.einsum("bin,bjn->bij", cq, bq)      # (B,Qi,Qj)
        W = scores[:, :, :, None] * Lmat * dtq[:, None, :, :]
        y_diag = torch.einsum("bijh,bjhp->bihp", W, xq)
        # inter-chunk: the carried state's contribution
        y_off = torch.einsum("bin,bhpn->bihp", cq, state) * torch.exp(cs)[..., None]
        # the new chunk state
        decay_to_end = torch.exp(total[:, None, :] - cs)   # (B,Q,H)
        Sc = torch.einsum("bjn,bjh,bjhp->bhpn", bq, dtq * decay_to_end, xq)
        state = state * torch.exp(total)[:, :, None, None] + Sc
        ys.append(y_diag + y_off + xq * Df)
    y = torch.stack(ys, dim=1).reshape(Bsz, S + pad, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) fp32
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, N)
    Cm: torch.Tensor,     # (B, N)
    D: torch.Tensor,      # (H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(1) recurrent update; returns (y (B, H, P) in ``x``'s dtype,
    the new state)."""
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A[None, :])                              # (B,H)
    dBx = torch.einsum("bn,bhp->bhpn", Bm.float(), dtf[..., None] * xf)
    state_new = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state_new, Cm.float())
    y = y + xf * D[None, :, None]
    return y.to(x.dtype), state_new


def _split_in_proj(zxbcdt: torch.Tensor, cfg):
    """z, xs, B, C, dt: the reference's split of the input projection."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


def mamba2_forward(
    p,                       # a ``Mamba`` module (or anything with its weights)
    x: torch.Tensor,         # (B, S, d)
    cfg,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer over a sequence; returns (out (B, S, d), the final
    ssm state (B, H, P, N) fp32).  The reference also takes a
    ``conv_state``, which it ignores and no caller passes: it is left out."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xs, B_, C_, dt = _split_in_proj(x @ p.in_proj, cfg)
    conv_in = torch.cat([xs, B_, C_], dim=-1)                    # (B,S,di+2N)
    conv = F.silu(_depthwise_causal_conv(conv_in, p.conv_w) + p.conv_b)
    xs, B_, C_ = torch.split(conv, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.a_log.float())
    Bsz, S = x.shape[0], x.shape[1]
    y, state = ssd_chunked(xs.reshape(Bsz, S, H, P), dt, A, B_, C_, p.d_skip,
                           cfg.ssm_chunk, init_state)
    y = y.reshape(Bsz, S, di) * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    return y @ p.out_proj, state


def mamba2_decode(
    p,
    x: torch.Tensor,            # (B, d), one token
    cfg,
    ssm_state: torch.Tensor,    # (B, H, P, N)
    conv_state: torch.Tensor,   # (B, K-1, di+2N), the past conv inputs, oldest first
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token; returns (out (B, d), ssm_state', conv_state')."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xs, B_, C_, dt = _split_in_proj(x @ p.in_proj, cfg)
    conv_in = torch.cat([xs, B_, C_], dim=-1)                    # (B, di+2N)
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B, K, .)
    # The taps mirror _depthwise_causal_conv: w[0] multiplies the CURRENT
    # sample, w[K-1] the oldest; the window is oldest-first, so flip.
    conv = torch.einsum("bkc,kc->bc", window.float(),
                        torch.flip(p.conv_w, (0,)).float()) + p.conv_b
    conv = F.silu(conv).to(x.dtype)
    xs, B_, C_ = torch.split(conv, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.a_log.float())
    y, ssm_state = ssd_decode_step(ssm_state, xs.reshape(-1, H, P), dt, A, B_, C_,
                                   p.d_skip)
    y = y.reshape(-1, di) * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    return y @ p.out_proj, ssm_state, window[:, 1:, :]
