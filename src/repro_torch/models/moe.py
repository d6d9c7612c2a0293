"""Mixture-of-Experts layer with capacity-based top-k routing.

Ported from ``src/repro/models/moe.py``.  Dispatch is top-C-per-expert over
the (E, T) routing matrix, as there: each expert takes at most C tokens,
gathered into an (E, C, d) stack, and the dropped tokens (beyond capacity)
fall through with the residual connection.  The expert SwiGLU runs as
batched products over that stack.

Three things are the port's own:

* the reference's two ``lax.top_k`` selections break ties toward the lower
  index; ``torch.topk`` does not promise that order, so both selections are
  a stable descending sort (``_top``).  Tokens with equal hidden states tie
  in the capacity selection, and which of them is dropped decides the output;
* the combine adds each token's expert outputs in the reference's update
  order (expert ascending, then slot) in the activations' dtype, with no
  atomics, so it gives the same bits on every run on the card (``_combine``);
  the tokens' gather into the (E, C, d) stack is ``F.embedding``, whose
  backward adds a token's rows in a fixed order too (indexing's accumulates
  in thread order on the CPU);
* with expert parallelism (``axis``, the ``model`` process group, and
  ``axis_size`` > 1; the reference's ``all_to_all`` path) the exchanges are
  ``all_to_all_single_autograd`` of the functional collectives, so the
  path trains as well as it serves.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed.spmd import all_to_all


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """(B,S,d) x (d,E) -> (T,E) float32 softmax probabilities."""
    t = x.reshape(-1, x.shape[-1])
    return torch.softmax(t.float() @ w_router.float(), dim=-1)


def load_balance_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    counts = torch.bincount(topk_idx.reshape(-1), minlength=num_experts).float()
    f = counts / max(topk_idx.numel(), 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row of ``x`` and their indices, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tokens: int) -> int:
    """C, the tokens one expert takes: the reference's formula."""
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts) + 1
    return min(max(4, c), tokens)


class Routing(NamedTuple):
    """One layer's routing of T tokens: ``probs`` (T, E) fp32, ``topk_idx``
    (T, k), and per expert the ``gate_w``, ``tok_idx`` and ``valid`` of its C
    slots (E, C)."""

    probs: torch.Tensor
    topk_idx: torch.Tensor
    gate_w: torch.Tensor
    tok_idx: torch.Tensor
    valid: torch.Tensor


def route(router: torch.Tensor, tokens: torch.Tensor, cfg) -> Routing:
    """Top-k experts per token, then top-C tokens per expert.  tokens: (T, d)."""
    T = tokens.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = router_probs(tokens, router)                                # (T, E)
    topk_p, topk_idx = _top(probs, k)                                   # (T, k)
    if cfg.norm_topk:
        topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    # (E, T) routing matrix: weight if token routed to e else -1.
    routed = torch.full((T, E), -1.0, dtype=torch.float32, device=tokens.device)
    routing = routed.scatter(1, topk_idx, topk_p).T
    gate_w, tok_idx = _top(routing, capacity(cfg, T))                  # (E, C)
    valid = gate_w > 0.0
    gate_w = torch.where(valid, gate_w, 0.0)
    return Routing(probs, topk_idx, gate_w, tok_idx, valid)


def _combine(updates: torch.Tensor, r: Routing, T: int, k: int) -> torch.Tensor:
    """sum over (e, c) with tok_idx[e, c] = t of updates[e, c], for every
    token t, added in (e, c) order in ``updates``' dtype.

    A token is in at most k valid slots (one per chosen expert), so a stable
    sort of the valid slots by token (the others sort past the end, to row
    T) gives each token its contributions in the reference's order; each is
    written to its own (token, rank) cell, and the k cells are added left
    to right.  The writes never collide, so nothing depends on thread
    order."""
    E, C, d = updates.shape
    key = torch.where(r.valid, r.tok_idx, T).reshape(-1)
    key, order = torch.sort(key, stable=True)
    first = torch.searchsorted(key, key)                 # first slot of the token
    rank = torch.arange(E * C, device=key.device) - first
    rank = torch.where(key < T, rank, 0)
    cells = updates.new_zeros((T + 1, k, d))
    cells[key, rank] = updates.reshape(E * C, d)[order]
    out = cells[:T, 0]
    for j in range(1, k):
        out = out + cells[:T, j]
    return out


def moe_ffn(moe, x: torch.Tensor, cfg, *, axis=None, axis_size: int = 1) -> torch.Tensor:
    """Top-k routed expert FFN of ``x`` (B, S, d), the tokens of this rank.
    ``moe`` holds ``router`` (d, E), ``experts`` with ``w_gate``/``w_up``
    (E_local, d, f) and ``w_down`` (E_local, f, d), and ``shared``
    (``w_gate``/``w_up``/``w_down``) when the config has shared experts.
    With ``axis`` (a process group of ``axis_size`` > 1 ranks) the experts
    are split over its ranks, E_local = E / axis_size on each, and the
    (E, C, d) buckets go to the experts' ranks and back by two all_to_alls
    (the standard EP schedule); C comes from this rank's token count."""
    B, S, d = x.shape
    tokens = x.reshape(-1, d)
    T = tokens.shape[0]
    r = route(moe.router, tokens, cfg)
    # the gather as F.embedding: its backward is deterministic (see _combine)
    xe = F.embedding(r.tok_idx, tokens) * r.valid[..., None].to(tokens.dtype)  # (E, C, d)
    E, C = xe.shape[0], xe.shape[1]
    ep = axis is not None and axis_size > 1
    if ep:
        M = axis_size
        # (E, C, d) -> (M, ep, C, d) -> exchange shard <-> expert group; then
        # dim 0 is the source rank, merged into the capacity.
        xe = all_to_all(xe.reshape(M, E // M, C, d), axis)
        xe = xe.transpose(0, 1).reshape(E // M, M * C, d)
    ex = moe.experts
    h = F.silu(torch.bmm(xe, ex.w_gate)) * torch.bmm(xe, ex.w_up)
    ye = torch.bmm(h, ex.w_down)                                       # (E, C, d)
    if ep:
        ye = all_to_all(ye.reshape(E // M, M, C, d).transpose(0, 1), axis)
        ye = ye.reshape(E, C, d)
    out = _combine(ye * r.gate_w[..., None].to(ye.dtype), r, T, cfg.experts_per_token)
    if cfg.num_shared_experts:
        ws = moe.shared
        hs = F.silu(tokens @ ws.w_gate) * (tokens @ ws.w_up)
        out = out + hs @ ws.w_down
    return out.reshape(B, S, d).to(x.dtype)
