"""The train_step / serve_step / prefill factories that the launcher uses.

Ported from ``src/repro/train/step.py``: gradient accumulation over
microbatches, remat through the model's layers, AdamW, and, given a mesh
(a ``DeviceMesh`` with named dims, the model's parameters DTensors from
``distributed.sharding.shard_params``, the batch DTensors in
``batch_specs``' layout), the sharded step with the optional
int8-compressed gradient all-reduce over the pod axis.

A step is eager torch: the gradients come from ``torch.autograd.grad`` (no
``.grad`` is kept on the parameters), and the model is the ``Transformer``
itself, whose parameters the optimizer updates in place.  With one
microbatch the gradients stay in the parameters' dtype, as
``jax.value_and_grad`` leaves them; with more, they are summed into fp32
accumulators with the loss, then both multiplied by ``1/microbatches``, in
the reference's order.  A parameter the loss does not reach gets a zero
gradient, as in JAX.

On a mesh the gradients are DTensors in their parameters' placements (the
backward of the FSDP gathers reduce-scatters them) and AdamW runs on each
rank's shards.  Microbatch i is rows ``i*bs .. (i+1)*bs`` of the global
batch, as the reference's reshape takes them, laid out over the batch axes
again (so the moe layers' capacity groups are the reference's).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..distributed import spmd
from ..distributed.compression import make_pod_grad_allreduce
from ..models import decode_step, forward, loss_fn
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .optimizer import AdamWConfig, adamw_update

Batch = Dict[str, torch.Tensor]


def _like(g, p):
    """A gradient in its parameter's placements (a DTensor's may come back
    ``Partial`` or otherwise laid out)."""
    if g is None:
        return torch.zeros_like(p)
    if hasattr(p, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(model: Transformer, batch: Batch, remat: bool = True, mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of ``batch`` (detached) and its gradient by parameter name,
    each in its parameter's dtype (zeros for a parameter the loss does not
    reach); the model's parameters must require gradients."""
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch["tokens"], batch["labels"],
                   patches=batch.get("patches"), enc_inputs=batch.get("enc_inputs"),
                   remat=remat, mesh=mesh)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {n: _like(g, p) for n, p, g in zip(names, params, grads)}


def _microbatches(batch: Batch, n: int, mesh):
    """The reference's split of ``batch`` into ``n`` microbatches: number i
    holds rows ``i*bs .. (i+1)*bs`` of the global batch.  On a mesh the
    batch's tensors are gathered whole once (token ids and stubbed frontend
    inputs: small beside a step) and each microbatch is laid out over the
    batch axes where ``bs`` divides them, as ``batch_specs`` lays out a
    batch of ``bs``."""
    bs = batch["tokens"].shape[0] // n
    if mesh is None:
        return [{k: v[i * bs:(i + 1) * bs] for k, v in batch.items()} for i in range(n)]
    from torch.distributed.tensor import DTensor

    whole = {k: spmd.constrain(v, mesh, (None,) * v.ndim).to_local() for k, v in batch.items()}
    rows = spmd.bspec(mesh, bs)

    def part(t, i):
        rep = DTensor.from_local(t[i * bs:(i + 1) * bs], mesh,
                                 spmd.pl(mesh, (None,) * t.ndim), run_check=False)
        return spmd.constrain(rep, mesh, (rows,) + (None,) * (t.ndim - 1))
    return [{k: part(t, i) for k, t in whole.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress_pod_grads: bool = False,
                    remat: bool = True) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``batch`` holds ``tokens`` and ``labels`` (B, S) (and
    ``patches`` or ``enc_inputs`` for the vlm and encdec families), B a
    multiple of ``microbatches``; ``metrics`` holds 0-d tensors ``loss``,
    ``grad_norm`` and ``lr``.  With ``mesh``, the model and the batch are
    DTensors on it, and ``compress_pod_grads`` reduces the gradients over
    its ``pod`` axis by the int8 all-reduce before AdamW."""
    pod_reduce = (make_pod_grad_allreduce(mesh)
                  if (compress_pod_grads and mesh is not None) else None)

    def compute_grads(model: Transformer, batch: Batch):
        if microbatches == 1:
            return loss_and_grads(model, batch, remat, mesh)
        acc_loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in model.named_parameters()}
        for mb in _microbatches(batch, microbatches, mesh):
            loss, g = loss_and_grads(model, mb, remat, mesh)
            for n, a in acc.items():
                a.add_(g[n].float())
            acc_loss = acc_loss + loss
        inv = 1.0 / microbatches
        return acc_loss * inv, {n: a * inv for n, a in acc.items()}

    def train_step(model: Transformer, opt_state, batch: Batch):
        model.requires_grad_(True)
        loss, grads = compute_grads(model, batch)
        if pod_reduce is not None:
            grads = pod_reduce(grads)
        _, opt_state, metrics = adamw_update(dict(model.named_parameters()), grads,
                                             opt_state, opt_cfg)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """Returns ``serve_step(model, cache, tokens) -> (logits, cache)``; with
    ``mesh``, the model, the cache and the tokens DTensors on it."""
    def serve_step(model: Transformer, cache, tokens: torch.Tensor):
        return decode_step(model, cache, tokens, mesh=mesh)

    return serve_step


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """Returns ``prefill(model, batch) -> last-position logits``; with
    ``mesh``, the model and the batch DTensors on it (the logits too)."""
    def prefill(model: Transformer, batch: Batch) -> torch.Tensor:
        logits = forward(model, batch["tokens"], patches=batch.get("patches"),
                         enc_inputs=batch.get("enc_inputs"), remat=False, mesh=mesh)
        if mesh is None:
            return logits[:, -1, :]
        spec = spmd.spec_of(logits)
        return spmd.spmd(lambda l_l: l_l[:, -1, :], mesh, (logits,), [spec], [()],
                         (spec[0], spec[2]))

    return prefill
