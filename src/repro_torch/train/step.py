"""The train_step / serve_step / prefill factories that the launcher uses.

Ported from ``src/repro/train/step.py``: gradient accumulation over
microbatches, remat through the model's layers, AdamW.  The reference's
mesh and its int8-compressed gradient all-reduce over the pod axis are
sharding, ROADMAP A14(e): asking for them raises ``NotImplementedError``.

A step is eager torch: the gradients come from ``torch.autograd.grad`` (no
``.grad`` is kept on the parameters), and the model is the ``Transformer``
itself, whose parameters the optimizer updates in place.  With one
microbatch the gradients stay in the parameters' dtype, as
``jax.value_and_grad`` leaves them; with more, they are summed into fp32
accumulators with the loss, then both multiplied by ``1/microbatches``, in
the reference's order.  A parameter the loss does not reach gets a zero
gradient, as in JAX.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import decode_step, forward, loss_fn
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .optimizer import AdamWConfig, adamw_update

Batch = Dict[str, torch.Tensor]


def loss_and_grads(model: Transformer, batch: Batch, remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of ``batch`` (detached) and its gradient by parameter name,
    each in its parameter's dtype (zeros for a parameter the loss does not
    reach); the model's parameters must require gradients."""
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch["tokens"], batch["labels"],
                   patches=batch.get("patches"), enc_inputs=batch.get("enc_inputs"),
                   remat=remat)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, params, grads)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress_pod_grads: bool = False,
                    remat: bool = True) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``batch`` holds ``tokens`` and ``labels`` (B, S) (and
    ``patches`` or ``enc_inputs`` for the vlm and encdec families), B a
    multiple of ``microbatches``; ``metrics`` holds 0-d tensors ``loss``,
    ``grad_norm`` and ``lr``."""
    if mesh is not None or compress_pod_grads:
        raise NotImplementedError(
            "make_train_step: meshes and the compressed pod all-reduce are "
            "sharding, not ported yet (ROADMAP A14(e))")

    def compute_grads(model: Transformer, batch: Batch):
        if microbatches == 1:
            return loss_and_grads(model, batch, remat)
        bs = batch["tokens"].shape[0] // microbatches
        acc_loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in model.named_parameters()}
        for i in range(microbatches):
            loss, g = loss_and_grads(
                model, {k: v[i * bs:(i + 1) * bs] for k, v in batch.items()}, remat)
            for n, a in acc.items():
                a.add_(g[n].float())
            acc_loss = acc_loss + loss
        inv = 1.0 / microbatches
        return acc_loss * inv, {n: a * inv for n, a in acc.items()}

    def train_step(model: Transformer, opt_state, batch: Batch):
        model.requires_grad_(True)
        loss, grads = compute_grads(model, batch)
        _, opt_state, metrics = adamw_update(dict(model.named_parameters()), grads,
                                             opt_state, opt_cfg)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """Returns ``serve_step(model, cache, tokens) -> (logits, cache)``."""
    if mesh is not None:
        raise NotImplementedError("make_serve_step: meshes are ROADMAP A14(e)")

    def serve_step(model: Transformer, cache, tokens: torch.Tensor):
        return decode_step(model, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """Returns ``prefill(model, batch) -> last-position logits``."""
    if mesh is not None:
        raise NotImplementedError("make_prefill_step: meshes are ROADMAP A14(e)")

    def prefill(model: Transformer, batch: Batch) -> torch.Tensor:
        logits = forward(model, batch["tokens"], patches=batch.get("patches"),
                         enc_inputs=batch.get("enc_inputs"), remat=False)
        return logits[:, -1, :]

    return prefill
