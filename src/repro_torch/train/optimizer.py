"""AdamW written directly in torch (no ``torch.optim``), on a mapping of
parameter name -> tensor; the moments mirror the parameters.

Ported from ``src/repro/train/optimizer.py``, with its arithmetic in its
order: the schedule and the bias corrections are fp32 tensors computed on the
device (not Python floats), the moments are fp32, the gradient is cast to
fp32 and scaled by the clip factor, and the update is cast back to the
parameter's dtype.  Parameters and moments are updated in place.

One difference on purpose (ROADMAP fault C7): the reference decays
"matrices only" by ``p.ndim >= 2``, which sees the layer axis that its
``lax.scan`` stack adds, so every stacked 1-D leaf (a block's ``ln1``/
``ln2``, Mamba's ``ln``, ``norm``, ``conv_b``, ``a_log``, ``d_skip``,
``dt_bias``) is decayed while the unstacked ``final_norm`` is not.  Here each
parameter is one layer's, so ``p.ndim >= 2`` means what the comment says.

DTensor parameters (a mesh's, ``distributed.sharding.shard_params``) keep
DTensor moments in their placements; the global norm is the DTensors' own
(summed over the shards), and the update runs on each rank's local shards,
elementwise as on one device.  A DTensor's ``ndim`` is its global rank, the
rank of one layer's tensor, so C7's rule holds there too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr(step)``: linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_ratio * peak_lr``; ``step`` is an integer tensor, the result an
    fp32 tensor on its device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.peak_lr * (cfg.min_lr_ratio
                             + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """``mu`` and ``nu`` (fp32 zeros beside each parameter, keyed by its
    name) and ``step``, an int32 0-d tensor on the parameters' device."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) if hasattr(p, "placements")
             else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    device = next(iter(params.values())).device
    return {"mu": zeros, "nu": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """The fp32 L2 norm of all ``tensors`` together (a plain 0-d tensor,
    also of DTensors)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))
    return norm.full_tensor() if hasattr(norm, "full_tensor") else norm


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: Dict[str, object], cfg: AdamWConfig
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object], Dict[str, torch.Tensor]]:
    """One step: ``params`` and ``state``'s moments updated in place and
    returned with the new ``step``, and the metrics ``grad_norm`` and ``lr``
    (0-d fp32 tensors).  ``grads`` maps the same names, in any dtype."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for k, p_full in params.items():
        p = _local(p_full)
        g = _local(grads[k]).float() * scale
        mu, nu = _local(state["mu"][k]), _local(state["nu"][k])
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only (per layer: C7)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
