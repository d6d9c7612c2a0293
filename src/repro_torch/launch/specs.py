"""Storage-free stand-ins for every (arch x shape) cell: the dry run's
inputs.

Ported from ``src/repro/launch/specs.py``, whose ``ShapeDtypeStruct``s
become tensors of ``FakeTensorMode`` (shape, dtype and device, no
storage): call these inside the mode.  The parameters are the
``Transformer`` itself, uninitialised (``init_params`` with no storage),
the AdamW state ``adamw_init``'s, the batch and the serving cache at full
context length those the step functions take.

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings (B, S, d); internvl gets its patch embeddings
in the first sequence positions.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import Transformer, init_cache
from ..train.optimizer import adamw_init


def batch_specs_fake(cfg: ModelConfig, shape: ShapeConfig, device="cpu") -> Dict[str, Any]:
    """Inputs for train/prefill cells."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=device)}
    if shape.is_train:
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=device)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((B, cfg.vision_patches, cfg.d_model),
                                       dtype=cfg.torch_dtype, device=device)
    if cfg.encdec:
        batch["enc_inputs"] = torch.empty((B, S, cfg.d_model), dtype=cfg.torch_dtype,
                                          device=device)
    return batch


def params_fake(cfg: ModelConfig, device="cpu") -> Transformer:
    return Transformer(cfg, device=device)


def cache_fake(cfg: ModelConfig, shape: ShapeConfig, device="cpu") -> Dict[str, Any]:
    """Serving cache at full context length (decode cells)."""
    B, S = shape.global_batch, shape.seq_len
    return init_cache(cfg, B, S, enc_len=S if cfg.encdec else 0, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu") -> Dict[str, Any]:
    """Everything the cell's step function consumes: ``params`` (the
    model), and ``opt_state`` and ``batch`` (train), ``batch`` (prefill),
    or ``cache`` and ``tokens`` (decode)."""
    params = params_fake(cfg, device)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": adamw_init(dict(params.named_parameters())),
                "batch": batch_specs_fake(cfg, shape, device)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs_fake(cfg, shape, device)}
    return {"params": params, "cache": cache_fake(cfg, shape, device),
            "tokens": torch.empty((shape.global_batch,), dtype=torch.int32, device=device)}
