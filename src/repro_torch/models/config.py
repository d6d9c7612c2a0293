"""Model configuration covering every assigned architecture family.

Copied from ``src/repro/models/config.py``; the JAX dtype property
``jdtype`` becomes ``torch_dtype``.  It imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    qkv_bias: bool = False

    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0      # deepseek: layer 0 is a dense MLP
    dense_d_ff: int = 0              # ... with this hidden size
    norm_topk: bool = True
    capacity_factor: float = 1.25

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / zamba2)
    ssm: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    shared_attn_every: int = 0       # zamba2: shared attn+mlp block cadence

    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0

    # vlm
    vision_patches: int = 0          # internvl: leading patch-embedding slots

    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # -- derived --------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # lm head
        def attn_params():
            if self.mla:
                a = d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)  # W_q
                a += d * (self.kv_lora_rank + self.qk_rope_dim)                 # W_dkv+rope
                a += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                a += self.num_heads * self.v_head_dim * d                        # W_o
                return a
            a = d * self.num_heads * self.hdim          # q
            a += 2 * d * self.kv_heads * self.hdim      # k, v
            a += self.num_heads * self.hdim * d         # o
            if self.qkv_bias:
                a += (self.num_heads + 2 * self.kv_heads) * self.hdim
            return a
        def mlp_params(ff):
            return 3 * d * ff
        def moe_params():
            m = d * self.num_experts  # router
            m += self.num_experts * mlp_params(self.moe_d_ff) // 1
            m += self.num_shared_experts * mlp_params(self.moe_d_ff)
            return m
        def ssm_params():
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            p = d * (2 * di + 2 * ns + nh)   # in_proj (x, z, B, C, dt)
            p += self.ssm_conv * (di + 2 * ns)
            p += nh * 3                       # A, D, dt_bias
            p += di * d                       # out_proj
            return p
        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params()
        elif self.family == "hybrid":
            per_layer = ssm_params()
            n += attn_params() + mlp_params(self.d_ff)  # one shared block
        elif self.moe:
            dense = self.first_dense_layers
            n += dense * (attn_params() + mlp_params(self.dense_d_ff or self.d_ff))
            per_layer = attn_params() + moe_params()
            L = L - dense
        else:
            per_layer = attn_params() + mlp_params(self.d_ff)
        n += L * per_layer
        if self.encdec:
            # encoder layers: self-attn + mlp; decoder counted above, add cross.
            n += self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            n += self.num_layers * attn_params()  # cross-attention
        n += 2 * self.num_layers * d  # norms (approx; + final)
        return int(n)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed-in experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        unused = (self.num_experts - self.experts_per_token) * 3 * self.d_model * self.moe_d_ff
        return int(full - (self.num_layers - self.first_dense_layers) * unused)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic path; see DESIGN.md).
LONG_CONTEXT_OK = {"mamba2-1.3b", "zamba2-1.2b"}
