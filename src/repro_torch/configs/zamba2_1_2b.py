"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d2048, ssm_state=64, plus a SHARED
attention+MLP block (32H MHA kv=32, ff 8192) applied every 6th layer.
[arXiv:2411.15242; hf]  Simplification noted in DESIGN.md: per-invocation
LoRA deltas on the shared block are omitted.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", ssm=True,
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=6, d_model=128, num_heads=4, num_kv_heads=4,
                          head_dim=32, d_ff=256, vocab_size=512, ssm_state=16,
                          ssm_headdim=32, shared_attn_every=3, dtype="float32")
