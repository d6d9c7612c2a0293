"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) V=151936,
MoE 128 experts top-8, per-expert ff 768, norm_topk.
[hf:Qwen/Qwen3-30B-A3B]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", moe=True,
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        num_experts=128, experts_per_token=8, moe_d_ff=768,
        norm_topk=True, rope_theta=1000000.0,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, vocab_size=512, num_experts=8,
                          experts_per_token=2, moe_d_ff=96, d_ff=96, dtype="float32")
