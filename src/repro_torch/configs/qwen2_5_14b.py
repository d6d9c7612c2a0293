"""qwen2.5-14b [dense]: 48L d5120 40H (GQA kv=8) ff13824 V=152064, QKV bias.
[hf:Qwen/Qwen2.5-14B; hf]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=13824, vocab_size=152064, qkv_bias=True,
        rope_theta=1000000.0,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, d_model=160, num_heads=4, num_kv_heads=2,
                          head_dim=40, d_ff=288, vocab_size=512, dtype="float32")
