"""llama3.2-1b [dense]: 16L d2048 32H (GQA kv=8) ff8192 V=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
        head_dim=64, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, d_ff=256, vocab_size=512, dtype="float32")
