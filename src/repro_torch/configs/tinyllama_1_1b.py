"""tinyllama-1.1b [dense]: 22L d2048 32H (GQA kv=4) ff5632 V=32000.
[arXiv:2401.02385; hf]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=64, d_ff=5632, vocab_size=32000,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, d_ff=192, vocab_size=512, dtype="float32")
