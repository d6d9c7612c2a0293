"""granite-34b [dense]: 88L d6144 48H (GQA kv=1, MQA) ff24576 V=49152 — code.
[arXiv:2405.04324; hf]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=3, d_model=128, num_heads=4, num_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512, dtype="float32")
