"""internvl2-76b [vlm]: LM backbone = 80L d8192 64H (GQA kv=8) ff28672
V=128256 (InternLM2/llama-arch); InternViT frontend STUBBED — input_specs
supplies 256 patch embeddings that occupy the first sequence slots.
[arXiv:2404.16821; unverified]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256, vision_patches=256,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, d_ff=256, vocab_size=512,
                          vision_patches=8, dtype="float32")
