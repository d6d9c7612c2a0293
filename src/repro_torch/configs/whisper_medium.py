"""whisper-medium [audio, enc-dec]: 24L enc + 24L dec, d1024 16H MHA ff4096
V=51865; conv frontend STUBBED — input_specs supplies precomputed frame
embeddings (B, S_enc, d). [arXiv:2212.04356; unverified]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec", encdec=True,
        num_layers=24, enc_layers=24, d_model=1024, num_heads=16,
        num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=2, enc_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
                          dtype="float32")
