"""mamba2-1.3b [ssm]: 48L d2048 attn-free, ssm_state=128, headdim 64,
expand 2, conv 4 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", ssm=True,
        num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=3, d_model=128, vocab_size=512,
                          ssm_state=16, ssm_headdim=32, dtype="float32")
