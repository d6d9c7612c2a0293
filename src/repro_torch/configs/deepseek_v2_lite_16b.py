"""deepseek-v2-lite-16b [moe]: 27L d2048 16H V=102400, MLA kv_lora=512
(qk_nope 128, qk_rope 64, v_head 128), 64 routed experts top-6 + 2 shared,
per-expert ff 1408, first layer dense (ff 10944).
[arXiv:2405.04434; hf]  Note: assignment line says "GQA kv=16" — MLA makes
kv_heads == num_heads structurally; we implement true MLA per the paper.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", moe=True, mla=True,
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
        num_shared_experts=2, first_dense_layers=1, dense_d_ff=10944,
        norm_topk=False,
    )


def reduced_config() -> ModelConfig:
    return config().with_(num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
                          vocab_size=512, kv_lora_rank=32, qk_nope_dim=16,
                          qk_rope_dim=8, v_head_dim=16, num_experts=8,
                          experts_per_token=2, moe_d_ff=64, d_ff=64,
                          dense_d_ff=96, dtype="float32")
