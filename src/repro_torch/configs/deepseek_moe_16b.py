"""deepseek-moe-16b [moe] — fine-grained MoE [arXiv:2401.06066].

28L, d_model=2048, 16 heads (MHA kv=16), vocab=102400. Layer 0 is a dense
SwiGLU FFN (d_ff=10944); layers 1..27 are MoE: 2 shared + 64 routed experts,
top-6, per-expert d_ff=1408.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", arch_type="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102_400,
        num_experts=64, experts_per_token=6, num_shared_experts=2,
        moe_d_ff=1408, first_dense_layers=1, first_dense_d_ff=10944,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", arch_type="moe",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=128, first_dense_layers=1, first_dense_d_ff=256,
    )
