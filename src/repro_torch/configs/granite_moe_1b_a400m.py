"""granite-moe-1b-a400m [moe] — [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 heads (GQA kv=8), vocab=49155; MoE: 32 routed experts,
top-8, per-expert d_ff=512, no shared experts.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", arch_type="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        num_experts=32, experts_per_token=8, num_shared_experts=0,
        moe_d_ff=512, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, num_shared_experts=0,
        moe_d_ff=128, tie_embeddings=True,
    )
