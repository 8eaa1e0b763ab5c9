"""deepseek-v2-lite [moe] — multi-head latent attention with YaRN over
deepseek-moe's experts [arXiv:2405.04434; huggingface.co/deepseek-ai/
DeepSeek-V2-Lite config.json].

27L, d_model=2048, 16 heads, vocab=102400, untied. Attention is MLA with
no query compression: q heads of 128 + 64 (rotated), a 512-wide latent
c_kv and one shared 64-wide k_pe, K/V heads of 128 + 64 and 128 expanded
from the latent. YaRN: rope_theta 10000, factor 40 over an original 4096
positions, beta 32 / 1, mscale and mscale_all_dim 0.707. Layer 0 is a
dense SwiGLU FFN (d_ff=10944); layers 1..26 are MoE: 2 shared + 64 routed
experts, top-6, per-expert d_ff=1408. A port-only config: the JAX package
has no latent attention, so it stays out of ``ARCHS``.
"""
from repro_torch.models.common import MLAConfig

_YARN = dict(rope_theta=10_000.0, yarn_factor=40.0,
             yarn_original_max_positions=4096, yarn_beta_fast=32.0,
             yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


def config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite", arch_type="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102_400,
        num_experts=64, experts_per_token=6, num_shared_experts=2,
        moe_d_ff=1408, first_dense_layers=1, first_dense_d_ff=10944,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, **_YARN,
    )


def smoke_config() -> MLAConfig:
    """Three layers (one dense), YaRN over an original 64 positions, so a
    256-token prompt runs past it; q/k 32 + 16 wide, v 32, a 64-wide
    latent."""
    return MLAConfig(
        name="deepseek-v2-lite-smoke", arch_type="moe",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=128, first_dense_layers=1, first_dense_d_ff=256,
        kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, **{**_YARN, "yarn_original_max_positions": 64},
    )
