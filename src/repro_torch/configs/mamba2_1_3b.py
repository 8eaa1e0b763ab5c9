"""mamba2-1.3b [ssm] — SSD, state-space duality [arXiv:2405.21060].

48L (attention-free), d_model=2048, d_inner=4096 (expand 2), head_dim=64
(64 SSD heads), ssm_state=128, conv width 4, vocab=50280.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", arch_type="ssm",
        num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        conv_width=4, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", arch_type="ssm",
        num_layers=2, d_model=128, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=512,
        ssm_state=32, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
        conv_width=4, tie_embeddings=True,
    )
