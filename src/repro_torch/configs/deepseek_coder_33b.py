"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196].

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256, head_dim=128.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", arch_type="dense",
        num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=19200, vocab_size=32256, head_dim=128,
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
    )
