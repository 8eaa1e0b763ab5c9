"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652].

48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000, head_dim=128.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", arch_type="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, head_dim=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
        d_ff=512, vocab_size=512, head_dim=64,
    )
