"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M family].

32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152, head_dim=64.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", arch_type="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        d_ff=2560, vocab_size=49152, head_dim=64,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", arch_type="dense",
        num_layers=2, d_model=192, num_heads=3, num_kv_heads=1,
        d_ff=512, vocab_size=512, head_dim=64, tie_embeddings=True,
    )
