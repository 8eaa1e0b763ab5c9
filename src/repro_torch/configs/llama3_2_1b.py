"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256, head_dim=64,
rope theta 500k, tied embeddings.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", arch_type="dense",
        num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, head_dim=64,
        rope_theta=500_000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        rope_theta=500_000.0, tie_embeddings=True,
    )
