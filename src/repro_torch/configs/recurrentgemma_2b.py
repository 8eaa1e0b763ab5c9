"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

26 layers in a (rglru, rglru, attn) repeating pattern (8 full repeats + 2
trailing rglru), d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680,
lru_width=2560, local-attention window 2048, vocab=256000.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", arch_type="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        block_pattern=("rglru", "rglru", "attn"),
        pattern_tail=("rglru", "rglru"),
        lru_width=2560, window=2048, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", arch_type="hybrid",
        num_layers=5, d_model=256, num_heads=2, num_kv_heads=1,
        head_dim=128, d_ff=512, vocab_size=512,
        block_pattern=("rglru", "rglru", "attn"),
        pattern_tail=("rglru", "rglru"),
        lru_width=256, window=64, tie_embeddings=True,
    )
