"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064,
head_dim=128, M-RoPE sections (16, 24, 24), rope theta 1e6. The ViT vision
encoder and projector are a stub: the patch embeddings are an input,
``vision_embeds`` (B, npatch, D), spliced over the prompt's first npatch
tokens (``configs.input_specs`` fixes the count at 1,024).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", arch_type="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        mrope_sections=(16, 24, 24), num_patches=1024,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke", arch_type="vlm",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        mrope_sections=(8, 12, 12), num_patches=16,
        rope_theta=1_000_000.0,
    )
