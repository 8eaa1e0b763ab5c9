"""whisper-medium [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model=1024, 16 heads (MHA kv=16),
d_ff=4096 (GELU MLP), vocab=51865, learned positions, 1500 audio frames.
The frames are an input: precomputed frame embeddings (B, encoder_seq,
d_model) stand for the mel spectrogram and its conv frontend, as in the
JAX package.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", arch_type="audio",
        num_layers=24, encoder_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
        is_encoder_decoder=True, encoder_seq=1500,
        learned_positions=True, max_positions=8192, mlp_kind="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", arch_type="audio",
        num_layers=2, encoder_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        is_encoder_decoder=True, encoder_seq=64,
        learned_positions=True, max_positions=1024, mlp_kind="gelu",
    )
