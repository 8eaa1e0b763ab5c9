"""Architecture registry of the port.

A copy of ``repro.configs``: every architecture is a module here exposing
``config()`` (the published geometry, source cited in its docstring) and
``smoke_config()`` (a reduced variant of the same family for CPU tests).

``get_optimized(name)`` adds the chunked-attention and chunked-CE settings
under which the JAX package trains (``OPTIMIZED``).
``for_shape(cfg, shape)`` specialises a config for one of the four input
shapes (the sliding window of long-context serving; a learned-position
table long enough for the shape) and
``cache_len_for(cfg, shape)`` gives its KV-cache length, and
``input_specs(cfg, shape)`` the inputs of a step at the shape as tensors on
the ``meta`` device (shapes and dtypes, no storage).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

ARCHS = [
    "smollm_360m", "whisper_medium", "llama3_2_1b", "qwen2_vl_72b",
    "recurrentgemma_2b", "deepseek_moe_16b", "deepseek_coder_33b",
    "yi_9b", "granite_moe_1b_a400m", "mamba2_1_3b",
]

# canonical ids -> module names
ALIASES = {
    "smollm-360m": "smollm_360m",
    "whisper-medium": "whisper_medium",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-9b": "yi_9b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-1.3b": "mamba2_1_3b",
}

SHAPES = {
    "train_4k":    dict(seq=4096,    batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,   batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,   batch=128, kind="decode"),
    "long_500k":   dict(seq=524288,  batch=1,   kind="decode"),
}

LONG_WINDOW = 8192  # sliding window used by dense archs for long_500k

# The JAX package's measured optimised variants, applied on top of the
# faithful config by ``get_optimized``.
OPTIMIZED = {
    "smollm-360m": dict(pad_heads_to=16, attention_impl="chunked",
                        chunked_ce=True),
    "deepseek-coder-33b": dict(pad_heads_to=64, attention_impl="chunked"),
    "deepseek-moe-16b": dict(moe_impl="ep", attention_impl="chunked",
                             chunked_ce=True, moe_capacity_factor=1.25),
    "granite-moe-1b-a400m": dict(moe_impl="ep", attention_impl="chunked",
                                 chunked_ce=True),
    # divisible-head dense archs still gain the memory-term levers
    "llama3.2-1b": dict(attention_impl="chunked", chunked_ce=True),
    "yi-9b": dict(attention_impl="chunked", chunked_ce=True),
    "qwen2-vl-72b": dict(attention_impl="chunked", chunked_ce=True),
}


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}")


def get(name: str):
    return _module(name).config()


def get_optimized(name: str):
    """The faithful config with its ``OPTIMIZED`` settings, if any."""
    cfg = get(name)
    over = OPTIMIZED.get(name)
    return dataclasses.replace(cfg, **over) if over else cfg


def get_smoke(name: str):
    """Reduced same-family config in f32 (the CPU tests compare it with the
    JAX package's f32 smoke config)."""
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32)


def for_shape(cfg, shape: str):
    """Shape-specialised config (the sliding window of long-context decode)."""
    spec = SHAPES[shape]
    if shape == "long_500k" and cfg.arch_type not in ("ssm",):
        if cfg.window == 0:
            cfg = dataclasses.replace(cfg, window=LONG_WINDOW)
    if cfg.learned_positions:
        need = spec["seq"] + 1
        if (cfg.max_positions or 8192) < need:
            cfg = dataclasses.replace(cfg, max_positions=need)
    return cfg


def cache_len_for(cfg, shape: str) -> int:
    seq = SHAPES[shape]["seq"]
    if cfg.window:
        return min(cfg.window, seq)
    return seq


def input_specs(cfg, shape: str) -> dict:
    """The batch argument of a step at ``shape`` as tensors on the ``meta``
    device, JAX's ``input_specs`` key for key: tokens (and labels when
    training; pos when decoding), the audio family's frames, the VLM's
    vision embeddings (train and prefill) and M-RoPE positions (3, B, S),
    or (3, B, 1) at decode."""
    spec = SHAPES[shape]
    b, s = spec["batch"], spec["seq"]

    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    out = {}
    if spec["kind"] == "train":
        out["tokens"] = meta((b, s))
        out["labels"] = meta((b, s))
    elif spec["kind"] == "prefill":
        out["tokens"] = meta((b, s))
    else:  # decode
        out["tokens"] = meta((b, 1))
        out["pos"] = meta((b,))
    if cfg.is_encoder_decoder and spec["kind"] != "decode":
        out["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    if cfg.arch_type == "vlm":
        if spec["kind"] == "decode":
            out["positions3"] = meta((3, b, 1))
        else:
            out["vision_embeds"] = meta((b, cfg.num_patches, cfg.d_model),
                                        cfg.dtype)
            out["positions3"] = meta((3, b, s))
    return out
