"""Shared model configuration and primitive layers, in PyTorch.

A copy of ``repro.models.common`` for the port. Conventions:

- Dense weights are stored (d_in, d_out), as in the JAX package, so that
  ``dense`` is ``x @ w`` and weights carry across without a transpose.
- Weights are stored in ``cfg.param_dtype`` (bf16 by default, the serving
  layout); products run in the activation dtype with f32 accumulation
  (cuBLAS accumulates bf16 products in f32; f32 products run in full f32,
  never TF32); norms and softmax run in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import no_tf32

# ---------------------------------------------------------------------------
# Config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0             # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0   # leading dense FFN layers (deepseek-moe)
    first_dense_d_ff: int = 0
    moe_impl: str = "dense"       # dense (all-experts einsum) | ragged
                                  # (ragged_dot) | ep (shard_map expert par.)
    moe_capacity_factor: float = 2.0
    router_aux_coef: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (recurrentgemma): pattern over a repeating block
    block_pattern: tuple = ()     # e.g. ("rglru", "rglru", "attn")
    pattern_tail: tuple = ()      # leftover layers after full pattern repeats
    lru_width: int = 0            # 0 -> d_model
    # attention windowing (local attention / long-context serving)
    window: int = 0               # 0 = full causal; >0 = sliding window
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    learned_positions: bool = False
    max_positions: int = 0        # learned-position table size (0 -> 8192)
    # vlm (qwen2-vl)
    mrope_sections: tuple = ()    # e.g. (16, 24, 24) halves of head_dim/2
    num_patches: int = 0          # vision token count fed by the stub frontend
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"      # swiglu | gelu (whisper-style)
    # naive: materialise (S, S) scores; chunked: flash-style online softmax
    # over KV blocks (no quadratic buffer)
    attention_impl: str = "naive"
    # Zero-pad the (post-GQA-repeat) head axis up to this count inside the
    # attention computation. Exact (padded heads have zero V and zero wo
    # rows); kept so that configs copy over verbatim.
    pad_heads_to: int = 0
    attention_chunk: int = 512
    # store attention probabilities in bf16 between softmax and the PV matmul
    # (max/denominator stay f32) — halves the largest attention intermediate
    attention_probs_bf16: bool = False
    # bf16 row-parallel partial sums (a tensor-parallel option of the JAX
    # package; one card has no partial sums, so the port ignores it)
    bf16_partials: bool = False
    # compute the LM cross-entropy over sequence chunks (training only)
    chunked_ce: bool = False
    ce_chunk: int = 512
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16   # activation/compute dtype
    param_dtype: Any = torch.bfloat16
    remat: bool = True            # checkpoint each block in training
    unroll_layers: bool = False   # JAX lowering option; the port always loops

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model


# ---------------------------------------------------------------------------
# Primitive ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``, in
    f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation, output in x's dtype. w: (d_in, d_out).

    A bf16 product goes to cuBLAS, which accumulates in f32 and rounds once
    to bf16, as the JAX package's ``preferred_element_type=f32`` followed by
    a cast does; an f32 product runs in full f32 (``no_tf32``)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        with no_tf32():
            return x @ w
    return x @ w


def trunc_normal(generator: torch.Generator,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32, drawn on ``generator``'s
    device by inverting the CDF of a uniform draw."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight: truncated normal in ±2σ, scaled by 1/√d_in
    unless ``scale`` is given, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (scale * trunc_normal(generator, (d_in, d_out))).to(dtype)
