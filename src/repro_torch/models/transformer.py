"""The dense LM family (L x (GQA attention + SwiGLU MLP)): parameters,
full-sequence forward, prefill and single-token decode over a KV cache.

A port of the dense path of ``repro.models.transformer``. The parameters
live in ``nn.Module``s (a ``Block`` per layer, with its ``Attention`` and
``MLP``, in an ``nn.ModuleList``); the layer loop is a Python ``for`` loop
where JAX scans. The entry points are plain functions, as in JAX, and take
the config explicitly, so one set of weights can be served under several
configs (e.g. ``configs.for_shape(cfg, "long_500k")``):

    model = init_params(cfg, seed=0)                   # on CUDA by default
    last_logits, cache = prefill(model, {"tokens": prompt}, cfg, cache_len)
    logits, cache = decode_step(model, tokens, pos, cache, cfg)

The cache is ``{"blocks": {"k": (L, B, S, Hkv, hd), "v": ...}}``, as in
JAX; ``decode_step`` writes into it in place and returns it. Other
families (MoE, SSM, hybrid, audio, VLM) raise "not ported yet".
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import ModelConfig, dense, init_dense, rms_norm

# ---------------------------------------------------------------------------
# Parameters


def _layer_plan(cfg: ModelConfig):
    """Returns (stacks, tail), lists of (name, kind, count, cross); the
    dense family only."""
    if (cfg.arch_type != "dense" or cfg.mrope_sections
            or cfg.learned_positions or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type!r} family is not ported yet; the "
            f"port runs the dense family")
    return [("blocks", "attn", cfg.num_layers, False)], []


class Block(nn.Module):
    """One layer: RMS norm, attention, RMS norm, MLP (pre-norm residual)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(d, device=device),
                                requires_grad=False)
        self.attn = attention.Attention(cfg, device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device),
                                requires_grad=False)
        self.mlp = mlp_lib.MLP(d, cfg.d_ff, cfg.param_dtype, cfg.mlp_kind,
                               device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(generator, cfg)
        self.mlp.reset_parameters(generator, cfg.num_layers)


class Transformer(nn.Module):
    """Token embedding (tied to the output unless ``unembed`` is set), the
    block stack and the final norm. Built empty; ``init_params`` or
    ``convert.lm_params_from_numpy`` fill it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _layer_plan(cfg)
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.param_dtype
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, d, dtype=dt, device=device),
            requires_grad=False)
        self.ln_f = nn.Parameter(torch.zeros(d, device=device),
                                 requires_grad=False)
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(d, cfg.vocab_size, dtype=dt, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator,
                                     device=generator.device) * 0.02)
        self.ln_f.zero_()
        if self.unembed is not None:
            self.unembed.copy_(init_dense(generator, cfg.d_model,
                                          cfg.vocab_size, cfg.param_dtype))
        for blk in self.blocks:
            blk.reset_parameters(generator, cfg)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, V) f32 logits under the model's config."""
        return forward(self, {"tokens": tokens}, self.cfg)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: torch.device | str | None = None) -> Transformer:
    """A model with seeded random weights on ``device`` (CUDA unless asked
    otherwise): embeddings N(0, 0.02²), dense weights truncated normal in
    ±2σ scaled by 1/√d_in (the output projections by 1/√(2 L d_in)), norm
    scales zero. Drawn from a ``torch.Generator`` on the device, so the
    numbers differ from the JAX package's ``init_params``; tests carry JAX
    weights across with ``convert.lm_params_from_numpy``."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    model.reset_parameters(generator)
    return model


# ---------------------------------------------------------------------------
# Full-sequence forward


def _block_fwd(p: Block, x, positions, cfg: ModelConfig):
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    att, _ = attention.self_attention(p.attn, h, positions, cfg)
    x = x + att
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp_lib.mlp(p.mlp, h2)


def _embed(model: Transformer, tokens, cfg: ModelConfig):
    return model.embed[tokens.long()].to(cfg.dtype)


def _logits(model: Transformer, x, cfg: ModelConfig):
    h = rms_norm(x, model.ln_f, cfg.norm_eps)
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    return dense(h, w).float()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def forward_hidden(model: Transformer, batch: dict, cfg: ModelConfig):
    """Full forward up to the (pre-ln_f) hidden states (B, S, D)."""
    _layer_plan(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(model, tokens, cfg)
    for blk in model.blocks:
        x = _block_fwd(blk, x, positions, cfg)
    return x


def forward(model: Transformer, batch: dict, cfg: ModelConfig):
    """batch: tokens (B, S). Returns logits (B, S, V) f32 (``forward_train``
    of the JAX package without its auxiliary losses, which the dense family
    does not have)."""
    return _logits(model, forward_hidden(model, batch, cfg), cfg)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zeroed KV cache in ``cfg.dtype``, ``{"blocks": {"k", "v"}}`` of
    (L, B, S, Hkv, hd)."""
    stacks, _ = _layer_plan(cfg)
    cache = {}
    for name, _, count, _ in stacks:
        shape = (count, batch, cache_len, cfg.num_kv_heads, cfg.hd)
        cache[name] = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return cache


def _decode_block(p: Block, x, pos, cache_k, cache_v, cfg: ModelConfig):
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    att, _, _ = attention.decode_attention(p.attn, h, cache_k, cache_v, pos,
                                           cfg)
    x = x + att
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp_lib.mlp(p.mlp, h2)


def decode_step(model: Transformer, tokens, pos, cache, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) int32. Writes the new
    K/V rows into ``cache`` in place. Returns (logits (B, V) f32, cache)."""
    _layer_plan(cfg)
    x = _embed(model, tokens, cfg)
    ck, cv = cache["blocks"]["k"], cache["blocks"]["v"]
    for i, blk in enumerate(model.blocks):
        x = _decode_block(blk, x, pos, ck[i], cv[i], cfg)
    return _logits(model, x, cfg)[:, 0], cache


def prefill(model: Transformer, batch: dict, cfg: ModelConfig,
            cache_len: int | None = None):
    """Run the full-sequence forward and fill the KV cache.

    Returns (last_logits (B, V) f32, cache). A cache at least as long as
    the prompt is linear (slot = position); a shorter one is a ring buffer
    holding the last ``cache_len`` positions at slot = position % cache_len.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    positions = _positions(b, s, tokens.device)
    x = _embed(model, tokens, cfg)
    cache = init_cache(cfg, b, cache_len, device=tokens.device)
    ck, cv = cache["blocks"]["k"], cache["blocks"]["v"]
    for i, blk in enumerate(model.blocks):
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        att, (k, v) = attention.self_attention(blk.attn, h, positions, cfg)
        x = x + att
        if cache_len >= s:
            # linear layout: slot = position
            ck[i, :, :s] = k
            cv[i, :, :s] = v
        else:
            # ring buffer: position t lives at slot t % cache_len
            ck[i] = torch.roll(k[:, -cache_len:], s % cache_len, dims=1)
            cv[i] = torch.roll(v[:, -cache_len:], s % cache_len, dims=1)
        h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + mlp_lib.mlp(blk.mlp, h2)
    return _logits(model, x[:, -1:], cfg)[:, 0], cache
