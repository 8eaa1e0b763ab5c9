"""The LM families of the port: parameters, full-sequence forward, prefill
and single-token decode over a cache.

- dense: L x (GQA attention + SwiGLU MLP);
- moe: L x (GQA attention + MoE FFN), after ``first_dense_layers`` leading
  layers of a SwiGLU FFN of ``first_dense_d_ff`` (deepseek-moe);
- ssm: L x Mamba2/SSD block (``models.ssm``; no MLP sublayer);
- hybrid: the (rglru, rglru, attn) pattern (``models.rglru`` and local
  attention), each block with an MLP, then the pattern's tail.

A port of those families of ``repro.models.transformer``. The parameters
live in ``nn.Module``s (a ``Block`` per layer, with its ``Attention``,
``RGLRU`` or ``SSM`` and its ``MLP`` or ``MoE``), one ``nn.ModuleList`` a
stack of the layer plan (``blocks``; ``dense_blocks`` before it where the
MoE family has leading dense layers; the hybrid's ``pat{i}_{kind}``) and
one ``Block`` attribute a tail layer (the hybrid's ``tail{i}_{kind}``,
unstacked as in JAX's tree); the layer loop is a Python ``for`` loop
where JAX scans. The hybrid runs its stacks one after another, as JAX
does (8 rglru, 8 rglru, 8 attention layers, then the tail, at
recurrentgemma-2b's 26), not interleaved as Griffin's pattern is. The
entry points are plain functions, as in JAX, and take the config
explicitly, so one set of weights can be served under several configs
(e.g. ``configs.for_shape(cfg, "long_500k")``):

    model = init_params(cfg, seed=0)                   # on CUDA by default
    last_logits, cache = prefill(model, {"tokens": prompt}, cfg, cache_len)
    logits, cache = decode_step(model, tokens, pos, cache, cfg)

The cache holds one entry a stack or tail, as in JAX: ``{"k", "v"}`` (L,
B, S, Hkv, hd) for attention, ``{"conv", "h"}`` for RG-LRU and ``{"conv",
"state"}`` for SSD layers (``h`` and ``state`` in f32), with no layer
axis on a tail; ``decode_step`` writes into it in place and returns it.
The audio and VLM families raise "not ported yet".

Training (``repro_torch.training.train_step``) differentiates
``forward_train`` or ``forward_hidden`` + ``chunked_ce_loss``. The weights
are built with ``requires_grad=False``, so a served model builds no
autograd graph; the training state switches them on for its own model.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       rms_norm, softmax_cross_entropy)

# ---------------------------------------------------------------------------
# Parameters


def _layer_plan(cfg: ModelConfig):
    """Returns (stacks, tail), lists of (name, kind, count, cross), as JAX's
    ``_layer_plan``; the dense, MoE, SSM and hybrid families."""
    if (cfg.arch_type not in ("dense", "moe", "ssm", "hybrid")
            or cfg.mrope_sections or cfg.learned_positions
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type!r} family is not ported yet; the "
            f"port runs the dense, MoE, SSM and hybrid families")
    if cfg.arch_type == "ssm":
        return [("blocks", "ssm", cfg.num_layers, False)], []
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")
        reps = cfg.num_layers // len(pat)
        tail = cfg.pattern_tail or tuple(
            pat[i] for i in range(cfg.num_layers - reps * len(pat)))
        stacks = [(f"pat{i}_{k}", k, reps, False) for i, k in enumerate(pat)]
        tails = [(f"tail{i}_{k}", k, 1, False) for i, k in enumerate(tail)]
        return stacks, tails
    if cfg.arch_type == "moe":
        nd = cfg.first_dense_layers
        stacks = [("dense_blocks", "dense_ffn", nd, False)] if nd else []
        stacks.append(("blocks", "moe", cfg.num_layers - nd, False))
        return stacks, []
    return [("blocks", "attn", cfg.num_layers, False)], []


class Block(nn.Module):
    """One layer, pre-norm residuals: RMS norm, then by ``kind`` the mixer
    (attention for ``attn``, ``dense_ffn`` and ``moe``; ``RGLRU`` for
    ``rglru``; ``SSM`` for ``ssm``, which ends the block there), RMS norm,
    and the MLP (``attn``, ``rglru``), a SwiGLU MLP of ``first_dense_d_ff``
    (``dense_ffn``) or the MoE layer (``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.ln1 = nn.Parameter(torch.zeros(d, device=device),
                                requires_grad=False)
        if kind == "ssm":
            self.ssm = ssm_lib.SSM(cfg, device)
            return
        if kind == "rglru":
            self.rec = rglru_lib.RGLRU(cfg, device)
        else:
            self.attn = attention.Attention(cfg, device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device),
                                requires_grad=False)
        if kind == "moe":
            self.moe = mlp_lib.MoE(cfg, device)
        elif kind == "dense_ffn":
            self.mlp = mlp_lib.MLP(d, cfg.first_dense_d_ff or cfg.d_ff,
                                   cfg.param_dtype, device=device)
        else:
            self.mlp = mlp_lib.MLP(d, cfg.d_ff, cfg.param_dtype, cfg.mlp_kind,
                                   device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        self.ln1.zero_()
        if self.kind == "ssm":
            self.ssm.reset_parameters(generator, cfg)
            return
        self.ln2.zero_()
        if self.kind == "rglru":
            self.rec.reset_parameters(generator, cfg)
        else:
            self.attn.reset_parameters(generator, cfg)
        if self.kind == "moe":
            self.moe.reset_parameters(generator, cfg)
        else:
            self.mlp.reset_parameters(generator, cfg.num_layers)


class Transformer(nn.Module):
    """Token embedding (tied to the output unless ``unembed`` is set), the
    block stacks of the layer plan and the final norm. Built empty;
    ``init_params`` or ``convert.lm_params_from_numpy`` fill it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        stacks, tail = _layer_plan(cfg)
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
        for name, kind, count, _ in stacks:
            self.add_module(name, nn.ModuleList(
                Block(cfg, kind, device) for _ in range(count)))
        for name, kind, _, _ in tail:
            self.add_module(name, Block(cfg, kind, device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator,
                                     device=generator.device) * 0.02)
        self.ln_f.zero_()
        if self.unembed is not None:
            self.unembed.copy_(init_dense(generator, cfg.d_model,
                                          cfg.vocab_size, cfg.param_dtype))
        for _, _, blocks, _ in _groups(self, cfg):
            for blk in blocks:
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


def layer_of(name: str):
    """(stack, layer, path in the layer) of a parameter name of a stack,
    such as ``blocks.3.moe.wg`` or ``pat0_rglru.2.rec.lam``; None for one
    outside the stacks (``embed``, or a tail's ``tail0_rglru.rec.lam``).
    JAX's tree holds each stack's leaves on a leading layer axis instead,
    and a tail's with none."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return parts[0], int(parts[1]), tuple(parts[2:])
    return None


def _groups(model: Transformer, cfg: ModelConfig):
    """(name, kind, blocks, stacked) of each stack of the layer plan, then
    of each tail (a list of its one ``Block``, ``stacked`` False), in
    order."""
    stacks, tail = _layer_plan(cfg)
    return ([(name, kind, getattr(model, name), True)
             for name, kind, _, _ in stacks]
            + [(name, kind, [getattr(model, name)], False)
               for name, kind, _, _ in tail])


# ---------------------------------------------------------------------------
# Full-sequence forward


def _ffn(p: Block, h2, cfg: ModelConfig, kind: str):
    """The block's feed-forward sublayer: (output, the MoE router's aux
    loss, or None for a dense FFN)."""
    if kind == "moe":
        return mlp_lib.moe(p.moe, h2, cfg)
    return mlp_lib.mlp(p.mlp, h2), None


def _block_fwd(p: Block, x, positions, cfg: ModelConfig, kind: str):
    """One block over the full sequence: (x, aux or None)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "ssm":
        return x + ssm_lib.ssd_forward(p.ssm, h, cfg), None
    if kind == "rglru":
        x = x + rglru_lib.rglru_forward(p.rec, h, cfg)
    else:
        att, _ = attention.self_attention(p.attn, h, positions, cfg)
        x = x + att
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    y, aux = _ffn(p, h2, cfg, kind)
    return x + y, aux


def _embed(model: Transformer, tokens, cfg: ModelConfig):
    return model.embed[tokens.long()].to(cfg.dtype)


def _logits(model: Transformer, x, cfg: ModelConfig):
    h = rms_norm(x, model.ln_f, cfg.norm_eps)
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    return dense(h, w).float()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _training(model: Transformer) -> bool:
    """Whether this forward builds an autograd graph of the weights: grad
    mode on and the model's weights trainable (``init_train_state``
    switches them on; a served model keeps them off)."""
    return torch.is_grad_enabled() and model.embed.requires_grad


def forward_hidden(model: Transformer, batch: dict, cfg: ModelConfig):
    """Full forward up to the (pre-ln_f) hidden states. Returns (x (B, S,
    D), aux): aux the 0-d f32 sum of the MoE layers' router losses, in
    JAX's order (zero for the dense family).

    In training with ``cfg.remat`` each block runs under a non-reentrant
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of the scanned
    block body): only the block's input is kept, and the backward pass
    recomputes the rest."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(model, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and _training(model)
    for _, kind, blocks, _ in _groups(model, cfg):
        for blk in blocks:
            if remat:
                x, a = checkpoint(_block_fwd, blk, x, positions, cfg, kind,
                                  use_reentrant=False)
            else:
                x, a = _block_fwd(blk, x, positions, cfg, kind)
            if a is not None:
                aux = aux + a
    return x, aux


def forward_train(model: Transformer, batch: dict, cfg: ModelConfig,
                  return_hidden: bool = False):
    """batch: tokens (B, S). Returns (logits (B, S, V) f32, aux) [, the
    pre-ln_f hidden states (B, S, D) when ``return_hidden``]. ``aux`` is
    the MoE router's auxiliary loss summed over the layers, a 0-d f32 (zero
    for the dense family)."""
    x, aux = forward_hidden(model, batch, cfg)
    if return_hidden:
        return _logits(model, x, cfg), aux, x
    return _logits(model, x, cfg), aux


def forward(model: Transformer, batch: dict, cfg: ModelConfig):
    """batch: tokens (B, S). Returns logits (B, S, V) f32 (``forward_train``
    without its auxiliary loss)."""
    return _logits(model, forward_hidden(model, batch, cfg)[0], cfg)


def _chunk_ce(h, y, w):
    """Mean CE of one chunk's logits, (B, C, D) hidden against (D, V)."""
    return softmax_cross_entropy(dense(h, w).float(), y)


def chunked_ce_loss(model: Transformer, hidden, labels, cfg: ModelConfig):
    """Next-token CE without materialising the (B, S, V) logits: the
    predictions of ``hidden[:, t]`` for ``labels[:, t + 1]`` in chunks of
    ``min(cfg.ce_chunk, S - 1)`` positions, each chunk's logits and CE
    under a checkpoint (recomputed in the backward pass), the ragged tail
    after them, the sum divided by the true count."""
    b, _, d = hidden.shape
    h = rms_norm(hidden, model.ln_f, cfg.norm_eps)
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    h, y = h[:, :-1], labels[:, 1:]
    s1 = h.shape[1]
    chunk = min(cfg.ce_chunk, s1)
    n = (s1 // chunk) * chunk
    remat = _training(model)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, n, chunk):
        hh, yy = h[:, lo:lo + chunk], y[:, lo:lo + chunk]
        ce = (checkpoint(_chunk_ce, hh, yy, w, use_reentrant=False) if remat
              else _chunk_ce(hh, yy, w))
        tot = tot + ce * (chunk * b)
    if n < s1:                                  # the ragged tail
        tot = tot + _chunk_ce(h[:, n:], y[:, n:], w) * ((s1 - n) * b)
    return tot / (s1 * b)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 device) -> dict:
    """One layer's zeroed cache: attention's ``{k, v}`` (B, S, Hkv, hd) in
    ``cfg.dtype``; RG-LRU's ``{conv, h}`` and SSD's ``{conv, state}``, the
    conv history in ``cfg.dtype`` and the state in f32."""
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, cfg.dtype, device)
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, cfg.dtype, device)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zeroed cache: one entry a stack of the layer plan, each leaf with a
    leading layer axis (``{"blocks": {"k": (L, B, S, Hkv, hd), ...}}``),
    then one a tail, without it (``_layer_cache``)."""
    stacks, tail = _layer_plan(cfg)
    cache = {}
    for name, kind, count, _ in stacks:
        one = _layer_cache(cfg, kind, batch, cache_len, device)
        cache[name] = {k: v.new_zeros((count,) + tuple(v.shape))
                       for k, v in one.items()}
    for name, kind, _, _ in tail:
        cache[name] = _layer_cache(cfg, kind, batch, cache_len, device)
    return cache


def _layer_caches(cache: dict, count: int, stacked: bool) -> list:
    """The cache of each layer of a stack (views of its leaves' layer
    rows), or of a tail (its entry itself)."""
    if not stacked:
        return [cache]
    return [{k: v[i] for k, v in cache.items()} for i in range(count)]


def _write(cache: dict, new: dict) -> None:
    """A layer's new recurrent state into its cache, in place, cast to
    each leaf's dtype (JAX's ``astype(old.dtype)``)."""
    for key, value in new.items():
        cache[key].copy_(value)


def _decode_block(p: Block, x, pos, cache: dict, cfg: ModelConfig,
                  kind: str):
    """One block of a decode step; writes the layer's new K/V row or
    recurrent state into its ``cache`` in place."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "ssm":
        y, new = ssm_lib.ssd_decode_step(p.ssm, h, cache, cfg)
        _write(cache, new)
        return x + y
    if kind == "rglru":
        y, new = rglru_lib.rglru_decode_step(p.rec, h, cache, cfg)
        _write(cache, new)
        x = x + y
    else:
        att, _, _ = attention.decode_attention(p.attn, h, cache["k"],
                                               cache["v"], pos, cfg)
        x = x + att
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind)[0]        # the router's aux dropped


def decode_step(model: Transformer, tokens, pos, cache, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) int32. Writes the new
    K/V rows and recurrent states into ``cache`` in place. Returns (logits
    (B, V) f32, cache)."""
    x = _embed(model, tokens, cfg)
    for name, kind, blocks, stacked in _groups(model, cfg):
        for blk, c in zip(blocks, _layer_caches(cache[name], len(blocks),
                                                stacked)):
            x = _decode_block(blk, x, pos, c, cfg, kind)
    return _logits(model, x, cfg)[:, 0], cache


def prefill(model: Transformer, batch: dict, cfg: ModelConfig,
            cache_len: int | None = None):
    """Run the full-sequence forward and fill the cache.

    Returns (last_logits (B, V) f32, cache). A KV cache at least as long as
    the prompt is linear (slot = position); a shorter one is a ring buffer
    holding the last ``cache_len`` positions at slot = position % cache_len.
    A recurrent layer's cache holds its state after the prompt (its
    forward's ``return_state``), cast to each leaf's dtype.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    positions = _positions(b, s, tokens.device)
    x = _embed(model, tokens, cfg)
    cache = init_cache(cfg, b, cache_len, device=tokens.device)
    for name, kind, blocks, stacked in _groups(model, cfg):
        for blk, c in zip(blocks, _layer_caches(cache[name], len(blocks),
                                                stacked)):
            h = rms_norm(x, blk.ln1, cfg.norm_eps)
            if kind == "ssm":
                y, new = ssm_lib.ssd_forward(blk.ssm, h, cfg,
                                             return_state=True)
                _write(c, new)
                x = x + y
                continue
            if kind == "rglru":
                y, new = rglru_lib.rglru_forward(blk.rec, h, cfg,
                                                 return_state=True)
                _write(c, new)
                x = x + y
            else:
                att, (k, v) = attention.self_attention(blk.attn, h,
                                                       positions, cfg)
                x = x + att
                if cache_len >= s:
                    # linear layout: slot = position
                    c["k"][:, :s] = k
                    c["v"][:, :s] = v
                else:
                    # ring buffer: position t lives at slot t % cache_len
                    c["k"].copy_(torch.roll(k[:, -cache_len:],
                                            s % cache_len, dims=1))
                    c["v"].copy_(torch.roll(v[:, -cache_len:],
                                            s % cache_len, dims=1))
            h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
            x = x + _ffn(blk, h2, cfg, kind)[0]   # the router's aux dropped
    return _logits(model, x[:, -1:], cfg)[:, 0], cache
