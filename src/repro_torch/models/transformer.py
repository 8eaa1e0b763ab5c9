"""The LM families of the port: parameters, full-sequence forward, prefill
and single-token decode over a cache.

- dense / vlm: L x (GQA attention + SwiGLU MLP); the VLM (qwen2-vl) adds
  M-RoPE over 3-D positions (``batch["positions3"]``, (3, B, S)) and
  splices the stub vision frontend's patch embeddings
  (``batch["vision_embeds"]``, (B, npatch, D)) over the prompt's first
  npatch token embeddings;
- moe: L x (GQA attention + MoE FFN), after ``first_dense_layers`` leading
  layers of a SwiGLU FFN of ``first_dense_d_ff`` (deepseek-moe); with an
  ``MLAConfig`` the attention is multi-head latent attention with YaRN
  (DeepSeek-V2-Lite, a port-only config);
- ssm: L x Mamba2/SSD block (``models.ssm``; no MLP sublayer);
- hybrid: the (rglru, rglru, attn) pattern (``models.rglru`` and local
  attention), each block with an MLP, then the pattern's tail;
- audio: whisper's encoder-decoder: an encoder of L x (bidirectional
  attention + GELU MLP) over stub frame embeddings (``batch["frames"]``,
  (B, encoder_seq, D)), then a decoder of L x (causal self-attention +
  cross-attention to the encoder's output + GELU MLP); learned positions
  added to both inputs, no RoPE.

A port of those families of ``repro.models.transformer``. The parameters
live in ``nn.Module``s (a ``Block`` per layer, with its ``Attention``,
``RGLRU`` or ``SSM`` and its ``MLP`` or ``MoE``), one ``nn.ModuleList`` a
stack of the layer plan (``blocks``; ``dense_blocks`` before it where the
MoE family has leading dense layers; the hybrid's ``pat{i}_{kind}``) and
one ``Block`` attribute a tail layer (the hybrid's ``tail{i}_{kind}``,
unstacked as in JAX's tree; the audio family's ``enc_blocks`` and
``dec_blocks``, the latter with ``ln_cross`` and a ``cross`` attention);
the layer loop is a Python ``for`` loop
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
B, S, Hkv, hd) for attention (``{"ckv", "kpe"}``, the latent, for latent
attention: ``MLAConfig``), ``{"conv", "h"}`` for RG-LRU and ``{"conv",
"state"}`` for SSD layers (``h`` and ``state`` in f32), with no layer
axis on a tail; the decoder's stack adds ``{"cross_k", "cross_v"}`` (L, B,
Se, Hkv, hd), the encoder's K/V that prefill computes once (the encoder's
stack has no cache). ``decode_step`` writes into it in place and returns
it; its self- and cross-attention both run on ``swa_decode``.

Training (``repro_torch.training.train_step``) differentiates
``forward_train`` or ``forward_hidden`` + ``chunked_ce_loss``. The weights
are built with ``requires_grad=False``, so a served model builds no
autograd graph; the training state switches them on for its own model.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import spans
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       rms_norm, softmax_cross_entropy,
                                       take_sharded)

# ---------------------------------------------------------------------------
# Parameters


#: the audio family's encoder stack: no cross-attention, no cache, run
#: once by ``_encode`` and skipped by the decoder's loops
ENCODER = "enc_blocks"


def _layer_plan(cfg: ModelConfig):
    """Returns (stacks, tail), lists of (name, kind, count, cross), as JAX's
    ``_layer_plan``."""
    if (cfg.arch_type == "audio") != cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: the audio family, and it alone, is an "
                         f"encoder-decoder (arch_type {cfg.arch_type!r}, "
                         f"is_encoder_decoder {cfg.is_encoder_decoder})")
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
    if cfg.arch_type == "audio":
        return ([(ENCODER, "attn", cfg.encoder_layers or cfg.num_layers,
                  False), ("dec_blocks", "attn", cfg.num_layers, True)], [])
    # dense / vlm
    return [("blocks", "attn", cfg.num_layers, False)], []


class Block(nn.Module):
    """One layer, pre-norm residuals: RMS norm, then by ``kind`` the mixer
    (attention for ``attn``, ``dense_ffn`` and ``moe``; ``RGLRU`` for
    ``rglru``; ``SSM`` for ``ssm``, which ends the block there), with
    ``cross`` an RMS norm and the cross-attention (the audio decoder), RMS
    norm, and the MLP (``attn``, ``rglru``), a SwiGLU MLP of
    ``first_dense_d_ff`` (``dense_ffn``) or the MoE layer (``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", device=None,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.kind, self.has_cross = kind, cross
        self.ln1 = nn.Parameter(torch.zeros(d, device=device),
                                requires_grad=False)
        if kind == "ssm":
            self.ssm = ssm_lib.SSM(cfg, device)
            return
        if kind == "rglru":
            self.rec = rglru_lib.RGLRU(cfg, device)
        elif cfg.attention_kind == "mla":
            self.attn = attention.LatentAttention(cfg, device)
        else:
            self.attn = attention.Attention(cfg, device)
        if cross:
            self.ln_cross = nn.Parameter(torch.zeros(d, device=device),
                                         requires_grad=False)
            self.cross = attention.Attention(cfg, device)
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
        if self.has_cross:
            self.ln_cross.zero_()
            self.cross.reset_parameters(generator, cfg)
        if self.kind == "moe":
            self.moe.reset_parameters(generator, cfg)
        else:
            self.mlp.reset_parameters(generator, cfg.num_layers)


class Transformer(nn.Module):
    """Token embedding (tied to the output unless ``unembed`` is set), the
    learned position tables (``pos_embed`` of ``max_positions`` rows, or
    8,192; the encoder's ``enc_pos_embed`` of ``encoder_seq``) where the
    config has them, the block stacks of the layer plan, the final norm
    and the encoder's (``enc_ln_f``). Built empty; ``init_params`` or
    ``convert.lm_params_from_numpy`` fill it."""

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
        if cfg.learned_positions:
            self.pos_embed = nn.Parameter(
                torch.empty(cfg.max_positions or 8192, d, dtype=dt,
                            device=device), requires_grad=False)
            if cfg.is_encoder_decoder:
                self.enc_pos_embed = nn.Parameter(
                    torch.empty(cfg.encoder_seq, d, dtype=dt, device=device),
                    requires_grad=False)
        if cfg.is_encoder_decoder:
            self.enc_ln_f = nn.Parameter(torch.zeros(d, device=device),
                                         requires_grad=False)
        for name, kind, count, cross in stacks:
            self.add_module(name, nn.ModuleList(
                Block(cfg, kind, device, cross) for _ in range(count)))
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
        for name in ("pos_embed", "enc_pos_embed"):
            table = getattr(self, name, None)
            if table is not None:
                table.copy_(torch.randn(table.shape, generator=generator,
                                        device=generator.device) * 0.02)
        if cfg.is_encoder_decoder:
            self.enc_ln_f.zero_()
        for _, _, blocks, _ in _groups(self, cfg):
            for blk in blocks:
                blk.reset_parameters(generator, cfg)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, V) f32 logits under the model's config."""
        return forward(self, {"tokens": tokens}, self.cfg)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: torch.device | str | None = None) -> Transformer:
    """A model with seeded random weights on ``device`` (CUDA unless asked
    otherwise): embeddings and position tables N(0, 0.02²), dense weights
    truncated normal in
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


def _decoder_groups(model: Transformer, cfg: ModelConfig):
    """``_groups`` without the audio family's encoder stack: the layers a
    token's forward, prefill and decode step run."""
    return [g for g in _groups(model, cfg) if g[0] != ENCODER]


# ---------------------------------------------------------------------------
# Full-sequence forward


def _ffn(p: Block, h2, cfg: ModelConfig, kind: str):
    """The block's feed-forward sublayer: (output, the MoE router's aux
    loss, or None for a dense FFN)."""
    if kind == "moe":
        return mlp_lib.moe(p.moe, h2, cfg)
    return mlp_lib.mlp(p.mlp, h2), None


def _block_fwd(p: Block, x, positions, cfg: ModelConfig, kind: str,
               causal: bool = True, enc_out=None, positions3=None):
    """One block over the full sequence: (x, aux or None). ``causal=False``
    is the audio encoder's bidirectional attention; with ``enc_out`` (the
    encoder's output) a decoder block's cross-attention runs between its
    self-attention and its MLP; ``positions3`` are the VLM's M-RoPE
    positions."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "ssm":
        return x + ssm_lib.ssd_forward(p.ssm, h, cfg), None
    if kind == "rglru":
        x = x + rglru_lib.rglru_forward(p.rec, h, cfg)
    else:
        att, _ = attention.self_attention(p.attn, h, positions, cfg,
                                          causal=causal,
                                          positions3=positions3)
        x = x + att
    if enc_out is not None and p.has_cross:
        hc = rms_norm(x, p.ln_cross, cfg.norm_eps)
        x = x + attention.cross_attention(p.cross, hc, enc_out, cfg)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    y, aux = _ffn(p, h2, cfg, kind)
    return x + y, aux


def _embed(model: Transformer, tokens, cfg: ModelConfig, positions=None):
    """Token embeddings in ``cfg.dtype``, plus the learned position
    embeddings of ``positions`` ((B, S) or a decode step's (B, 1)) where
    the config has them. A position past the table faults on the card
    (JAX clamps it): the launchers refuse such a run first."""
    x = lookup(model.embed, tokens).to(cfg.dtype)
    if cfg.learned_positions and positions is not None:
        x = x + lookup(model.pos_embed, positions).to(cfg.dtype)
    return x


def lookup(table, ids):
    """The rows ``table[ids]``; on a vocab-sharded DTensor table, each rank
    looks up the rows it holds (``take_sharded``)."""
    rows = take_sharded(_rows, table, 0, ids)
    return _rows(table, ids) if rows is None else rows


def _rows(table, ids):
    return table[ids.long()]


def _logits(model: Transformer, x, cfg: ModelConfig):
    with spans.span("lm_head"):
        h = rms_norm(x, model.ln_f, cfg.norm_eps)
        w = model.embed.T if cfg.tie_embeddings else model.unembed
        return spans.mark_backward("lm_head", x, dense(h, w).float())


def stub_inputs(cfg: ModelConfig, batch: int, device=None,
                seq: int | None = None) -> dict:
    """What the launchers feed a model besides its tokens, as JAX's do: for
    the audio family zero frame embeddings (batch, encoder_seq, D) in
    ``cfg.dtype``, the stub of the mel spectrogram and its conv frontend.
    With ``seq`` (the train launcher's sequence length) a VLM gets zero
    vision embeddings (batch, min(num_patches, seq // 2), D) in
    ``cfg.dtype`` and text ``positions3`` (3, batch, seq) int32; JAX's
    serve launcher feeds a VLM nothing, so without ``seq`` it gets
    nothing. Nothing for the other families."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    dtype=cfg.dtype, device=device)
    if cfg.arch_type == "vlm" and seq is not None:
        npatch = min(cfg.num_patches, seq // 2)
        out["vision_embeds"] = torch.zeros((batch, npatch, cfg.d_model),
                                           dtype=cfg.dtype, device=device)
        out["positions3"] = rope_lib.text_positions3(
            _positions(batch, seq, device))
    return out


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _splice_vision(x, batch: dict, cfg: ModelConfig):
    """The VLM's inputs, as JAX's forward and prefill take them: the token
    embeddings x (B, S, D) with the first npatch rows replaced by
    ``batch["vision_embeds"]`` (B, npatch, D) in ``cfg.dtype``, where the
    batch has them, and ``batch.get("positions3")``. Other families: (x,
    None)."""
    if cfg.arch_type != "vlm":
        return x, None
    if "vision_embeds" in batch:
        vis = batch["vision_embeds"]
        x = torch.cat([vis.to(cfg.dtype), x[:, vis.shape[1]:]], dim=1)
    return x, batch.get("positions3")


def _training(model: Transformer) -> bool:
    """Whether this forward builds an autograd graph of the weights: grad
    mode on and the model's weights trainable (``init_train_state``
    switches them on; a served model keeps them off)."""
    return torch.is_grad_enabled() and model.embed.requires_grad


def _encode(model: Transformer, frames, cfg: ModelConfig):
    """The audio encoder over stub frame embeddings (B, Se, D), Se at most
    ``cfg.encoder_seq``: plus ``enc_pos_embed``, the encoder stack
    bidirectionally (each block under the non-reentrant checkpoint when
    ``cfg.remat`` applies in training), then ``enc_ln_f``. Returns (B,
    Se, D) in ``cfg.dtype``."""
    b, se, _ = frames.shape
    x = frames.to(cfg.dtype)
    if cfg.learned_positions:
        if se > model.enc_pos_embed.shape[0]:
            raise ValueError(f"{cfg.name}: {se} frames, more than the "
                             f"encoder's {model.enc_pos_embed.shape[0]} "
                             f"positions")
        x = x + model.enc_pos_embed[:se][None].to(cfg.dtype)
    positions = _positions(b, se, frames.device)
    remat = cfg.remat and _training(model)
    for blk in getattr(model, ENCODER):
        if remat:
            x, _ = checkpoint(_block_fwd, blk, x, positions, cfg, "attn",
                              False, use_reentrant=False)
        else:
            x, _ = _block_fwd(blk, x, positions, cfg, "attn", causal=False)
    return rms_norm(x, model.enc_ln_f, cfg.norm_eps)


def forward_hidden(model: Transformer, batch: dict, cfg: ModelConfig):
    """Full forward up to the (pre-ln_f) hidden states. batch: tokens (B,
    S) [+ frames (B, Se, D) for the audio family, whose encoder runs once
    here | vision_embeds (B, npatch, D), positions3 (3, B, S) for the VLM,
    ``_splice_vision``]. Returns (x (B, S, D), aux): aux the 0-d f32 sum
    of the MoE layers' router losses, in JAX's order (zero for the dense
    family).

    In training with ``cfg.remat`` each block runs under a non-reentrant
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of the scanned
    block body): only the block's inputs are kept (a decoder block's
    include the encoder's output, so its gradient reaches the encoder),
    and the backward pass recomputes the rest."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x, positions3 = _splice_vision(_embed(model, tokens, cfg, positions),
                                   batch, cfg)
    enc_out = (_encode(model, batch["frames"], cfg) if cfg.is_encoder_decoder
               else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and _training(model)
    for _, kind, blocks, _ in _decoder_groups(model, cfg):
        for blk in blocks:
            enc = enc_out if blk.has_cross else None
            if remat:
                x, a = checkpoint(_block_fwd, blk, x, positions, cfg, kind,
                                  True, enc, positions3, use_reentrant=False)
            else:
                x, a = _block_fwd(blk, x, positions, cfg, kind, enc_out=enc,
                                  positions3=positions3)
            if a is not None:
                aux = aux + a
    return x, aux


def forward_train(model: Transformer, batch: dict, cfg: ModelConfig,
                  return_hidden: bool = False):
    """batch: tokens (B, S) [+ frames | vision_embeds, positions3].
    Returns (logits (B, S, V) f32, aux)
    [, the pre-ln_f hidden states (B, S, D) when ``return_hidden``].
    ``aux`` is the MoE router's auxiliary loss summed over the layers, a
    0-d f32 (zero for the dense family)."""
    x, aux = forward_hidden(model, batch, cfg)
    if return_hidden:
        return _logits(model, x, cfg), aux, x
    return _logits(model, x, cfg), aux


def forward(model: Transformer, batch: dict, cfg: ModelConfig):
    """batch: tokens (B, S) [+ frames | vision_embeds, positions3].
    Returns logits (B, S, V) f32
    (``forward_train`` without its auxiliary loss)."""
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
    ``cfg.dtype``, latent attention's ``{ckv, kpe}`` (B, S, rank) and (B,
    S, rope), no per-head K or V; RG-LRU's ``{conv, h}`` and SSD's
    ``{conv, state}``, the conv history in ``cfg.dtype`` and the state in
    f32."""
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, cfg.dtype, device)
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, cfg.dtype, device)
    if cfg.attention_kind == "mla":
        return {key: torch.zeros((batch, cache_len, width), dtype=cfg.dtype,
                                 device=device)
                for key, width in (("ckv", cfg.kv_lora_rank),
                                   ("kpe", cfg.qk_rope_head_dim))}
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               encoder_seq: int | None = None):
    """Zeroed cache: one entry a stack of the layer plan, each leaf with a
    leading layer axis (``{"blocks": {"k": (L, B, S, Hkv, hd), ...}}``),
    then one a tail, without it (``_layer_cache``). The audio encoder's
    stack has none; a stack with cross-attention adds ``cross_k`` and
    ``cross_v`` (L, B, Se, Hkv, hd) in ``cfg.dtype``, Se ``encoder_seq``
    (``cfg.encoder_seq`` unless given)."""
    stacks, tail = _layer_plan(cfg)
    cache = {}
    for name, kind, count, cross in stacks:
        if name == ENCODER:
            continue
        one = _layer_cache(cfg, kind, batch, cache_len, device)
        if cross:
            shape = (batch, encoder_seq or cfg.encoder_seq, cfg.num_kv_heads,
                     cfg.hd)
            for key in ("cross_k", "cross_v"):
                one[key] = torch.zeros(shape, dtype=cfg.dtype, device=device)
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


def _cross_positions(cache: dict, pos):
    """The positions ``swa_decode`` takes for the cross-attention: Se - 1
    in every row, (B,) int32 like ``pos``, made once a decode step; None
    for a cache without cross K/V."""
    for entry in cache.values():
        if "cross_k" in entry:
            return torch.full_like(pos, entry["cross_k"].shape[-3] - 1)
    return None


def _decode_block(p: Block, x, pos, cache: dict, cfg: ModelConfig,
                  kind: str, pos_full=None, positions3=None):
    """One block of a decode step; writes the layer's new K/V row or
    recurrent state into its ``cache`` in place. A decoder block with
    cross-attention attends to its layer's ``cross_k`` / ``cross_v`` at
    ``pos_full`` (``_cross_positions``); ``positions3`` (3, B, 1) is the
    VLM's M-RoPE position of the token."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == "ssm":
        y, new = ssm_lib.ssd_decode_step(p.ssm, h, cache, cfg)
        _write(cache, new)
        return x + y
    if kind == "rglru":
        y, new = rglru_lib.rglru_decode_step(p.rec, h, cache, cfg)
        _write(cache, new)
        x = x + y
    elif cfg.attention_kind == "mla":
        x = x + attention.mla_decode(p.attn, h, cache["ckv"], cache["kpe"],
                                     pos, cfg)
    else:
        att, _, _ = attention.decode_attention(p.attn, h, cache["k"],
                                               cache["v"], pos, cfg,
                                               positions3)
        x = x + att
    if p.has_cross:
        hc = rms_norm(x, p.ln_cross, cfg.norm_eps)
        x = x + attention.decode_cross_attention(
            p.cross, hc, cache["cross_k"], cache["cross_v"], pos_full, cfg)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind)[0]        # the router's aux dropped


def decode_step(model: Transformer, tokens, pos, cache, cfg: ModelConfig,
                positions3=None):
    """One decode step. tokens: (B, 1); pos: (B,) int32; positions3: (3,
    B, 1) or None (a VLM's M-RoPE position of the token; text positions of
    ``pos`` when None, as in JAX). Writes the new K/V rows and recurrent
    states into ``cache`` in place. Returns (logits (B, V) f32, cache)."""
    x = _embed(model, tokens, cfg, pos[:, None])
    pos_full = _cross_positions(cache, pos)
    for name, kind, blocks, stacked in _decoder_groups(model, cfg):
        for blk, c in zip(blocks, _layer_caches(cache[name], len(blocks),
                                                stacked)):
            x = _decode_block(blk, x, pos, c, cfg, kind, pos_full,
                              positions3)
    return _logits(model, x, cfg)[:, 0], cache


def prefill(model: Transformer, batch: dict, cfg: ModelConfig,
            cache_len: int | None = None, cache: dict | None = None):
    """Run the full-sequence forward and fill the cache: ``cache``, a
    zeroed ``init_cache`` of ``cache_len`` (the dry run passes one of
    DTensors), or a new one.

    Returns (last_logits (B, V) f32, cache). A KV cache at least as long as
    the prompt is linear (slot = position); a shorter one is a ring buffer
    holding the last ``cache_len`` positions at slot = position % cache_len.
    A recurrent layer's cache holds its state after the prompt (its
    forward's ``return_state``), cast to each leaf's dtype. The audio
    family runs its encoder once over ``batch["frames"]``; each decoder
    layer computes the cross-attention's K/V of the encoder's output once,
    for its attention and its ``cross_k`` / ``cross_v`` cache. The VLM's
    patch embeddings replace the prompt's first npatch token embeddings,
    so their K/V land in the cache, rotated by ``positions3``
    (``_splice_vision``).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    positions = _positions(b, s, tokens.device)
    x, positions3 = _splice_vision(_embed(model, tokens, cfg, positions),
                                   batch, cfg)
    enc_out = (_encode(model, batch["frames"], cfg) if cfg.is_encoder_decoder
               else None)
    if cache is None:
        cache = init_cache(cfg, b, cache_len, device=tokens.device,
                           encoder_seq=None if enc_out is None
                           else enc_out.shape[1])
    for name, kind, blocks, stacked in _decoder_groups(model, cfg):
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
                att, rows = attention.self_attention(
                    blk.attn, h, positions, cfg, positions3=positions3)
                x = x + att
                if cfg.attention_kind == "mla":
                    attention.fill_latent(c, *rows)
                else:
                    attention.fill_cache(c["k"], rows[0])
                    attention.fill_cache(c["v"], rows[1])
                if blk.has_cross:
                    hc = rms_norm(x, blk.ln_cross, cfg.norm_eps)
                    kv = attention.cross_kv(blk.cross, enc_out, cfg)
                    x = x + attention.cross_attention(blk.cross, hc, enc_out,
                                                      cfg, kv=kv)
                    c["cross_k"].copy_(kv[0])
                    c["cross_v"].copy_(kv[1])
            h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
            x = x + _ffn(blk, h2, cfg, kind)[0]   # the router's aux dropped
    return _logits(model, x[:, -1:], cfg)[:, 0], cache
