"""Attention layers of the dense family: GQA causal or sliding-window
self-attention over a full sequence (prefill, and training, which
differentiates it), and single-token decode over a KV cache, whose
attention runs on the ``kernels.swa`` kernel.

A copy of ``repro.models.attention``. Projections are stored flattened,
(d_model, heads * head_dim); activations are reshaped to (B, S, H, hd).
Cross-attention waits for the audio family.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import no_tf32
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import ModelConfig, dense, init_dense

NEG_INF = -1e30


class Attention(nn.Module):
    """The four projections of one attention sublayer, (d_in, d_out) each."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.wq = nn.Parameter(torch.empty(d, cfg.q_dim, dtype=dt,
                                           device=device), requires_grad=False)
        self.wk = nn.Parameter(torch.empty(d, cfg.kv_dim, dtype=dt,
                                           device=device), requires_grad=False)
        self.wv = nn.Parameter(torch.empty(d, cfg.kv_dim, dtype=dt,
                                           device=device), requires_grad=False)
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, d, dtype=dt,
                                           device=device), requires_grad=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        d, dt = cfg.d_model, cfg.param_dtype
        self.wq.copy_(init_dense(generator, d, cfg.q_dim, dt))
        self.wk.copy_(init_dense(generator, d, cfg.kv_dim, dt))
        self.wv.copy_(init_dense(generator, d, cfg.kv_dim, dt))
        self.wo.copy_(init_dense(
            generator, cfg.q_dim, d, dt,
            scale=1.0 / math.sqrt(cfg.q_dim * 2 * cfg.num_layers)))


def _split_heads(x, n_heads, hd):
    return x.reshape(x.shape[:-1] + (n_heads, hd))


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _causal_mask(s_q: int, s_k: int, window: int, device=None):
    """(s_q, s_k) additive f32 mask. window=0 -> plain causal."""
    qi = torch.arange(s_q, device=device)[:, None]
    ki = torch.arange(s_k, device=device)[None, :]
    ok = ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attend(q, k, v, mask):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd); mask broadcastable to (B,H,Sq,Sk).
    Logits and softmax in f32; the probabilities are cast to q's dtype
    before the PV product, as in the JAX package."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    with no_tf32():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def attend_chunked(q, k, v, *, window: int, chunk: int,
                   probs_bf16: bool = False):
    """Flash-style causal attention in plain tensor ops: a loop over KV
    chunks with an online-softmax accumulator, so the largest buffer is
    (B, Sq, H, chunk) instead of (B, H, Sq, Sk). Nothing here is
    rematerialised by itself: in training the block's checkpoint
    (``transformer.forward_hidden`` under ``cfg.remat``) recomputes the
    loop in the backward pass, so only the block's input is kept."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % chunk:
        raise ValueError(f"attend_chunked needs the key length {sk} to be a "
                         f"multiple of the chunk {chunk}")
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for idx in range(sk // chunk):
        kk = k[:, idx * chunk:(idx + 1) * chunk]
        vv = v[:, idx * chunk:(idx + 1) * chunk]
        ki = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        ok = ki <= qi
        if window > 0:
            ok &= ki > qi - window
        blk_mask = torch.where(ok, 0.0, NEG_INF)[None, :, None, :]  # (1,Sq,1,C)
        with no_tf32():
            logits = torch.einsum("bqhd,bkhd->bqhk", qf, kk.float()) + blk_mask
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            if probs_bf16:
                pv = torch.einsum("bqhk,bkhd->bqhd", p.bfloat16().float(),
                                  vv.bfloat16().float())
            else:
                pv = torch.einsum("bqhk,bkhd->bqhd", p, vv.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def self_attention(p: Attention, x, positions, cfg: ModelConfig):
    """Causal full-sequence self-attention (prefill and training),
    sliding-window when
    ``cfg.window > 0``. x: (B, S, D); positions: (B, S). Returns
    (out (B, S, D), (k, v) before the GQA repeat)."""
    b, s, _ = x.shape
    q = _split_heads(dense(x, p.wq), cfg.num_heads, cfg.hd)
    k = _split_heads(dense(x, p.wk), cfg.num_kv_heads, cfg.hd)
    v = _split_heads(dense(x, p.wv), cfg.num_kv_heads, cfg.hd)
    q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    k_pre, v_pre = k, v
    k = _repeat_kv(k, cfg.num_heads // cfg.num_kv_heads)
    v = _repeat_kv(v, cfg.num_heads // cfg.num_kv_heads)
    wo = p.wo
    n_pad = 0
    if cfg.pad_heads_to > cfg.num_heads:
        # exact zero-padding of the head axis: padded heads attend to zero
        # values and write through zero wo rows
        n_pad = cfg.pad_heads_to - cfg.num_heads
        pads = (0, 0, 0, n_pad)                    # (hd, heads) of (B,S,H,hd)
        q = torch.nn.functional.pad(q, pads)
        k = torch.nn.functional.pad(k, pads)
        v = torch.nn.functional.pad(v, pads)
        wo = torch.nn.functional.pad(wo, (0, 0, 0, n_pad * cfg.hd))
    if cfg.attention_impl == "chunked":
        out = attend_chunked(q, k, v, window=cfg.window,
                             chunk=min(cfg.attention_chunk, s),
                             probs_bf16=cfg.attention_probs_bf16)
    else:
        mask = _causal_mask(s, s, cfg.window, device=x.device)[None, None]
        out = attend(q, k, v, mask)
    out = out.reshape(b, s, (cfg.num_heads + n_pad) * cfg.hd)
    return dense(out, wo), (k_pre, v_pre)


def decode_attention(p: Attention, x, cache_k, cache_v, pos,
                     cfg: ModelConfig):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, S_cache, Hkv, hd) in
    x's dtype; pos: (B,) int32 absolute position of the new token.

    With ``cfg.window > 0`` the cache is a ring buffer of S_cache slots
    (slot = pos % S_cache); else slot = min(pos, S_cache - 1). The new K/V
    row is written into the cache **in place** (the JAX package returns new
    arrays; a copy of a long cache per step would cost more than the
    attention). The attention over the cache is the ``swa_decode`` kernel,
    whose ring mask with W = S_cache is, for a linear cache, exactly
    ``j <= pos``. Returns (out (B, 1, D), cache_k, cache_v).
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    q = _split_heads(dense(x, p.wq), cfg.num_heads, cfg.hd)
    k = _split_heads(dense(x, p.wk), cfg.num_kv_heads, cfg.hd)
    v = _split_heads(dense(x, p.wv), cfg.num_kv_heads, cfg.hd)
    q = rope_lib.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = rope_lib.apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = (torch.remainder(pos, s_cache) if cfg.window
            else torch.clamp(pos, max=s_cache - 1)).long()
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    out = swa_ops.swa_decode(q[:, 0].contiguous(), cache_k, cache_v, pos)
    return dense(out.reshape(b, 1, cfg.q_dim), p.wo), cache_k, cache_v
