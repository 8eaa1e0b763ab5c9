"""Attention layers: GQA causal or sliding-window self-attention over a
full sequence (prefill, and training, which differentiates it), the
encoder's bidirectional self-attention and the decoder's cross-attention
(the audio family), and single-token decode over a KV cache or over the
cross-attention's cache of the encoder's K/V, both on the ``kernels.swa``
kernel. On the card, causal self-attention in bf16 at hd 64 or 128 takes
the ``kernels.flash`` kernels (``flash_route``).

A copy of ``repro.models.attention``. Projections are stored flattened,
(d_model, heads * head_dim); activations are reshaped to (B, S, H, hd).
Positions, in JAX's order: M-RoPE over ``positions3`` (3, B, S) when the
config has ``mrope_sections`` (the VLM; text positions when none are
given), else RoPE unless ``cfg.learned_positions`` (the audio family adds
learned position embeddings to its inputs instead).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.analysis import spans
from repro_torch.device import no_tf32
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       per_shard, replicate_partial,
                                       shard_block, whole_groups)

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
    x = whole_groups(x, -1, n_heads)
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


#: the (batch, head) dims of attention's (B, S, H, hd) operands
_BH = (0, 2)

#: calls of ``attend`` on plain CUDA tensors (calls that did not take the
#: flash kernel: cross-attention, the audio encoder, windows, ...)
plain_cuda_calls = 0


def attend(q, k, v, mask):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd); mask (1, 1, Sq, Sk). Logits and
    softmax in f32; the probabilities are cast to q's dtype before the PV
    product, as in the JAX package. Each (batch row, head) is independent:
    on DTensors it runs on the local shards (``per_shard``)."""
    global plain_cuda_calls
    from torch.distributed.tensor import DTensor
    if q.device.type == "cuda" and not isinstance(q, DTensor):
        plain_cuda_calls += 1
    return per_shard(_attend, (q, k, v, mask), (_BH, _BH, _BH, None), _BH)


def flash_route(device_type: str, dtype: torch.dtype, causal: bool,
                window: int, hd: int, impl: str, dtensor: bool,
                padded: bool) -> bool:
    """Whether a self-attention call takes the flash kernel
    (``kernels.flash``): plain (not DTensor) CUDA tensors in bf16, causal
    with no window, hd 64 or 128, on the ``naive`` path (the one that would
    call ``attend``) with no padded heads. Every other call keeps its path:
    the CPU (held to JAX), DTensor shards, the ``chunked`` path, windows,
    other head dims, the audio encoder's bidirectional attention."""
    return (device_type == "cuda" and dtype == torch.bfloat16 and causal
            and window == 0 and hd in flash_ops.HEAD_DIMS
            and impl == "naive" and not dtensor and not padded)


def _takes_flash(q, cfg: ModelConfig, causal: bool) -> bool:
    from torch.distributed.tensor import DTensor
    return flash_route(q.device.type, q.dtype, causal, cfg.window, cfg.hd,
                       cfg.attention_impl, isinstance(q, DTensor),
                       cfg.pad_heads_to > cfg.num_heads)


def _attend(q, k, v, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    with no_tf32():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def attend_chunked(q, k, v, *, window: int, chunk: int,
                   probs_bf16: bool = False):
    """Flash-style causal attention in plain tensor ops (``_attend_chunked``),
    on the local shards of DTensors as ``attend``."""
    return per_shard(functools.partial(_attend_chunked, window=window,
                                       chunk=chunk, probs_bf16=probs_bf16),
                     (q, k, v), (_BH, _BH, _BH), _BH)


def _attend_chunked(q, k, v, *, window: int, chunk: int,
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


def _positional(q, k, positions, positions3, cfg: ModelConfig):
    """q and k with their positions applied: M-RoPE over ``positions3``
    (text positions of ``positions`` when None) where the config has
    ``mrope_sections``, else RoPE unless ``cfg.learned_positions``."""
    if cfg.mrope_sections:
        p3 = (positions3 if positions3 is not None
              else rope_lib.text_positions3(positions))
        return (rope_lib.apply_mrope(q, p3, cfg.rope_theta,
                                     cfg.mrope_sections),
                rope_lib.apply_mrope(k, p3, cfg.rope_theta,
                                     cfg.mrope_sections))
    if not cfg.learned_positions:
        return (rope_lib.apply_rope(q, positions, cfg.rope_theta),
                rope_lib.apply_rope(k, positions, cfg.rope_theta))
    return q, k


def self_attention(p: Attention, x, positions, cfg: ModelConfig, *,
                   causal: bool = True, positions3=None):
    """Full-sequence self-attention (prefill and training): causal,
    sliding-window when ``cfg.window > 0``; with ``causal=False`` (the
    audio encoder) bidirectional, a zero mask and never the chunked path.
    The calls ``flash_route`` admits run the flash kernel on q, k and v
    before the GQA repeat. x: (B, S, D); positions: (B, S); positions3:
    (3, B, S) or None (the VLM's M-RoPE positions). Returns (out (B, S, D),
    (k, v) before the GQA repeat)."""
    with spans.span("attention"):
        b, s, _ = x.shape
        q = _split_heads(dense(x, p.wq), cfg.num_heads, cfg.hd)
        k = _split_heads(dense(x, p.wk), cfg.num_kv_heads, cfg.hd)
        v = _split_heads(dense(x, p.wv), cfg.num_kv_heads, cfg.hd)
        q, k = _positional(q, k, positions, positions3, cfg)
        k_pre, v_pre = k, v
        if _takes_flash(q, cfg, causal):
            out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous())
            out = out.reshape(b, s, cfg.q_dim)
            out = spans.mark_backward("attention", x, dense(out, p.wo))
            return out, (k_pre, v_pre)
        k = _repeat_kv(k, cfg.num_heads // cfg.num_kv_heads)
        v = _repeat_kv(v, cfg.num_heads // cfg.num_kv_heads)
        wo = p.wo
        n_pad = 0
        if cfg.pad_heads_to > cfg.num_heads:
            # exact zero-padding of the head axis: padded heads attend to
            # zero values and write through zero wo rows
            n_pad = cfg.pad_heads_to - cfg.num_heads
            pads = (0, 0, 0, n_pad)                # (hd, heads) of (B,S,H,hd)
            q = torch.nn.functional.pad(q, pads)
            k = torch.nn.functional.pad(k, pads)
            v = torch.nn.functional.pad(v, pads)
            wo = torch.nn.functional.pad(wo, (0, 0, 0, n_pad * cfg.hd))
        if cfg.attention_impl == "chunked" and causal:
            out = attend_chunked(q, k, v, window=cfg.window,
                                 chunk=min(cfg.attention_chunk, s),
                                 probs_bf16=cfg.attention_probs_bf16)
        else:
            mask = (_causal_mask(s, s, cfg.window, device=x.device) if causal
                    else torch.zeros((s, s), device=x.device))[None, None]
            out = attend(q, k, v, mask)
        out = out.reshape(b, s, (cfg.num_heads + n_pad) * cfg.hd)
        out = spans.mark_backward("attention", x, dense(out, wo))
        return out, (k_pre, v_pre)


def cross_kv(p: Attention, kv_src, cfg: ModelConfig):
    """The cross-attention's K and V of the encoder's output kv_src (B, Se,
    D): (B, Se, Hkv, hd) each, no RoPE. Prefill computes them once a layer
    for both the attention and the decode cache."""
    k = _split_heads(dense(kv_src, p.wk), cfg.num_kv_heads, cfg.hd)
    v = _split_heads(dense(kv_src, p.wv), cfg.num_kv_heads, cfg.hd)
    return k, v


def cross_attention(p: Attention, x, kv_src, cfg: ModelConfig, kv=None):
    """Decoder cross-attention (no RoPE, bidirectional) of x (B, S, D) over
    the encoder's output kv_src (B, Se, D), or over its ``cross_kv`` when
    ``kv`` is given. Returns (B, S, D)."""
    b, s, _ = x.shape
    q = _split_heads(dense(x, p.wq), cfg.num_heads, cfg.hd)
    k, v = kv if kv is not None else cross_kv(p, kv_src, cfg)
    k = _repeat_kv(k, cfg.num_heads // cfg.num_kv_heads)
    v = _repeat_kv(v, cfg.num_heads // cfg.num_kv_heads)
    mask = torch.zeros((1, 1, s, k.shape[1]), device=x.device)
    out = attend(q, k, v, mask)
    return dense(out.reshape(b, s, cfg.q_dim), p.wo)


def _swa(q, k, v, pos):
    """``swa_ops.swa_decode``; on a DTensor cache, its plain arithmetic
    split over the mesh (``_swa_sharded``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(k, DTensor):
        return _swa_sharded(q, k, v, pos)
    return swa_ops.swa_decode(q, k, v, pos)


def _swa_sharded(q, k, v, pos):
    """``swa_decode`` (window = the W slots) on a DTensor cache k, v (B, W,
    Hkv, hd) sharded over batch, kv heads and/or slots, as the kernel
    splits the slots across blocks: each rank keeps (m, l, acc) of the
    valid slots it holds (m -1e30, l and acc 0 where it holds none), and
    the slot shards combine as the kernel's splits do (M = max m, all-
    reduced; l and acc scaled by exp(m - M) and all-reduced). q (B, H, hd)
    and pos (B,) follow the batch and heads. Returns (B, H, hd) in q's
    dtype."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = k.device_mesh, k.placements
    w = k.shape[1]
    role = ["b" if p == Shard(0) else "h" if p == Shard(2)
            else "s" if p == Shard(1) else None for p in pl]
    q_pl = [Shard(0) if r == "b" else Shard(1) if r == "h" else Replicate()
            for r in role]
    pos_pl = [Shard(0) if r == "b" else Replicate() for r in role]
    # (splits, B, H[, hd]): the slot shards on a leading dim
    split_pl = [Shard(0) if r == "s" else Shard(1) if r == "b"
                else Shard(2) if r == "h" else Replicate() for r in role]
    block = shard_block(mesh, [m for m, r in enumerate(role) if r == "s"])

    def local(qq, kk, vv, pp):
        rep = qq.shape[1] // kk.shape[2]
        ks = kk.repeat_interleave(rep, dim=2).float()        # (b, ws, h, hd)
        vs = vv.repeat_interleave(rep, dim=2).float()
        with no_tf32():
            logits = torch.einsum("bhd,bshd->bhs", qq.float(), ks)
        logits = logits / math.sqrt(qq.shape[-1])
        j = block * kk.shape[1] + torch.arange(kk.shape[1],
                                               device=kk.device)[None]
        p64 = pp.to(torch.int64)[:, None]
        valid = (torch.remainder(p64 - j, w)
                 < torch.clamp(p64 + 1, max=w))[:, None, :]
        logits = torch.where(valid, logits, NEG_INF)
        m = logits.amax(dim=-1)
        e = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        with no_tf32():
            acc = torch.einsum("bhs,bshd->bhd", e, vs)
        return m[None], e.sum(-1)[None], acc[None]

    m, l, acc = local_map(
        local, out_placements=(split_pl, split_pl, split_pl),
        in_placements=(q_pl, pl, pl, pos_pl), device_mesh=mesh,
        redistribute_inputs=True)(q, k, v, pos)
    big_m = replicate_partial(m.amax(dim=0))
    scale = torch.exp(m - big_m)
    big_l = replicate_partial((l * scale).sum(dim=0))
    big_a = replicate_partial((acc * scale[..., None]).sum(dim=0))
    return (big_a / torch.clamp(big_l, min=1e-30)[..., None]).to(q.dtype)


def fill_cache(cache, k) -> None:
    """A prefill's K (or V) of S positions, k (B, S, Hkv, hd), into a zeroed
    cache (B, W, Hkv, hd), in place: a cache at least as long as the prompt
    is linear (slot = position); a shorter one is a ring buffer holding the
    last W positions at slot = position % W. On a DTensor cache each rank
    writes the slots it holds."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    s, w = k.shape[1], cache.shape[1]

    def fill(c, kk, lo=0):
        wl = c.shape[1]
        if w >= s:
            hi = min(lo + wl, s)
            if hi > lo:
                c[:, :hi - lo] = kk[:, lo:hi]
        else:
            c.copy_(torch.roll(kk[:, -w:], s % w, dims=1)[:, lo:lo + wl])
        return c

    if not isinstance(cache, DTensor):
        fill(cache, k)
        return
    mesh, pl = cache.device_mesh, cache.placements
    lo = shard_block(mesh, [m for m, p in enumerate(pl) if p == Shard(1)]) \
        * (w // math.prod(mesh.size(m) for m, p in enumerate(pl)
                          if p == Shard(1)))
    k_pl = [Replicate() if p == Shard(1) else p for p in pl]
    from torch.distributed.tensor.experimental import local_map
    local_map(functools.partial(fill, lo=lo), out_placements=(pl,),
              in_placements=(pl, k_pl), device_mesh=mesh,
              redistribute_inputs=True)(cache, k)


def write_rows(cache, slot, new) -> None:
    """``cache[b, slot[b]] = new[b]`` for every row b, in place, cast to the
    cache's dtype. cache (B, S, Hkv, hd); slot (B,); new (B, Hkv, hd). On a
    DTensor cache each rank writes the rows and slots it holds, the others
    left as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = \
            new.to(cache.dtype)
        return
    mesh, pl = cache.device_mesh, cache.placements
    on_slots = [m for m, p in enumerate(pl) if p == Shard(1)]
    block = shard_block(mesh, on_slots)
    # new (B, Hkv, hd) follows the cache's batch and heads; slot its batch
    new_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
              else Replicate() for p in pl]
    slot_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]

    def local(c, s, n):
        j = s.long() - block * c.shape[1]
        ok = (j >= 0) & (j < c.shape[1])
        j = torch.where(ok, j, 0)
        rows = torch.arange(c.shape[0], device=c.device)
        c[rows, j] = torch.where(ok[:, None, None], n.to(c.dtype), c[rows, j])
        return c

    from torch.distributed.tensor.experimental import local_map
    local_map(local, out_placements=(pl,), in_placements=(pl, slot_pl, new_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, slot, new)


def decode_attention(p: Attention, x, cache_k, cache_v, pos,
                     cfg: ModelConfig, positions3=None):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, S_cache, Hkv, hd) in
    x's dtype; pos: (B,) int32 absolute position of the new token;
    positions3: (3, B, 1) or None (the VLM's M-RoPE position of the token,
    text positions of ``pos`` when None).

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
    q, k = _positional(q, k, pos[:, None], positions3, cfg)
    slot = (torch.remainder(pos, s_cache) if cfg.window
            else torch.clamp(pos, max=s_cache - 1)).long()
    write_rows(cache_k, slot, k[:, 0])
    write_rows(cache_v, slot, v[:, 0])
    out = _swa(q[:, 0].contiguous(), cache_k, cache_v, pos)
    return dense(out.reshape(b, 1, cfg.q_dim), p.wo), cache_k, cache_v


def decode_cross_attention(p: Attention, x, cross_k, cross_v, pos_full,
                           cfg: ModelConfig):
    """Single-token cross-attention over one layer's cache of the encoder's
    K/V. x: (B, 1, D); cross_k/v: (B, Se, Hkv, hd) in x's dtype, contiguous;
    pos_full: (B,) int32, all Se - 1. The attention is the ``swa_decode``
    kernel: at pos = Se - 1 its ring mask over W = Se slots keeps every
    slot (age < min(pos + 1, W) holds for all), which is JAX's zero mask.
    Returns (B, 1, D)."""
    b = x.shape[0]
    q = _split_heads(dense(x, p.wq), cfg.num_heads, cfg.hd)
    out = _swa(q[:, 0].contiguous(), cross_k, cross_v, pos_full)
    return dense(out.reshape(b, 1, cfg.q_dim), p.wo)
