"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), a
port of ``repro.models.rglru``.

Recurrence, per channel:
    r_t = sigmoid(x_t W_a + b_a)            (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)            (input gate)
    a_t = a ** (c r_t),  a = sigmoid(lam)   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Training and prefill run the linear recurrence as a log-depth scan in
plain PyTorch (``linear_scan``: Hillis-Steele, ceil(log2 S) passes over
the sequence), where JAX runs ``lax.associative_scan``: the sums run in
another order, so the two agree to rounding, not bit for bit. Decode
carries the (B, W) state in float32. The block is the conv1d + RG-LRU
branch gated by a GeLU branch, as in the Griffin paper.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import no_tf32
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       per_shard, replicate_dim)
from repro_torch.models.ssm import causal_conv

RG_LRU_C = 8.0


class RGLRU(nn.Module):
    """The leaves of JAX's ``init_rglru``: ``w_x`` and ``w_gate`` (d, W),
    the conv ``conv_w`` (cw, W) and ``conv_b`` and ``w_out`` (W, d) in
    ``param_dtype``; the gates ``w_a``, ``w_i`` (W, W), ``b_a``, ``b_i``
    and ``lam`` (W,) in float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, w, pd = cfg.d_model, cfg.rnn_width, cfg.param_dtype

        def leaf(shape, dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.w_x = leaf((d, w), pd)
        self.w_gate = leaf((d, w), pd)
        self.conv_w = leaf((cfg.conv_width, w), pd)
        self.conv_b = leaf((w,), pd)
        self.w_a = leaf((w, w), torch.float32)
        self.b_a = leaf((w,), torch.float32)
        self.w_i = leaf((w, w), torch.float32)
        self.b_i = leaf((w,), torch.float32)
        self.lam = leaf((w,), torch.float32)
        self.w_out = leaf((w, d), pd)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        """JAX's distributions: ``lam = logit(U(0.9, 0.999))`` (so
        sigmoid(lam) lies in [0.9, 0.999]), the dense weights truncated
        normal / √d_in (``w_out`` by 1/√(2 W L)), ``conv_w`` N(0, 0.1²),
        the biases 0."""
        d, w, pd, dev = (cfg.d_model, cfg.rnn_width, cfg.param_dtype,
                         generator.device)
        u = torch.empty(w, device=dev).uniform_(0.9, 0.999,
                                                generator=generator)
        self.lam.copy_(torch.log(u / (1.0 - u)))
        self.w_x.copy_(init_dense(generator, d, w, pd))
        self.w_gate.copy_(init_dense(generator, d, w, pd))
        self.conv_w.copy_(0.1 * torch.randn(self.conv_w.shape,
                                            generator=generator, device=dev))
        self.conv_b.zero_()
        self.w_a.copy_(init_dense(generator, w, w, torch.float32))
        self.b_a.zero_()
        self.w_i.copy_(init_dense(generator, w, w, torch.float32))
        self.b_i.zero_()
        self.w_out.copy_(init_dense(
            generator, w, d, pd, scale=1.0 / math.sqrt(w * 2 * cfg.num_layers)))


def _gates(p: RGLRU, xc):
    """xc: (..., W) f32 -> (a_t, sqrt(1 - a_t^2) i_t x_t), the
    coefficients of the recurrence; the gate products in full f32. On
    DTensors xc's width is gathered first: the gates are column-parallel
    products of the whole width."""
    xc = replicate_dim(xc, -1)
    with no_tf32():
        r = torch.sigmoid(xc @ p.w_a + p.b_a)
        i = torch.sigmoid(xc @ p.w_i + p.b_i)
    # log a_t <= 0; logsigmoid runs on the local shards of a DTensor lam
    log_a = RG_LRU_C * r * per_shard(F.logsigmoid, (p.lam,), ((0,),), (0,))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * xc


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: Hillis-Steele,
    each pass combining every position with the one ``d`` before it,
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, d = 1, 2, 4, ..."""
    d, s = 1, a.shape[1]
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gate_branch(p: RGLRU, u):
    return F.gelu(dense(u, p.w_gate).float(), approximate="tanh")


def rglru_forward(p: RGLRU, u, cfg: ModelConfig, return_state: bool = False):
    """Training and prefill. u: (B, S, D) -> (B, S, D). With
    ``return_state`` also returns the decode cache after u: ``{"conv":
    the last conv_width - 1 rows of the conv input in u's dtype, "h": (B,
    W) f32}``."""
    x = dense(u, p.w_x)
    gate = _gate_branch(p, u)
    xc = causal_conv(x, p.conv_w, p.conv_b, cfg.conv_width).float()
    h = linear_scan(*_gates(p, xc))
    out = dense((h * gate).to(u.dtype), p.w_out)
    if return_state:
        cache = {"conv": x[:, x.shape[1] - (cfg.conv_width - 1):].to(u.dtype),
                 "h": h[:, -1]}
        return out, cache
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    """Zero decode cache: ``conv`` (B, cw - 1, W) in ``dtype``, ``h`` (B,
    W) f32."""
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                         device=device)}


def rglru_decode_step(p: RGLRU, u, cache: dict, cfg: ModelConfig):
    """u: (B, 1, D). Returns (y (B, 1, D), the new cache), new tensors:
    the caller writes them where it keeps the cache."""
    x = dense(u, p.w_x)                                       # (B, 1, W)
    gate = _gate_branch(p, u)
    hist = torch.cat([cache["conv"], x.to(cache["conv"].dtype)], dim=1)
    xc = (hist.float() * p.conv_w.float()).sum(dim=1) + p.conv_b.float()
    a, b = _gates(p, xc)
    h = a * cache["h"] + b
    y = (h[:, None, :] * gate).to(u.dtype)
    return dense(y, p.w_out), {"conv": hist[:, 1:], "h": h}
