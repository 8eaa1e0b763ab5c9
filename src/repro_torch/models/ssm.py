"""Mamba2 / SSD layer (arXiv:2405.21060, state-space duality), a port of
``repro.models.ssm``.

Training and prefill run the chunked SSD algorithm: the sequence is split
into chunks of ``ssm_chunk`` tokens; inside a chunk the quadratic
("attention-like") form runs as batched products, and the (B, H, P, N)
state is carried from chunk to chunk by a Python loop (JAX scans). Every
product of the chunk runs in float32 with TF32 off.

Decode keeps a constant-size recurrent state: the conv history (B,
conv_width - 1, d_inner) in the activation dtype and the SSM state (B, H,
P, N) in float32, O(1) a token.

Head layout: x is split into H heads of dim P (= ssm_head_dim); B and C
are shared across heads (one group); A is a per-head scalar; dt a
per-head rate.

The decay inside a chunk is ``exp(seg_i - seg_j)`` for j <= i and 0
above the diagonal. JAX computes ``where(causal, exp(rel), 0)``: above
the diagonal ``rel`` is a positive sum of up to ``ssm_chunk`` terms
``dt |a|``, whose ``exp`` overflows at mamba2-1.3b's chunk of 256, and the
backward pass of ``where`` multiplies that inf by 0 (a NaN gradient).
The port masks before the ``exp`` (``exp(-inf) = 0``): the same values
where the mask holds, exactly 0 elsewhere, and a finite gradient.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import no_tf32
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       per_shard)


class SSM(nn.Module):
    """The leaves of JAX's ``init_ssm``: the fused input projection
    ``w_in`` (d, [x (di), z gate (di), B (n), C (n), dt (h)]), the
    depthwise conv ``conv_w`` (cw, di) and ``conv_b`` in ``param_dtype``;
    ``a_log``, ``dt_bias``, ``d_skip`` (h,) and ``norm_scale`` (di,) in
    float32; ``w_out`` (di, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        pd = cfg.param_dtype

        def leaf(shape, dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.w_in = leaf((d, 2 * di + 2 * n + h), pd)
        self.conv_w = leaf((cfg.conv_width, di), pd)
        self.conv_b = leaf((di,), pd)
        self.a_log = leaf((h,), torch.float32)
        self.dt_bias = leaf((h,), torch.float32)
        self.d_skip = leaf((h,), torch.float32)
        self.norm_scale = leaf((di,), torch.float32)
        self.w_out = leaf((di, d), pd)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        """JAX's distributions: ``w_in`` truncated normal / √d, ``conv_w``
        N(0, 0.1²), ``conv_b`` 0, ``a_log = log(linspace(1, 16, h))``
        (computed in float64, rounded once), ``dt_bias`` U(-4, -1),
        ``d_skip`` 1, ``norm_scale`` 0, ``w_out`` scaled by 1/√(2 di L)."""
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        pd, dev = cfg.param_dtype, generator.device
        self.w_in.copy_(init_dense(generator, d, 2 * di + 2 * n + h, pd))
        self.conv_w.copy_(0.1 * torch.randn(self.conv_w.shape,
                                            generator=generator, device=dev))
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h,
                                                  dtype=torch.float64)))
        self.dt_bias.copy_(torch.empty(h, device=dev).uniform_(
            -4.0, -1.0, generator=generator))
        self.d_skip.fill_(1.0)
        self.norm_scale.zero_()
        self.w_out.copy_(init_dense(
            generator, di, d, pd,
            scale=1.0 / math.sqrt(di * 2 * cfg.num_layers)))


def _split_in(p: SSM, u, cfg: ModelConfig):
    """The input projection cut into x, z (activation dtype), B, C (f32)
    and dt = softplus(dt + dt_bias) (f32, (..., h))."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    x, z, bmat, cmat, dt = torch.split(dense(u, p.w_in), [di, di, n, n, h],
                                       dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    return x, z, bmat.float(), cmat.float(), dt


def _gated_out(p: SSM, y, z, cfg: ModelConfig):
    """RMS norm over the inner dim with ``(1 + norm_scale)``, gated by
    ``silu(z)``, in f32; then the output projection."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p.norm_scale)
    yf = yf * F.silu(z.float())
    return dense(yf.to(y.dtype), p.w_out)


def causal_conv(x, conv_w, conv_b, conv_width: int):
    """Depthwise causal conv over the sequence in x's dtype, as JAX sums
    it: (B, S, C) with (cw, C) taps and a (C,) bias. Each (batch row,
    channel) is independent: on DTensors it runs on the local shards."""
    return per_shard(functools.partial(_causal_conv, conv_width=conv_width),
                     (x, conv_w, conv_b), ((0, 2), (None, 1), (None, 0)),
                     (0, 2))


def _causal_conv(x, conv_w, conv_b, conv_width: int):
    s = x.shape[1]
    xp = F.pad(x, (0, 0, conv_width - 1, 0))
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, conv_width):
        out = out + xp[:, i:i + s] * conv_w[i]
    return out + conv_b


def _chunk(state, xk, bk, ck, segk, dtk, causal):
    """One chunk of SSD: (new state, y (b, q, h, p)). state (b, h, p, n);
    xk (b, q, h, p); bk, ck (b, q, n); segk, dtk (b, q, h); causal (q, q)
    bool. All f32."""
    # att[i, j] = exp(seg_i - seg_j) dt_j (c_i . b_j) for j <= i, else 0
    rel = segk[:, :, None, :] - segk[:, None, :, :]            # (b, q, q, h)
    gamma = torch.exp(rel.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bin,bjn->bij", ck, bk)
    w = gamma * cb[..., None] * dtk[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xk)
    # the carried-in state's contribution
    y_state = (torch.einsum("bin,bhpn->bihp", ck, state)
               * torch.exp(segk)[..., None])
    # the state handed to the next chunk
    coef = dtk * torch.exp(segk[:, -1:, :] - segk)             # (b, q, h)
    contrib = torch.einsum("bjn,bjhp->bhpn", bk, xk * coef[..., None])
    state = state * torch.exp(segk[:, -1])[:, :, None, None] + contrib
    return state, y_intra + y_state


def _chunks(xh, bt, ct, dtc, a_log, causal):
    """The log-decays within each chunk, then the chunk loop from a zero
    state: (the last state (b, h, p, n), y (b, nc, q, h, p)). xh (b, nc, q,
    h, p); bt, ct (b, nc, q, n); dtc (b, nc, q, h); a_log (h,)."""
    seg = torch.cumsum(dtc * -torch.exp(a_log), dim=2)       # log-decays
    b, nc, _, h, hp = xh.shape
    state = torch.zeros((b, h, hp, bt.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    ys = []
    with no_tf32():
        for c in range(nc):
            state, y = _chunk(state, xh[:, c], bt[:, c], ct[:, c], seg[:, c],
                              dtc[:, c], causal)
            ys.append(y)
    return state, torch.stack(ys, dim=1)


def ssd_forward(p: SSM, u, cfg: ModelConfig, return_state: bool = False):
    """Training and prefill forward. u: (B, S, D) -> (B, S, D).

    S is front-padded with zeros to a multiple of ``ssm_chunk`` and the
    padded outputs dropped: a padded token's projection is zero, so its B
    row is zero and it adds nothing to the state or to a later token's
    output, and its x row is the conv's own zero padding. With
    ``return_state`` also returns the decode cache after u: ``{"conv":
    the last conv_width - 1 x rows in u's dtype, "state": (B, h, p, n)
    f32}``."""
    b, s_orig, _ = u.shape
    q = cfg.ssm_chunk
    pad = (-s_orig) % q
    if pad:
        u = F.pad(u, (0, 0, pad, 0))
    s = u.shape[1]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    nc = s // q
    x, z, bmat, cmat, dt = _split_in(p, u, cfg)
    xc = F.silu(causal_conv(x, p.conv_w, p.conv_b, cfg.conv_width).float())

    xh = xc.reshape(b, nc, q, h, hp)
    bt = bmat.reshape(b, nc, q, n)
    ct = cmat.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    causal = torch.ones((q, q), dtype=torch.bool, device=u.device).tril()
    # every (batch row, head) is independent: on DTensors the chunks run
    # on the local shards
    state, y = per_shard(_chunks, (xh, bt, ct, dtc, p.a_log, causal),
                         ((0, 3), (0, None), (0, None), (0, 3), (None, 0),
                          None), ((0, 1), (0, 3)))
    y = y.reshape(b, s, h, hp)
    y = y + p.d_skip[None, None, :, None] * xc.reshape(b, s, h, hp)
    y = y.reshape(b, s, di).to(u.dtype)
    out = _gated_out(p, y, z, cfg)
    if pad:
        out = out[:, pad:]
    if return_state:
        cache = {"conv": x[:, s - (cfg.conv_width - 1):].to(u.dtype),
                 "state": state}
        return out, cache
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """Zero decode cache: ``conv`` (B, cw - 1, di) in ``dtype``, ``state``
    (B, h, p, n) f32."""
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device)}


def ssd_decode_step(p: SSM, u, cache: dict, cfg: ModelConfig):
    """u: (B, 1, D); cache from ``init_ssm_cache``. Returns (y (B, 1, D),
    the new cache), new tensors: the caller writes them where it keeps the
    cache."""
    b = u.shape[0]
    di, h, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x, z, bmat, cmat, dt = _split_in(p, u, cfg)               # x: (B, 1, di)
    hist = torch.cat([cache["conv"], x.to(cache["conv"].dtype)], dim=1)
    xc = ((hist.float() * p.conv_w.float()).sum(dim=1)
          + p.conv_b.float())
    xhp = F.silu(xc).reshape(b, h, hp)
    dt1 = dt[:, 0]                                            # (B, h)
    decay = torch.exp(dt1 * -torch.exp(p.a_log))
    state = (cache["state"] * decay[:, :, None, None]
             + (xhp * dt1[..., None])[..., None] * bmat[:, 0, None, None, :])
    with no_tf32():
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], state)
    y = y + p.d_skip[None, :, None] * xhp
    out = _gated_out(p, y.reshape(b, 1, di).to(u.dtype), z, cfg)
    return out, {"conv": hist[:, 1:], "state": state}
