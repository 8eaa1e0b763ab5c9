"""Plain PyTorch version of the sliding-window decode kernel, a port of
``repro.kernels.swa.ref.swa_decode_ref``."""
from __future__ import annotations

import math

import torch

from repro_torch.device import no_tf32

NEG_INF = -1e30


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, window: int) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, Hkv, hd) ring-buffer cache (slot = t % S);
    pos: (B,) absolute position of the current token (its K/V already
    written). Slot j is valid iff (pos - j) mod S < min(pos + 1, window).

    Returns (B, H, hd): the attention output in f32 math, cast to q's dtype.
    It repeats K and V to (B, S, H, hd) in f32, so its memory grows with H.
    """
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kk = k.repeat_interleave(rep, dim=2).float()            # (B, S, H, hd)
    vv = v.repeat_interleave(rep, dim=2).float()
    with no_tf32():
        logits = torch.einsum("bhd,bshd->bhs", q.float(), kk)
    logits = logits / math.sqrt(hd)
    j = torch.arange(s, device=q.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    age = torch.remainder(pos - j, s)                      # non-negative
    valid = age < torch.clamp(pos + 1, max=window)
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    with no_tf32():
        out = torch.einsum("bhs,bshd->bhd", probs, vv)
    return out.to(q.dtype)


def swa_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's split-and-combine arithmetic in plain PyTorch (for
    tests), over a W = k.shape[1] ring as ``swa_decode_ref`` with window W.

    Split i of ``plan`` (an ``ops.Plan``) takes the valid slots of
    [i * slots, (i + 1) * slots) and keeps (m, l, acc) in base 2 (logits
    q . k * log2(e) / sqrt(hd)); a split with no valid slot keeps
    (-1e30, 0, 0). The splits combine in order: M = max m,
    L = sum l 2^(m - M), A = sum acc 2^(m - M), out = A / max(L, 1e-30).
    """
    b, h, hd = q.shape
    w, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kk = k.repeat_interleave(rep, dim=2).float()            # (B, W, H, hd)
    vv = v.repeat_interleave(rep, dim=2).float()
    scale = math.log2(math.e) / math.sqrt(hd)
    with no_tf32():
        logits = torch.einsum("bhd,bshd->bhs", q.float() * scale, kk)
    j = torch.arange(w, device=q.device)
    nv = torch.clamp(pos.to(torch.int64) + 1, max=w)[:, None, None]
    big = torch.full((), NEG_INF, device=q.device)
    parts = []
    for split in range(plan.splits):
        lo, hi = split * plan.slots, min((split + 1) * plan.slots, w)
        valid = (j[lo:hi][None, None, :] < nv)
        s = torch.where(valid, logits[..., lo:hi], big)
        m = torch.max(s, dim=-1, keepdim=True).values       # -1e30 if none
        p = torch.where(valid, torch.exp2(s - m), torch.zeros((), device=q.device))
        with no_tf32():
            acc = torch.einsum("bhs,bshd->bhd", p, vv[:, lo:hi])
        parts.append((m[..., 0], p.sum(-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    lsum = torch.zeros_like(mx)
    a = torch.zeros((b, h, hd), device=q.device)
    for m, l_, acc in parts:
        sc = torch.exp2(m - mx)
        lsum = lsum + l_ * sc
        a = a + acc * sc[..., None]
    return (a / torch.clamp(lsum, min=1e-30)[..., None]).to(q.dtype)
