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
