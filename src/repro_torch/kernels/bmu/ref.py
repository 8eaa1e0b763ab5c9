"""Plain PyTorch versions of the BMU kernel: the exact-f32 tier
(``bmu_ref``) and the bf16 tier (``bmu_bf16_ref``), ports of
``repro.kernels.bmu.ref``."""
from __future__ import annotations

import torch

from repro_torch.device import no_tf32


def bmu_ref(w: torch.Tensor, s: torch.Tensor):
    """w: (N, D) unit weights; s: (B, D) samples.

    Returns (idx (B,) int32, q2 (B,) float32): argmin_j |w_j - s_i|^2 (lowest
    index on ties) and the squared distance, clamped at >= 0.
    """
    w = w.to(torch.float32)
    s = s.to(torch.float32)
    w2 = torch.sum(w * w, dim=-1)
    s2 = torch.sum(s * s, dim=-1)
    with no_tf32():                  # exact f32, never TF32
        q2 = s2[:, None] - 2.0 * (s @ w.T) + w2[None, :]
    idx = torch.argmin(q2, dim=-1, keepdim=True)
    return idx[:, 0].to(torch.int32), torch.clamp(q2.gather(-1, idx)[:, 0],
                                                  min=0.0)


def bmu_bf16_ref(w: torch.Tensor, s: torch.Tensor):
    """bf16 tier: the cross term from bf16-rounded inputs with f32
    accumulation ranks the units; the winner's distance is then computed
    again in exact f32 ("polish"). Not bitwise against ``bmu_ref``: index
    agreement and a q2 bound instead. Outputs keep the exact tier's dtypes.
    """
    w = w.to(torch.float32)
    s = s.to(torch.float32)
    w2 = torch.sum(w * w, dim=-1)
    s2 = torch.sum(s * s, dim=-1)
    # bf16 products are exact in f32, so an f32 product of the rounded
    # values is the bf16-multiply, f32-accumulate cross term
    with no_tf32():
        cross = s.to(torch.bfloat16).to(torch.float32) @ \
            w.to(torch.bfloat16).to(torch.float32).T
    idx = torch.argmin(s2[:, None] - 2.0 * cross + w2[None, :], dim=-1)
    return idx.to(torch.int32), polish(w, s, idx)


def bmu_split_ref(w: torch.Tensor, s: torch.Tensor, plan, *,
                  precision: str = "exact"):
    """The kernel's split-and-merge arithmetic in plain PyTorch (for tests):
    each split of ``plan`` (an ``ops.Plan``) reduces its units to a
    per-sample (min of |w|^2 - 2 w.s, lowest argmin), an empty split gives
    (+inf, n); the partials merge in split order, a tie to the lower index;
    then |s|^2 is added and the sum clamped at >= 0. The bf16 tier ranks
    with bf16-rounded operands and polishes the winner's q2 in exact f32.
    """
    w = w.to(torch.float32)
    s = s.to(torch.float32)
    n = w.shape[0]
    w2 = torch.sum(w * w, dim=-1)
    s2 = torch.sum(s * s, dim=-1)
    ws, ss = (w, s) if precision == "exact" else (
        w.to(torch.bfloat16).to(torch.float32),
        s.to(torch.bfloat16).to(torch.float32))
    with no_tf32():
        q = w2[None, :] - 2.0 * (ss @ ws.T)
    best = torch.full((s.shape[0],), float("inf"))
    best_i = torch.full((s.shape[0],), n, dtype=torch.int64)
    for split in range(plan.splits):
        lo, hi = plan.unit_range(split)
        if lo >= hi:
            continue                  # (+inf, n) never wins
        i = torch.argmin(q[:, lo:hi], dim=-1) + lo
        v = q.gather(-1, i[:, None])[:, 0]
        take = (v < best) | ((v == best) & (i < best_i))
        best = torch.where(take, v, best)
        best_i = torch.where(take, i, best_i)
    idx = best_i.to(torch.int32)
    if precision == "bf16":
        return idx, polish(w, s, idx)
    return idx, torch.clamp(best + s2, min=0.0)


def polish(w: torch.Tensor, s: torch.Tensor, idx: torch.Tensor):
    """Exact-f32 squared distance of each sample to its chosen unit."""
    dw = w[idx.long()] - s
    return torch.clamp(torch.sum(dw * dw, dim=-1), min=0.0)


def tie_bound(w: torch.Tensor, s: torch.Tensor):
    """(B,) worst-case disagreement of two f32 evaluations of the expanded
    distance |s|^2 - 2 w.s + |w|^2 that sum their D terms in different
    orders: each is within 2·D·eps·(|s|^2 + |w|^2) of the exact value, so
    two differ by at most 4·D·eps·(|s|^2 + max_j |w_j|^2). The bound is
    relative to those terms, not to q2, because the expanded form cancels
    them. Two implementations may pick different units only where the
    exact top-two gap is below it.
    """
    scale = torch.sum(s * s, dim=-1) + torch.max(torch.sum(w * w, dim=-1))
    return 4 * w.shape[1] * torch.finfo(torch.float32).eps * scale


def top2_gap(w: torch.Tensor, s: torch.Tensor):
    """(B,) gap between the best and second-best exact distances."""
    d = torch.cdist(s.double(), w.double()) ** 2
    top = torch.topk(d, min(2, w.shape[0]), dim=-1, largest=False).values
    return (top[:, -1] - top[:, 0]).float()
