"""Plain PyTorch version of the fused training step (search, Eq. 3 merge,
counter drive and cascade waves), port of ``repro.kernels.fused.ref`` and of
what ``repro.kernels.fused.fused._fused_kernel`` computes.

``fused_step_ref`` has the CUDA kernel's signature and op order: the merge
visits only the hit units and sums each one's samples in sample order; the
drive and the waves are the staged step's plain cascade,
``kernels.cascade.ref.drive_cascade_ref`` (a wave adds the fired
neighbours' weights as ``((up + dn) + lf) + rt`` and updates every site as
``w + l_c * (sum - n_recv * w)``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.kernels.cascade import ref as cascade_ref


def merge(w: torch.Tensor, s: torch.Tensor, gmu: torch.Tensor, l_s: float):
    """Eq. 3 on a flat (N, D) weight matrix, in the kernel's form: only the
    hit units move. Each, in the order of its first sample, sums its
    samples' rows in sample order (from zeros), divides by its count and
    moves by ``w + l_s * (mean - w)``; the other rows stay. Returns (w,
    counts (N,) int32)."""
    n = w.shape[0]
    g = gmu.long()
    counts = torch.bincount(g, minlength=n).to(torch.int32)
    out = w.clone()
    # hit units, first sample first (the plain version: CPU tensors)
    for u in dict.fromkeys(g.tolist()):  # lint: sync-ok(plain version)
        tsum = torch.zeros_like(w[u])
        for k in (g == u).nonzero()[:, 0].tolist():  # lint: sync-ok(plain)
            tsum = tsum + s[k]
        mean = tsum / counts[u].to(w.dtype)
        out[u] = w[u] + l_s * (mean - w[u])
    return out, counts


def fused_step_ref(w, c2, s, l_s, l_c, drive, bern, gmu=None, *,
                   theta: int, budget: int, precision: str = "exact"):
    """What the fused kernel computes, in plain PyTorch.

    w (N, D) f32; c2 (side, side) int32; s (B, D) f32; l_s, l_c floats;
    drive (8, side, side) bool; bern (w_cap, 4, side, side) bool, wave k
    uses ``bern[k]``; gmu (B,) int32, or None to search here on the
    ``precision`` tier (``bmu_ref`` or ``bmu_bf16_ref``). At most ``budget``
    (<= w_cap) waves run; the loop stops at an empty front.

    Returns ``(w, c2, fired, stats, recv[, gmu, q2])``: ``fired`` (side,
    side) bool is the front after the last wave (non-empty only when the
    budget ran out), ``stats`` (2,) int32 is [size, waves], ``recv`` the
    per-unit receive counts; gmu and q2 only when the search ran here.
    """
    searched = gmu is None
    if searched:
        search = bmu_ref.bmu_ref if precision == "exact" else \
            bmu_ref.bmu_bf16_ref
        gmu, q2 = search(w, s)
    w, counts = merge(w, s, gmu, l_s)
    out = cascade_ref.drive_cascade_ref(
        w, c2, counts.reshape(c2.shape), drive, bern, l_c=l_c, theta=theta,
        budget=budget)
    return (out + (gmu, q2)) if searched else out
