"""Plain PyTorch version of the fused training step (search, Eq. 3 merge,
counter drive and cascade waves), port of ``repro.kernels.fused.ref`` and of
what ``repro.kernels.fused.fused._fused_kernel`` computes.

``fused_step_ref`` has the CUDA kernel's signature and op order: the merge
visits only the hit units and sums each one's samples in sample order; a wave
adds the fired neighbours' weights as ``((up + dn) + lf) + rt`` and updates
every site as ``w + l_c * (sum - n_recv * w)``. ``wave_loop`` runs waves
from a draw source with seedable accumulators, so the wrapper can finish a
cascade that outlived the kernel's wave budget; it also keeps the
receive-count sidecar (integer adds that draw nothing).
"""
from __future__ import annotations

import torch

from repro_torch.core import cascade as cascade_lib
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
    for u in dict.fromkeys(g.tolist()):     # hit units, first sample first
        tsum = torch.zeros_like(w[u])
        for k in (g == u).nonzero()[:, 0].tolist():
            tsum = tsum + s[k]
        mean = tsum / counts[u].to(w.dtype)
        out[u] = w[u] + l_s * (mean - w[u])
    return out, counts


def drive_from_draws(c2: torch.Tensor, gmu_mask: torch.Tensor,
                     draws: torch.Tensor) -> torch.Tensor:
    """The post-sample counter drive with the draws given: each of a unit's
    ``gmu_mask`` adaptations (at most 8) adds its draw from ``draws``
    ((8, side, side) bool)."""
    slots = torch.arange(8, device=c2.device)[:, None, None]
    inc = (draws.to(torch.int32)
           * (slots < torch.clamp(gmu_mask, max=8))).sum(dim=0,
                                                         dtype=torch.int32)
    return c2 + inc


def _run_waves(w3, c2, fired, bern_of, *, l_c, theta, limit, size, recv,
               wave_fn):
    """Up to ``limit`` waves from ``fired``, stopping at an empty front;
    wave k takes its draws from ``bern_of(k)``. One counter wave through
    ``wave_fn``; the weights take the fired neighbours' broadcasts, summed
    as ``((up + dn) + lf) + rt``. Reads the front back once per wave.
    Returns (w3, c2, fired, size, waves, recv), waves a host int."""
    waves = 0
    while waves < limit and bool(fired.any()):
        sum_wk = cascade_lib._shift_sum(w3 * fired.to(w3.dtype)[..., None])
        size = size + fired.sum(dtype=torch.int32)
        c2, fired, n_recv = wave_fn(c2, fired, bern_of(waves), theta)
        w3 = w3 + l_c * (sum_wk - n_recv.to(w3.dtype)[..., None] * w3)
        recv = recv + n_recv
        waves += 1
    return w3, c2, fired, size, waves, recv


def wave_loop(w3, c2, fired, draws, *, l_c: float, p_i: float, theta: int,
              max_waves: int, size0=0, waves0: int = 0, recv0=None,
              wave_fn=None):
    """Cascade waves from ``fired`` until the front is empty or the wave
    count, started at ``waves0``, reaches ``max_waves``; each wave draws
    ``uniform((4, side, side)) < p_i`` from ``draws``, as
    ``core.cascade.cascade`` does.

    ``size0`` (int or 0-d tensor), ``waves0`` (host int) and ``recv0``
    ((side, side) int32) seed the accumulators, so the loop can continue a
    cascade the fused kernel started. ``wave_fn`` is the counter wave
    (default: the plain ``cascade_wave_ref``). Returns (w3, c2, size, waves,
    recv); size and waves are 0-d int32 tensors on the lattice's device.
    """
    side = c2.shape[0]
    dev = c2.device
    w3, c2, _, size, waves, recv = _run_waves(
        w3, c2, fired, lambda k: draws.uniform((4, side, side)) < p_i,
        l_c=l_c, theta=theta, limit=max_waves - int(waves0),
        size=torch.as_tensor(size0, dtype=torch.int32, device=dev),
        recv=(torch.zeros((side, side), dtype=torch.int32, device=dev)
              if recv0 is None else recv0),
        wave_fn=cascade_ref.cascade_wave_ref if wave_fn is None else wave_fn)
    waves = torch.tensor(int(waves0) + waves, dtype=torch.int32, device=dev)
    return w3, c2, size, waves, recv


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
    side = c2.shape[0]
    n, d = w.shape
    dev = c2.device
    searched = gmu is None
    if searched:
        search = bmu_ref.bmu_ref if precision == "exact" else \
            bmu_ref.bmu_bf16_ref
        gmu, q2 = search(w, s)
    w, counts = merge(w, s, gmu, l_s)
    c2 = drive_from_draws(c2, counts.reshape(side, side), drive)
    w3, c2, fired, size, waves, recv = _run_waves(
        w.reshape(side, side, d), c2, c2 >= theta, lambda k: bern[k],
        l_c=l_c, theta=theta, limit=budget,
        size=torch.zeros((), dtype=torch.int32, device=dev),
        recv=torch.zeros((side, side), dtype=torch.int32, device=dev),
        wave_fn=cascade_ref.cascade_wave_ref)
    stats = torch.stack([size, torch.tensor(waves, dtype=torch.int32,
                                            device=dev)])
    out = (w3.reshape(n, d), c2, fired, stats, recv)
    return (out + (gmu, q2)) if searched else out
