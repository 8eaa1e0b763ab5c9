"""Cascade-driven adaptation (paper §2.2) as parallel wave toppling, port of
``repro.core.cascade``.

Paper rules (per unit j, threshold theta shared):
  Firing:    if c_j reaches theta the unit fires: it resets c_j to 0 and
             broadcasts w_j to its 4 near neighbours.
  Adapt:     a unit receiving w_k applies  w_j += l_c(i) * (w_k - w_j).
  Drive:     every adaptation increments c_j with probability p_i.

For p_i = 1 and theta = |N_j| this is the abelian BTW sandpile, so firing
all super-threshold units at once per wave reaches the same counter fixed
point as the paper's recursive order. One cascade is a host loop over
waves; each wave is a 4-neighbour stencil on the (side, side) lattice, and
the weights take all of a wave's incoming broadcasts at once:

    w_j <- w_j + l_c * sum_{fired near neighbours k} (w_k - w_j)

The counter stencil is the ``wave_fn`` seam: the plain ``_wave`` below, or
the CUDA kernel ``repro_torch.kernels.cascade.ops.cascade_wave``; both give
the same integers. The weight update stays PyTorch ops, as the JAX package
keeps it outside its kernel. The loop reads ``any(fired)`` back once per
wave, one host sync each.

Cascade size a_i counts firing incidents (the paper's definition).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CascadeResult(NamedTuple):
    w: torch.Tensor   # (side, side, D) adapted weights
    c: torch.Tensor   # (side, side) int32 counters
    size: int | torch.Tensor   # number of firing incidents a_i: a host
                               # int from ``cascade``, a 0-d int32 tensor on
                               # the weights' device from the kernel stage
                               # (``kernels.cascade.ops.drive_cascade_stage``)
    waves: int | torch.Tensor  # number of parallel waves (as size)


def _shift_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 lattice-neighbour values, zero beyond the boundary,
    added as ((up + dn) + lf) + rt. x is (side, side) or (side, side, D)."""
    z = torch.zeros_like(x[:1])
    up = torch.cat([x[1:], z], dim=0)        # neighbour below -> value from r+1
    dn = torch.cat([z, x[:-1]], dim=0)
    zc = torch.zeros_like(x[:, :1])
    lf = torch.cat([x[:, 1:], zc], dim=1)
    rt = torch.cat([zc, x[:, :-1]], dim=1)
    return up + dn + lf + rt


def _shift4(x: torch.Tensor) -> torch.Tensor:
    """(4, side, side[, D]) stack of neighbour values (zero-padded edges), in
    slot order below, above, right, left."""
    z = torch.zeros_like(x[:1])
    zc = torch.zeros_like(x[:, :1])
    return torch.stack([
        torch.cat([x[1:], z], dim=0),
        torch.cat([z, x[:-1]], dim=0),
        torch.cat([x[:, 1:], zc], dim=1),
        torch.cat([zc, x[:, :-1]], dim=1),
    ])


def _wave(c: torch.Tensor, fired: torch.Tensor, bern: torch.Tensor,
          theta: int):
    """Plain counter wave (the contract of the cascade kernel): reset fired
    counters, apply the Bernoulli drive per received broadcast, fire newly
    super-threshold receivers. Returns (new_c, new_fired, n_recv)."""
    c = torch.where(fired, torch.zeros_like(c), c)
    recv4 = _shift4(fired.to(torch.int32))
    n_recv = recv4.sum(dim=0, dtype=torch.int32)
    c = c + (bern.to(torch.int32) * recv4).sum(dim=0, dtype=torch.int32)
    return c, (c >= theta) & (n_recv > 0), n_recv


def cascade(w: torch.Tensor, c: torch.Tensor, fired0: torch.Tensor, *,
            l_c: float, p: float, theta: int, draws,
            max_waves: int | None = None, wave_fn=None) -> CascadeResult:
    """Run one full cascade to quiescence.

    Args:
      w:       (side, side, D) float weights.
      c:       (side, side) int32 counters.
      fired0:  (side, side) bool, the initially firing units.
      l_c:     cascading learning rate l_c(i) (Eq. 5), an f32 value.
      p:       cascading probability p_i (Eq. 6), an f32 value.
      theta:   firing threshold.
      draws:   draw source; each wave draws ``uniform((4, side, side))``.
      max_waves: bound on the wave count (default 8 * side * side). A
               cascade cut short leaves its last front super-threshold; the
               next step's drive picks it up, so firings are deferred, not
               lost.
      wave_fn: counter wave ``(c, fired, bern, theta) -> (new_c, new_fired,
               n_recv)``; defaults to the plain ``_wave``.
    """
    side = c.shape[0]
    max_waves = (8 * side * side) if max_waves is None else max_waves
    wave_fn = _wave if wave_fn is None else wave_fn
    fired, size, waves = fired0, 0, 0
    while waves < max_waves:
        n_fired = int(fired.sum())          # the per-wave host sync
        if n_fired == 0:
            break
        firedf = fired.to(w.dtype)
        # weight adaptation from fired neighbours' broadcasts
        sum_wk = _shift_sum(w * firedf[..., None] if w.ndim == 3
                            else w * firedf)
        bern = draws.uniform((4, side, side)) < p
        c, new_fired, n_recv = wave_fn(c, fired, bern, theta)
        nf = n_recv.to(w.dtype)
        w = w + l_c * (sum_wk - nf[..., None] * w if w.ndim == 3
                       else sum_wk - nf * w)
        fired = new_fired
        size += n_fired
        waves += 1
    return CascadeResult(w, c, size, waves)


def drive_and_cascade(w, c, gmu_mask, *, l_c: float, p: float, theta: int,
                      draws, max_waves: int | None = None,
                      wave_fn=None) -> CascadeResult:
    """Apply the post-sample drive to GMU unit(s), then cascade if triggered.

    gmu_mask: (side, side) int32, the sample-adaptations each unit just made.
    Each adaptation increments the counter with probability p, from up to
    eight Bernoulli draws per unit, ``uniform((8, side, side)) < p``.
    """
    side = c.shape[0]
    max_count = 8
    drawn = draws.uniform((max_count, side, side)) < p
    slots = torch.arange(max_count, device=c.device)[:, None, None]
    counts = (drawn & (slots < torch.clamp(gmu_mask, max=max_count))).sum(
        dim=0, dtype=torch.int32)
    c = c + counts
    return cascade(w, c, c >= theta, l_c=l_c, p=p, theta=theta, draws=draws,
                   max_waves=max_waves, wave_fn=wave_fn)


def sequential_cascade_reference(w, c,
                                 fired_queue: list[tuple[int, int]], *,
                                 l_c: float, p: float, theta: int,
                                 seed: int):
    """Pure-Python sequential (depth-first, paper Algorithm 1) oracle.

    Validates that wave-parallel toppling matches the recursive formulation:
    identical counter fixed points and cascade sizes at p = 1 (abelian
    regime), and statistically matching weights for l_c << 1. Works on numpy
    copies.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    w = np.array(w, dtype=np.float64)
    c = np.array(c, dtype=np.int64)
    side = c.shape[0]
    stack = list(fired_queue)
    size = 0

    def neighbors(r: int, cc: int) -> list[tuple[int, int]]:
        out = []
        if r > 0:
            out.append((r - 1, cc))
        if r < side - 1:
            out.append((r + 1, cc))
        if cc > 0:
            out.append((r, cc - 1))
        if cc < side - 1:
            out.append((r, cc + 1))
        return out

    while stack:
        r, cc = stack.pop()
        if c[r, cc] < theta:
            continue
        c[r, cc] = 0
        size += 1
        for (nr, nc) in neighbors(r, cc):
            w[nr, nc] = w[nr, nc] + l_c * (w[r, cc] - w[nr, nc])
            if rng.random() < p:
                c[nr, nc] += 1
            if c[nr, nc] >= theta:
                stack.append((nr, nc))
    return w, c, size
