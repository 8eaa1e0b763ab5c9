"""Plain PyTorch versions of the cascade kernels (``cascade.cu``), port of
``repro.kernels.cascade.ref`` and of the loop JAX runs around its wave
kernel (``repro.core.cascade.drive_and_cascade``).

One toppling wave, ``cascade_wave_ref`` (counters and receive counts):

- fired units reset to 0,
- every unit receives one broadcast per fired near neighbour,
- each receipt increments the counter iff its Bernoulli draw ``bern``
  succeeded,
- a unit newly fires if its counter reaches theta and it received >= 1.

A staged step's drive and cascade with the draws given,
``drive_cascade_ref``: the 8-draw counter drive (``drive_from_draws``), then
up to ``budget`` waves (``_run_waves``), wave k on ``bern[k]``. A wave adds
the fired neighbours' weights as ``((up + dn) + lf) + rt`` and updates
every site as ``w + l_c * (sum - n_recv * w)``, the kernels' op order.
``wave_loop`` runs waves from a draw source with seedable accumulators, so
the wrappers can finish a cascade that outlived a kernel's wave budget.
The fused step's plain version (``kernels.fused.ref``) runs the same
functions after its search and merge: there is one plain cascade.
"""
from __future__ import annotations

import torch

from repro_torch.core import cascade as cascade_lib


def _shift4(x):
    z = torch.zeros_like(x[:1])
    zc = torch.zeros_like(x[:, :1])
    return torch.stack([
        torch.cat([x[1:], z], dim=0),        # from below (row r+1)
        torch.cat([z, x[:-1]], dim=0),       # from above (row r-1)
        torch.cat([x[:, 1:], zc], dim=1),    # from right
        torch.cat([zc, x[:, :-1]], dim=1),   # from left
    ])


def cascade_wave_ref(c: torch.Tensor, fired: torch.Tensor, bern: torch.Tensor,
                     theta: int):
    """c: (n, n) int32; fired: (n, n) bool; bern: (4, n, n) bool.

    Returns (new_c int32, new_fired bool, n_recv int32), all (n, n).
    """
    c = torch.where(fired, torch.zeros_like(c), c)
    recv4 = _shift4(fired.to(torch.int32))
    n_recv = recv4.sum(dim=0, dtype=torch.int32)
    new_c = c + (bern.to(torch.int32) * recv4).sum(dim=0, dtype=torch.int32)
    return new_c, (new_c >= theta) & (n_recv > 0), n_recv


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
    while waves < limit and bool(fired.any()):  # lint: sync-ok(one a wave)
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
    cascade a kernel started. ``wave_fn`` is the counter wave (default: the
    plain ``cascade_wave_ref``). Returns (w3, c2, size, waves, recv); size
    and waves are 0-d int32 tensors on the lattice's device.
    """
    side = c2.shape[0]
    dev = c2.device
    w3, c2, _, size, waves, recv = _run_waves(
        w3, c2, fired, lambda k: draws.uniform((4, side, side)) < p_i,
        l_c=l_c, theta=theta, limit=max_waves - int(waves0),
        size=torch.as_tensor(size0, dtype=torch.int32, device=dev),
        recv=(torch.zeros((side, side), dtype=torch.int32, device=dev)
              if recv0 is None else recv0),
        wave_fn=cascade_wave_ref if wave_fn is None else wave_fn)
    waves = torch.tensor(int(waves0) + waves, dtype=torch.int32, device=dev)
    return w3, c2, size, waves, recv


def drive_cascade_ref(w, c2, counts, drive, bern, *, l_c: float, theta: int,
                      budget: int):
    """What ``drive_cascade_kernel`` computes, in plain PyTorch: JAX's
    ``drive_and_cascade`` with its draws given, for at most ``budget`` waves.

    w (N, D) f32, the merge's output; c2 (side, side) int32; counts (side,
    side) int32, the sample adaptations of each unit; drive (8, side, side)
    bool; bern (w_cap, 4, side, side) bool, wave k uses ``bern[k]``;
    ``budget`` <= w_cap. The loop stops at an empty front.

    Returns ``(w, c2, fired, stats, recv)``: ``fired`` (side, side) bool is
    the front after the last wave (non-empty only when the budget ran out),
    ``stats`` (2,) int32 is [size, waves], ``recv`` the per-unit receive
    counts.
    """
    side = c2.shape[0]
    n, d = w.shape
    dev = c2.device
    c2 = drive_from_draws(c2, counts, drive)
    w3, c2, fired, size, waves, recv = _run_waves(
        w.reshape(side, side, d), c2, c2 >= theta, lambda k: bern[k],
        l_c=l_c, theta=theta, limit=budget,
        size=torch.zeros((), dtype=torch.int32, device=dev),
        recv=torch.zeros((side, side), dtype=torch.int32, device=dev),
        wave_fn=cascade_wave_ref)
    stats = torch.stack([size, torch.tensor(waves, dtype=torch.int32,
                                            device=dev)])
    return w3.reshape(n, d), c2, fired, stats, recv
