"""A frozen plain copy of the AFM probe's update (the paper's map trained
on mean-pooled hidden states), in float32: one batched step is

1. the exact search: each vector's best-matching unit, the first unit of
   least squared distance ``|v|^2 - 2 v.w + |w|^2``;
2. Eq. (3), merged: each hit unit moves by ``l_s`` towards the mean of the
   vectors that chose it;
3. the drive: each of a unit's sample adaptations (at most 8) adds 1 to
   its counter if its draw from ``uniform((8, side, side))`` is under
   ``p_i``;
4. the cascade: while some counter has reached ``theta``, a wave: the
   firing units reset to 0, each unit takes ``l_c * (sum of its fired near
   neighbours' weights - n_received * its weight)`` (the sum in the order
   below, above, right, left), and each broadcast received adds 1 to the
   counter if its draw under ``p_i``; a unit fires next wave if it reached
   ``theta`` and received one. At most ``max_waves`` waves.

``l_c`` (Eq. 5) and ``p_i`` (Eq. 6) come from the step's sample count
``i``. The draws are asked of a draw source in the order the program asks
them on its device: on the card the drive, then one block
``uniform((16, 4, side, side))`` for the first 16 waves, then
``uniform((4, side, side))`` a later wave; on the CPU the drive, then one
``uniform((4, side, side))`` a wave.
"""
from __future__ import annotations

import torch

WAVE_BLOCK = 16


def schedules(i: int, cfg: dict) -> tuple[float, float]:
    """(l_c, p_i) at sample count ``i``, in f32 as the paper's Eqs. 5-6."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    n = cfg["side"] * cfg["side"]
    frac = f(i) / f(cfg["i_max"])
    l_c = (1.0 + torch.tanh((cfg["c_o"] - frac) / cfg["c_s"])) / 2.0
    base = 1.0 - 1.0 / torch.sqrt(f(cfg["c_m"] * n))
    p_i = base * torch.pow(torch.clamp(1.0 - frac, 1e-12, 1.0),
                           f(cfg["c_d"]) / f(n))
    return float(l_c), float(p_i)


def best_units(w, v):
    d2 = (v * v).sum(-1)[:, None] - 2.0 * (v @ w.T) + (w * w).sum(-1)[None]
    return torch.argmin(d2, dim=-1)


def _shift4(x):
    z, zc = torch.zeros_like(x[:1]), torch.zeros_like(x[:, :1])
    return [torch.cat([x[1:], z], 0), torch.cat([z, x[:-1]], 0),
            torch.cat([x[:, 1:], zc], 1), torch.cat([zc, x[:, :-1]], 1)]


def step(w, c, vectors, draws, cfg: dict, i: int, block_draws: bool):
    """One update of the map ``w`` (N, D) f32 and counters ``c`` (N,)
    int32 by ``vectors`` (B, D) f32. Returns (w, c, cascade size)."""
    side, d = cfg["side"], w.shape[1]
    l_c, p_i = schedules(i, cfg)
    gmu = best_units(w, vectors)
    # Eq. 3, merged over the vectors that share a unit
    same = (gmu[:, None] == gmu[None, :]).float()
    mean = same @ vectors / same.sum(1, keepdim=True)
    w = w.clone()
    w[gmu] = w[gmu] + cfg["l_s"] * (mean - w[gmu])
    counts = torch.zeros(side * side, dtype=torch.int64, device=w.device)
    counts.index_add_(0, gmu, torch.ones_like(gmu))
    drive = draws.uniform((8, side, side)) < p_i
    slots = torch.arange(8, device=w.device)[:, None, None]
    c2 = c.view(side, side) + (drive & (slots < counts.view(side, side)
                                        .clamp(max=8))).sum(0).to(torch.int32)
    block = (draws.uniform((WAVE_BLOCK, 4, side, side)) < p_i
             if block_draws else None)
    w3, fired, size, waves = w.view(side, side, d), c2 >= cfg["theta"], 0, 0
    while waves < cfg["max_waves"] and bool(fired.any()):
        if block_draws and waves < WAVE_BLOCK:
            bern = block[waves]
        else:
            bern = draws.uniform((4, side, side)) < p_i
        sh = _shift4(w3 * fired.float()[..., None])
        sum_wk = ((sh[0] + sh[1]) + sh[2]) + sh[3]
        size += int(fired.sum())
        c2 = torch.where(fired, torch.zeros_like(c2), c2)
        recv4 = torch.stack(_shift4(fired.to(torch.int32)))
        n_recv = recv4.sum(0, dtype=torch.int32)
        c2 = c2 + (bern.to(torch.int32) * recv4).sum(0, dtype=torch.int32)
        fired = (c2 >= cfg["theta"]) & (n_recv > 0)
        w3 = w3 + l_c * (sum_wk - n_recv.float()[..., None] * w3)
        waves += 1
    return w3.reshape(-1, d), c2.reshape(-1), size
