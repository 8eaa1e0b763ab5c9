"""Plain PyTorch version of one cascade toppling wave (counters and receive
counts), port of ``repro.kernels.cascade.ref``:

- fired units reset to 0,
- every unit receives one broadcast per fired near neighbour,
- each receipt increments the counter iff its Bernoulli draw ``bern``
  succeeded,
- a unit newly fires if its counter reaches theta and it received >= 1.
"""
from __future__ import annotations

import torch


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
