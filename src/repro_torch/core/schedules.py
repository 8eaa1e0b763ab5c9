"""Training schedules from the paper (port of ``repro.core.schedules``).

- Eq. (5): cascading learning rate l_c(i), a smooth tanh ramp-down in (0, 1).
- Eq. (6): cascading probability p_i, which decouples the fractional cascade
  size A_i = a_i / N from the map size N.
- SOM baseline schedules (exponentially decaying sigma / lr).

Each returns a 0-d float32 CPU tensor: the step loop runs on the host, and
the values enter device code as exact f32 scalars.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def cascade_learning_rate(i, i_max: int, c_o: float, c_s: float):
    """Eq. (5): l_c(i) = (1 + tanh((c_o - i/i_max) / c_s)) / 2 in (0, 1)."""
    frac = _f32(i) / _f32(i_max)
    return (1.0 + torch.tanh((c_o - frac) / c_s)) / 2.0


def cascade_probability(i, i_max: int, n_units: int, c_m: float, c_d: float):
    """Eq. (6): p_i = (1 - 1/sqrt(c_m N)) (1 - i/i_max)^(c_d / N)."""
    frac = _f32(i) / _f32(i_max)
    base = 1.0 - 1.0 / torch.sqrt(_f32(c_m * n_units))
    # the base of the power is clamped so that i = i_max gives 0^x safely
    decay = torch.pow(torch.clamp(1.0 - frac, 1e-12, 1.0),
                      _f32(c_d) / _f32(n_units))
    return base * decay


def som_sigma(i, i_max: int, sigma0: float, sigma_end: float = 1.0):
    """Exponential neighbourhood-radius decay for the SOM baseline."""
    frac = _f32(i) / _f32(i_max)
    return sigma0 * torch.pow(_f32(sigma_end / sigma0), frac)


def som_lr(i, i_max: int, lr0: float, lr_end: float = 0.01):
    frac = _f32(i) / _f32(i_max)
    return lr0 * torch.pow(_f32(lr_end / lr0), frac)
