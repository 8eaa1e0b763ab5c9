"""Pure sandpile dynamics (no weights), the statistical-mechanics oracle,
port of ``repro.core.sandpile``.

At p = 1 and theta = |N_j| the cascade rule is the BTW abelian sandpile;
for p < 1 a dissipative sandpile whose cascade sizes follow a power law
cut off near chi ~ (1 - p)^-1. This is ``core.cascade``'s counter dynamics
with the weights stripped out, so tests and benchmarks can study cascade
sizes cheaply; at p = 1 the event engine's avalanche sizes equal these.

A wave is the ``wave_fn`` seam, ``(c, fired, bern, theta) -> (new_c,
new_fired, n_recv)``: by default ``kernels.cascade.ops.cascade_wave``,
whose reset, drive and front are exactly a toppling step (the CUDA kernel
for CUDA tensors, its plain version for CPU ones). The loop reads the
front back once a wave. Draws, in JAX's key-chain order: per chain step
the site ``randint(0, side, (2,))``, the grain ``uniform(())``, then one
``uniform((4, side, side))`` per wave.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.cascade import ops as cascade_ops


class SandpileResult(NamedTuple):
    c: torch.Tensor       # (side, side) int32 counters
    size: torch.Tensor    # () int32 firing incidents
    waves: torch.Tensor   # () int32 parallel waves


def topple(c: torch.Tensor, fired0: torch.Tensor, p, theta: int, draws,
           max_waves: int | None = None, wave_fn=None) -> SandpileResult:
    """Wave-parallel toppling of counters only (matches ``core.cascade``):
    each wave resets the fired sites, drives every receiver once per fired
    neighbour with probability p, and fires the receivers at theta."""
    side = c.shape[0]
    max_waves = (8 * side * side) if max_waves is None else max_waves
    wave_fn = cascade_ops.cascade_wave if wave_fn is None else wave_fn
    fired, waves = fired0, 0
    size = torch.zeros((), dtype=torch.int32, device=c.device)
    while waves < max_waves and bool(fired.any()):  # lint: sync-ok(per wave)
        bern = draws.uniform((4, side, side)) < p
        size = size + fired.sum(dtype=torch.int32)
        c, fired, _ = wave_fn(c, fired, bern, theta)
        waves += 1
    return SandpileResult(c, size, torch.tensor(waves, dtype=torch.int32,
                                                device=c.device))


def drive(c: torch.Tensor, site, p, theta: int, draws,
          wave_fn=None) -> SandpileResult:
    """Drop one grain (w.p. p) on ``site = (row, col)``, then relax."""
    add = (draws.uniform(()) < p).to(torch.int32)
    r, col = site[0], site[1]
    c = c.clone()
    c[r, col] += add
    fired0 = torch.zeros_like(c, dtype=torch.bool)
    fired0[r, col] = c[r, col] >= theta
    return topple(c, fired0, p, theta, draws, wave_fn=wave_fn)


def run_chain(draws, side: int, steps: int, p, theta: int = 4,
              wave_fn=None) -> torch.Tensor:
    """Drive random sites for ``steps`` iterations from zero counters on
    the draw source's device; returns the (steps,) int32 cascade sizes."""
    c = torch.zeros((side, side), dtype=torch.int32, device=draws.device)
    sizes = []
    for _ in range(steps):
        site = draws.randint(0, side, (2,))
        out = drive(c, site, p, theta, draws, wave_fn=wave_fn)
        c = out.c
        sizes.append(out.size)
    if not sizes:
        return torch.zeros(0, dtype=torch.int32, device=c.device)
    return torch.stack(sizes)
