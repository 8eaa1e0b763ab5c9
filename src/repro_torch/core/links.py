"""Link construction for the AFM lattice (port of ``repro.core.links``).

Units live on a ``side x side`` square lattice. Two link kinds:

- **near links**: the 4-neighbour lattice (Manhattan distance <= 1), used by
  the greedy search phase and by cascade-driven adaptation;
- **far links**: ``phi`` long-range links per unit, drawn with probability
  proportional to ``D_jk^-1`` (Manhattan distance in unit space).

Two exact samplers: a categorical one (Gumbel-max over one distance row per
unit, fine up to ~10k units) and a ring/rejection sampler that is O(phi) per
unit. Both take their randomness from a draw source (``repro_torch.draws``),
so the tables are not the JAX package's bits: a parity test carries the JAX
tables over, and holds these samplers to the distribution instead.
"""
from __future__ import annotations

import torch

NEAR_DEGREE = 4  # square lattice


def unit_coords(side: int, device=None) -> torch.Tensor:
    """(N, 2) int32 array of (row, col) for each unit, row-major."""
    idx = torch.arange(side * side, dtype=torch.int32, device=device)
    return torch.stack([idx // side, idx % side], dim=-1)


def near_neighbor_table(side: int, device=None) -> torch.Tensor:
    """(N, 4) int32 table of lattice neighbours; -1 pads missing edges.

    Order: up, down, left, right.
    """
    idx = torch.arange(side * side, dtype=torch.int32, device=device)
    r, c = idx // side, idx % side
    none = torch.full_like(idx, -1)
    up = torch.where(r > 0, idx - side, none)
    dn = torch.where(r < side - 1, idx + side, none)
    lf = torch.where(c > 0, idx - 1, none)
    rt = torch.where(c < side - 1, idx + 1, none)
    return torch.stack([up, dn, lf, rt], dim=-1)


def manhattan_row(side: int, j) -> torch.Tensor:
    """Manhattan distances from unit(s) ``j`` to every unit: (N,) for a
    scalar ``j``, (len(j), N) for a 1-d tensor of units."""
    j = torch.as_tensor(j)
    idx = torch.arange(side * side, dtype=torch.int32, device=j.device)
    rj, cj = (j // side).unsqueeze(-1), (j % side).unsqueeze(-1)
    return (torch.abs(idx // side - rj) + torch.abs(idx % side - cj)).to(
        torch.int32)


def far_links_categorical(draws, side: int, phi: int,
                          unit_chunk: int = 256) -> torch.Tensor:
    """(N, phi) far-link table; P(j -> k) ∝ D_jk^-1, k != j. Exact, O(N^2).

    Gumbel-max over the log-weights, as ``jax.random.categorical`` samples;
    units are processed ``unit_chunk`` at a time to bound the (chunk, phi, N)
    noise tensor.
    """
    n = side * side
    out = []
    for lo in range(0, n, unit_chunk):
        js = torch.arange(lo, min(lo + unit_chunk, n), dtype=torch.int32,
                          device=draws.device)
        d = manhattan_row(side, js).to(torch.float32)             # (m, N)
        logits = torch.where(d > 0, -torch.log(d),
                             torch.full_like(d, -float("inf")))
        u = draws.uniform((len(js), phi, n))
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        out.append(torch.argmax(logits[:, None, :] + gumbel, dim=-1))
    return torch.cat(out).to(torch.int32)


def far_links_ring(draws, side: int, phi: int, rounds: int = 64
                   ) -> torch.Tensor:
    """(N, phi) far-link table via exact rejection sampling.

    P(d) ∝ (ring size 4d) * d^-1 = const, so d ~ Uniform[1, 2(side-1)]; a
    point uniform on the Manhattan ring of radius d; off-lattice points are
    rejected. Conditional on acceptance this is exactly ∝ D^-1 restricted to
    the lattice. Falls back to a uniform other unit if all ``rounds`` reject
    (vanishing probability for rounds ~ 64).
    """
    n = side * side
    dmax = 2 * (side - 1)
    j = torch.arange(n, device=draws.device)[:, None, None]        # (N,1,1)
    r0, c0 = j // side, j % side
    d = draws.randint(1, dmax + 1, (n, phi, rounds))
    # t uniform in [0, 4d): the ring has 4d points
    t = torch.clamp((draws.uniform((n, phi, rounds)) * (4 * d)).long(),
                    max=4 * d - 1)
    quad, off = t // d, t % d
    dr = torch.stack([off, d - off, -off, -(d - off)]).gather(
        0, quad[None]).squeeze(0)
    dc = torch.stack([d - off, -off, -(d - off), off]).gather(
        0, quad[None]).squeeze(0)
    rr, cc = r0 + dr, c0 + dc
    ok = (rr >= 0) & (rr < side) & (cc >= 0) & (cc < side)
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)  # first hit
    cand = (rr * side + cc).gather(-1, first).squeeze(-1)
    fallback = (j[..., 0] + 1 + draws.randint(0, n - 1, (n, phi))) % n
    return torch.where(ok.any(-1), cand, fallback).to(torch.int32)


def far_links(draws, side: int, phi: int,
              exact_threshold: int = 10_000) -> torch.Tensor:
    """Dispatch: categorical sampler for small maps, ring sampler for large."""
    if side * side <= exact_threshold:
        return far_links_categorical(draws, side, phi)
    return far_links_ring(draws, side, phi)
