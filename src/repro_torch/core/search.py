"""The distributed heuristic search (paper §2.1), port of ``repro.core.search``.

A sample's search is a relay race over the map:

1. **Random exploration**: for ``e`` iterations the sample hops from its
   current holder to a uniformly random far neighbour (or stays, each of the
   ``phi + 1`` choices uniform), tracking the best unit seen so far.
2. **Greedy exploitation**: from the best unit ``j*``, repeatedly move to the
   neighbour (near links; optionally also far links) with the smallest
   distance to the sample, until no neighbour improves.

Batched over B concurrent samples. Distances are squared Euclidean
(argmin-equivalent to Eq. (1)). The race is gathers, not a kernel: it stays
PyTorch ops, with ``e`` eager gathers per exploration and one host sync per
greedy step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import exact_f32_matmul


class SearchResult(NamedTuple):
    gmu: torch.Tensor           # (B,) int32, good-matching unit per sample
    q2: torch.Tensor            # (B,) float32, squared distance |w_gmu - s|^2
    greedy_steps: torch.Tensor  # (B,) int32, greedy-descent hop count
    explored: torch.Tensor      # (B,) int32, exploration hops (== e)


def _sqdist(w_rows: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    d = w_rows - s
    return torch.sum(d * d, dim=-1)


def exploration_phase(w, far, samples, draws, e: int, hop_chunk: int = 512):
    """Random exploration: (B,) start units hop over far links for e steps.

    Draws ``randint(0, N, (B,))`` start units, then all ``e`` hop choices at
    once, ``randint(0, phi + 1, (e, B))``; choice ``phi`` stays put. The path
    is integer gathers only. Its distances are then taken ``hop_chunk`` hops
    at a time, and the best unit is the *first* minimum along the path,
    which is what the sequential strict-< running minimum keeps.
    """
    b = samples.shape[0]
    n, phi = far.shape
    j = draws.randint(0, n, (b,))
    choices = draws.randint(0, phi + 1, (e, b))
    # column phi of the extended table is the unit itself ("stay")
    hop_table = torch.cat(
        [far.long(), torch.arange(n, device=far.device)[:, None]], dim=1)
    path = [j]
    for t in range(e):
        j = hop_table[j, choices[t]]
        path.append(j)
    path = torch.stack(path)                                   # (e + 1, B)
    q = torch.cat([_sqdist(w[path[lo:lo + hop_chunk]], samples)
                   for lo in range(0, e + 1, hop_chunk)])      # (e + 1, B)
    t_best = torch.argmin(q, dim=0, keepdim=True)
    return path.gather(0, t_best)[0], q.gather(0, t_best)[0]


def greedy_phase(w, near, far, samples, jstar, qstar, use_far: bool = True,
                 max_steps: int | None = None):
    """Greedy exploitation from jstar; returns (gmu, q2, steps)."""
    b = samples.shape[0]
    max_steps = w.shape[0] if max_steps is None else max_steps
    table = torch.cat([near, far], dim=-1) if use_far else near
    table = table.long()
    j, q = jstar.long(), qstar
    active = torch.ones(b, dtype=torch.bool, device=w.device)
    steps = torch.zeros(b, dtype=torch.int32, device=w.device)
    # one host sync per greedy step: the descent ends when no sample improves
    while bool(active.any()  # lint: sync-ok(one read a greedy step)
               & (steps.max() < max_steps)):
        cands = table[j]                                       # (B, C)
        valid = cands >= 0
        cq = _sqdist(w[torch.clamp(cands, min=0)], samples[:, None, :])
        cq = torch.where(valid, cq, torch.full_like(cq, float("inf")))
        kbest = torch.argmin(cq, dim=-1, keepdim=True)
        qbest = cq.gather(-1, kbest)[:, 0]
        jbest = cands.gather(-1, kbest)[:, 0]
        improve = active & (qbest < q)
        j = torch.where(improve, jbest, j)
        q = torch.where(improve, qbest, q)
        active = improve
        steps = steps + improve.to(torch.int32)
    return j.to(torch.int32), q, steps


def heuristic_search(w, near, far, samples, draws, e: int,
                     greedy_use_far: bool = True) -> SearchResult:
    """Full §2.1 search for a batch of samples. w: (N,D); samples: (B,D)."""
    jstar, qstar = exploration_phase(w, far, samples, draws, e)
    gmu, q2, steps = greedy_phase(w, near, far, samples, jstar, qstar,
                                  greedy_use_far)
    explored = torch.full(samples.shape[:1], e, dtype=torch.int32,
                          device=w.device)
    return SearchResult(gmu, q2, steps, explored)


#: Unit-axis chunk applied when ``exact_bmu`` is called without an explicit
#: ``unit_chunk``: maps up to this many units materialise one (B, N) block;
#: larger maps stream (B, 4096) blocks with a running argmin.
DEFAULT_UNIT_CHUNK = 4096


def _bmu_block(w_rows, samples, base):
    """Best unit within one block of ``w`` rows; indices offset by ``base``."""
    s2 = torch.sum(samples * samples, dim=-1)                 # (B,)
    w2 = torch.sum(w_rows * w_rows, dim=-1)                   # (n_block,)
    q2 = s2[:, None] - 2.0 * exact_f32_matmul(samples, w_rows.T) + w2[None, :]
    idx = torch.argmin(q2, dim=-1, keepdim=True)              # first minimum
    return (base + idx[:, 0]).to(torch.int32), q2.gather(-1, idx)[:, 0]


def exact_bmu(w, samples, *, unit_chunk: int | None = None):
    """Exact best-matching unit (the search's ground truth). (B,) idx, (B,) q2.

    Chunked over units to bound memory: the (B, N) distance matrix is built
    at most ``unit_chunk`` columns at a time (``DEFAULT_UNIT_CHUNK`` when
    None), folded with a running strict minimum so ties resolve to the
    lowest index exactly like a global argmin. As in the JAX package, a block
    never has a single row: the chunk is at least 2, and a one-row remainder
    joins the block before it. The CUDA kernel ``repro_torch.kernels.bmu`` is
    the fast path for this computation.
    """
    n = w.shape[0]
    chunk = DEFAULT_UNIT_CHUNK if unit_chunk is None else max(2, int(unit_chunk))
    bounds = list(range(chunk, n, chunk))
    if bounds and n - bounds[-1] < 2:
        bounds.pop()
    idx, best = _bmu_block(w[:bounds[0] if bounds else n], samples, 0)
    for lo, hi in zip(bounds, bounds[1:] + [n]):
        idx_c, best_c = _bmu_block(w[lo:hi], samples, lo)
        better = best_c < best
        idx = torch.where(better, idx_c, idx)
        best = torch.where(better, best_c, best)
    return idx, torch.clamp(best, min=0.0)


def second_bmu(w, samples):
    """Indices of best and second-best matching units (for topological
    error). Ties go to the lower index first, as ``jax.lax.top_k`` orders
    them; ``torch.topk`` does not promise that, so this takes two masked
    first-argmins instead."""
    s2 = torch.sum(samples * samples, dim=-1)
    w2 = torch.sum(w * w, dim=-1)
    q2 = s2[:, None] - 2.0 * exact_f32_matmul(samples, w.T) + w2[None, :]
    first = torch.argmin(q2, dim=-1, keepdim=True)
    masked = q2.scatter(-1, first, float("inf"))
    second = torch.argmin(masked, dim=-1)
    return first[:, 0].to(torch.int32), second.to(torch.int32)
