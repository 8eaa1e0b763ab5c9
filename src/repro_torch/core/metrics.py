"""Map-quality metrics (paper §3 + §2.1 search error), port of
``repro.core.metrics``.

- Quantization error Q: mean distance of samples to their BMU weight.
- Topological error T: fraction of samples whose best and second-best units
  are not lattice-adjacent.
- Search error F: fraction of heuristic searches whose GMU != exact BMU.
"""
from __future__ import annotations

import torch

from repro_torch.core import search as search_lib


def quantization_error(w: torch.Tensor, samples: torch.Tensor,
                       chunk: int = 4096) -> torch.Tensor:
    """Q = mean_i min_j |w_j - s_i| (Euclidean, per the paper), chunked to
    bound the (chunk, N) distance matrix."""
    total = torch.zeros((), dtype=torch.float32, device=w.device)
    m = samples.shape[0]
    for lo in range(0, m, chunk):
        _, q2 = search_lib.exact_bmu(w, samples[lo:lo + chunk])
        total = total + torch.sum(torch.sqrt(q2))
    return total / m


def topological_error(w: torch.Tensor, samples: torch.Tensor,
                      side: int) -> torch.Tensor:
    """T = fraction of samples whose BMU and 2nd BMU are not near-linked."""
    b1, b2 = search_lib.second_bmu(w, samples)
    manhattan = (torch.abs(b1 // side - b2 // side)
                 + torch.abs(b1 % side - b2 % side))
    return torch.mean((manhattan > 1).to(torch.float32))


def u_matrix(w: torch.Tensor, side: int) -> torch.Tensor:
    """(side, side) float64 mean distance of each unit to its lattice
    neighbours (low = coherent region), the classic U-matrix view."""
    w = w.reshape(side, side, -1)
    dists = torch.zeros((side, side), dtype=torch.float64, device=w.device)
    norms = torch.zeros_like(dists)
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        r0, r1 = max(dr, 0), side + min(dr, 0)
        q0, q1 = max(dc, 0), side + min(dc, 0)
        d = torch.linalg.vector_norm(
            w[r0:r1, q0:q1] - w[r0 - dr:r1 - dr, q0 - dc:q1 - dc], dim=-1)
        dists[r0:r1, q0:q1] += d
        norms[r0:r1, q0:q1] += 1.0
    return dists / norms


def search_error(w, near, far, samples, draws, e: int,
                 greedy_use_far: bool = True):
    """F over a probe batch: GMU (heuristic) vs BMU (exact) disagreement."""
    res = search_lib.heuristic_search(w, near, far, samples, draws, e,
                                      greedy_use_far=greedy_use_far)
    bmu, _ = search_lib.exact_bmu(w, samples)
    return torch.mean((res.gmu != bmu).to(torch.float32)), res
