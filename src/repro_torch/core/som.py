"""Synchronous SOM baseline (the paper's comparison target, §3.4 / Table 2),
port of ``repro.core.som``.

Classic online Kohonen SOM with a Gaussian neighbourhood on the same square
lattice, plus a batched variant for speed. Exact (centralised) BMU search,
precisely the centralisation the AFM removes: the search is
``repro_torch.kernels.bmu.ops.bmu``, the ``bmu`` CUDA kernel on CUDA
tensors and its plain version on CPU tensors.

Randomness comes from a draw source (``repro_torch.draws``) in place of the
JAX key: ``init`` asks for ``uniform((N, D))`` (with samples) or
``normal((N, D))``, and ``train`` asks for ``randint(0, num_samples, (B,))``
sample indices before each step, the order of JAX's ``split(key,
num_steps)``. The step count ``i`` is a host int and the schedules are
evaluated on the host, so on the card the training loop makes no host sync:
the data, the indices and the weights stay on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import schedules
from repro_torch.device import exact_f32_matmul, resolve_device
from repro_torch.kernels.bmu import ops as bmu_ops


@dataclasses.dataclass(frozen=True)
class SOMConfig:
    side: int = 30
    dim: int = 784
    lr0: float = 0.5
    lr_end: float = 0.01
    sigma0: float = 0.0          # 0 -> side / 2
    sigma_end: float = 1.0
    i_max: int = 0               # 0 -> 600 * N (match AFM budget)
    batch: int = 1

    @property
    def n_units(self) -> int:
        return self.side * self.side

    @property
    def total_samples(self) -> int:
        return self.i_max if self.i_max > 0 else 600 * self.n_units

    @property
    def sigma_start(self) -> float:
        return self.sigma0 if self.sigma0 > 0 else self.side / 2.0


class SOMState(NamedTuple):
    w: torch.Tensor     # (N, D) float32 unit weights
    i: int              # samples consumed so far; a host int, as AFMState.i


def init(draws, cfg: SOMConfig, samples: torch.Tensor | None = None, *,
         device: torch.device | str | None = None) -> SOMState:
    """Weights uniform in the samples' bounding box (``u * (hi - lo) + lo``
    clamped below at ``lo``, JAX's ``uniform(minval=, maxval=)``), or
    ``0.1 * N(0, 1)`` without samples, on ``device`` (CUDA unless the
    caller asks for another)."""
    device = resolve_device(device)
    shape = (cfg.n_units, cfg.dim)
    if samples is not None:
        samples = torch.as_tensor(samples, dtype=torch.float32, device=device)
        lo = samples.min(dim=0).values
        hi = samples.max(dim=0).values
        u = draws.uniform(shape).to(device)
        w = torch.maximum(lo, u * (hi - lo) + lo)
    else:
        w = 0.1 * draws.normal(shape).to(device)
    return SOMState(w.to(torch.float32).contiguous(), 0)


@functools.lru_cache(maxsize=8)
def _lattice_dist2(side: int, device: torch.device) -> torch.Tensor:
    """(N, N) squared lattice distances as float32, exact (integers below
    2^24); built once per (side, device). Callers only read it."""
    idx = torch.arange(side * side, device=device)
    r, c = idx // side, idx % side
    dr = r[:, None] - r[None, :]
    dc = c[:, None] - c[None, :]
    return (dr * dr + dc * dc).to(torch.float32)


def _rates(i: int, cfg: SOMConfig) -> tuple[float, float]:
    """The step's learning rate and its Gaussian's 2 sigma^2, float32
    values in host floats (the schedules run on the host)."""
    lr = schedules.som_lr(i, cfg.total_samples, cfg.lr0, cfg.lr_end)
    sigma = schedules.som_sigma(i, cfg.total_samples, cfg.sigma_start,
                                cfg.sigma_end)
    return float(lr), float(2.0 * sigma * sigma)


def update(state: SOMState, samples: torch.Tensor, bmu: torch.Tensor,
           cfg: SOMConfig) -> SOMState:
    """The step after its search: every unit moves toward the samples
    weighted by a Gaussian of its lattice distance to each sample's BMU
    (``bmu``, (B,) int). The batched update is a plain f32 product (never
    TF32), as JAX computes it outside any kernel."""
    lr, two_sigma2 = _rates(state.i, cfg)
    d2 = _lattice_dist2(cfg.side, state.w.device)[bmu.long()]   # (B, N)
    h = torch.exp(-d2 / two_sigma2)                              # (B, N)
    # batched update: mean over samples of h * (s - w)
    delta = exact_f32_matmul(h.T, samples) - h.sum(0)[:, None] * state.w
    w = state.w + lr * delta / samples.shape[0]
    return SOMState(w, state.i + samples.shape[0])


def train_step(state: SOMState, samples: torch.Tensor,
               cfg: SOMConfig) -> SOMState:
    """One (batched) online SOM update on (B, D) samples: the exact BMU
    search through the ``bmu`` wrapper, then ``update``."""
    bmu, _ = bmu_ops.bmu(state.w, samples)
    return update(state, samples, bmu, cfg)


def train(state: SOMState, data: torch.Tensor, draws, cfg: SOMConfig,
          num_steps: int | None = None, *,
          device: torch.device | str | None = None) -> SOMState:
    """Loop the step over (num_samples, D) data, sampled with replacement:
    each step draws ``randint(0, num_samples, (B,))`` indices first. The
    state and the data move to ``device`` (CUDA unless the caller asks for
    another); the loop reads nothing back from it."""
    num_steps = cfg.total_samples // cfg.batch if num_steps is None \
        else num_steps
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    device = resolve_device(device)
    state = SOMState(state.w.to(device).contiguous(), state.i)
    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    for _ in range(num_steps):
        idx = draws.randint(0, data.shape[0], (cfg.batch,)).to(device)
        state = train_step(state, data[idx], cfg)
    return state


def best_units(state: SOMState, data: torch.Tensor, chunk: int = 4096):
    """(idx (M,) int32, q2 (M,) float32) of every sample's BMU, through
    the ``bmu`` wrapper on chunks of at most ``chunk`` samples (the
    serving engine's top bucket)."""
    data = torch.as_tensor(data, dtype=torch.float32, device=state.w.device)
    parts = [bmu_ops.bmu(state.w, data[lo:lo + chunk].contiguous())
             for lo in range(0, data.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def quantization_error(state: SOMState, data: torch.Tensor) -> torch.Tensor:
    """Q: mean Euclidean distance of the samples to their BMU weight, a 0-d
    tensor on the state's device."""
    return torch.mean(torch.sqrt(best_units(state, data)[1]))


def predict(state: SOMState, unit_labels: torch.Tensor,
            data: torch.Tensor) -> torch.Tensor:
    """Label of each sample's BMU (``unit_labels`` from
    ``core.classifier.label_units``). Returns (M,) int32."""
    return unit_labels[best_units(state, data)[0].long()]
