"""AdamW over name-keyed dicts of tensors, port of ``repro.training.adamw``.

Mixed-precision layout, as in the JAX package: parameters may be bf16; the
first and second moments are f32, and the update is computed in f32 and
cast back to the parameter's dtype. These are plain functions, not
``torch.optim.AdamW``, which keeps bf16 moments for bf16 parameters and
decays by ``p * (1 - lr * wd)``: another computation.

Nothing here reads a tensor back to the host: the step count, learning
rate, gradient norm, clipping scale and bias corrections are 0-d tensors
on the parameters' device. ``adamw_update`` writes the new parameters and
moments **in place** (a second copy of a 1.2 B-parameter model's f32
moments would cost 9.9 GB) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.analysis import spans
from repro_torch.models.transformer import layer_of


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    mu: dict            # name -> f32 tensor, the parameter's shape
    nu: dict
    step: torch.Tensor  # () int32, on the parameters' device


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac * lr``; ``step`` a 0-d
    integer tensor, the result a 0-d f32 tensor on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _device(params: dict) -> torch.device:
    return next(iter(params.values())).device


def adamw_init(params: dict) -> AdamWState:
    """Zero f32 moments shaped like each parameter, step 0."""
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    return AdamWState(mu, nu, torch.zeros((), dtype=torch.int32,
                                          device=_device(params)))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in f32."""
    total = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to a parameter: JAX's rule, ``ndim >= 2``
    (no decay on scales and biases), on the leaf as the JAX package's tree
    holds it. That tree stacks every block's leaf of a stack on a leading
    layer axis (``blocks``, ``dense_blocks``, the hybrid's ``pat*``), so its
    rule decays the stacks' 1-D leaves too (norm scales, SSD's ``a_log``,
    RG-LRU's ``lam`` and ``b_a``: (L, d)) and not ``ln_f`` or a tail's
    (``tail*``, unstacked); the port keeps one tensor a stacked layer
    (``<stack>.<i>.…``), which counts one axis fewer."""
    return p.ndim + (layer_of(name) is not None) >= 2


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 cfg: AdamWConfig):
    """One AdamW step over ``params`` (name -> tensor) with ``grads`` of the
    same names. Returns (params, state, {"grad_norm", "lr"}), the first two
    updated in place, the metrics 0-d f32 tensors."""
    with spans.span("optimizer"):
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                             max=1.0) if cfg.grad_clip > 0
                 else torch.ones((), dtype=torch.float32, device=gnorm.device))
        lr = lr_schedule(cfg, step)
        stepf = step.float()
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)
        for name, p in params.items():
            m, v = state.mu[name], state.nu[name]
            g = grads[name].float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
            del g
            # in place where it can be: each pass over the moments is ~3 ms
            # at 1.2 B parameters on an H100
            delta = torch.div(m, b1c).div_(
                torch.div(v, b2c).sqrt_().add_(cfg.eps))
            if cfg.weight_decay > 0 and decays(name, p):
                delta.add_(p, alpha=cfg.weight_decay)
            # one rounding to p's dtype of p - lr * delta, computed in f32
            p.sub_(delta.mul_(lr))
        return params, AdamWState(state.mu, state.nu, step), {
            "grad_norm": gnorm, "lr": lr}
