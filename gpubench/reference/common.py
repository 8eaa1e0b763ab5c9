"""What every plain reference shares, whatever the model family: how a
product's operands are rounded (``Precision``: f32, or the control's
float8), exact f32 products with TF32 off, and the configuration's AdamW
step in f32. A family's module under ``gpubench/reference/`` names its
weights, its forward and its loss; these pieces it takes from here. Like
the families, this imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math

import torch


class Precision:
    """How the reference rounds the operands of its products: ``"f32"``
    leaves them; ``"fp8"`` rounds each to float8 e4m3 at the per-tensor
    scale ``amax / 448`` (the control, a step below the bf16 the
    configuration states)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        y = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # straight through: the rounding has the identity as its derivative
        return x + (y - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.q(a), self.q(b))


F32 = Precision("f32")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the products inside, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before




def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to every leaf of a layer and to the 2-D leaves
    outside the layers (the configuration's rule: its optimizer decays
    leaves of rank 2 or more in a tree that stacks the layers)."""
    parts = name.split(".")
    return p.dim() >= 2 or (len(parts) > 2 and parts[1].isdigit())


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``; ``step`` counts from 1.
    In f32, as the configuration's optimizer computes it."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    s = f(step)
    warm = torch.clamp(s / max(opt["warmup_steps"], 1), max=1.0)
    prog = torch.clamp((s - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = opt["min_lr_frac"] + (1.0 - opt["min_lr_frac"]) * cos
    return float(opt["lr"] * warm * frac)


@torch.no_grad()
def adamw(params: dict, grads: dict, mu: dict, nu: dict, step: int,
          opt: dict) -> None:
    """One AdamW step in f32, in place: the gradients clipped to a global
    norm of ``grad_clip``, bias-corrected moments, decoupled weight decay
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    for name, p in params.items():
        g = grads[name] * scale
        mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (mu[name] / (1 - b1 ** step)) / (
            torch.sqrt(nu[name] / (1 - b2 ** step)) + opt["eps"])
        if opt["weight_decay"] and decays(name, p):
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)


