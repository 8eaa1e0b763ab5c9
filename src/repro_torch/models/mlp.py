"""Feed-forward layer of the dense family: SwiGLU, or GELU without the up
projection. A copy of ``repro.models.mlp`` (``init_mlp``, ``mlp``); the
Mixture-of-Experts layers wait for the MoE family."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import dense, init_dense


class MLP(nn.Module):
    """wg and wd, plus wu for SwiGLU; (d_in, d_out) each."""

    def __init__(self, d_model: int, d_ff: int, dtype, kind: str = "swiglu",
                 device=None):
        super().__init__()
        if kind not in ("swiglu", "gelu"):
            raise ValueError(f"mlp kind must be 'swiglu' or 'gelu', got "
                             f"{kind!r}")

        def weight(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wg = weight(d_model, d_ff)
        self.wu = weight(d_model, d_ff) if kind == "swiglu" else None
        self.wd = weight(d_ff, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         num_layers: int) -> None:
        (d_model, d_ff), dt = self.wg.shape, self.wg.dtype
        self.wg.copy_(init_dense(generator, d_model, d_ff, dt))
        if self.wu is not None:
            self.wu.copy_(init_dense(generator, d_model, d_ff, dt))
        self.wd.copy_(init_dense(generator, d_ff, d_model, dt,
                                 scale=1.0 / math.sqrt(d_ff * 2 * num_layers)))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: wd(silu(x wg) * (x wu)); GELU (no wu): wd(gelu(x wg)), the
    tanh form in f32, as ``jax.nn.gelu`` computes it by default."""
    h = dense(x, p.wg)
    if p.wu is not None:
        h = torch.nn.functional.silu(h) * dense(x, p.wu)
    else:
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(h, p.wd)
