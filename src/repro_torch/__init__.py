"""PyTorch/CUDA port of the AFM (asynchronously trained feature map).

Laid out module for module like the JAX package ``repro``: plain tensor code
in PyTorch, and every kernel of the training and query path a hand-written
CUDA kernel for Hopper (``repro_torch.kernels``), each beside a plain
PyTorch version that the CPU runs. This package never imports JAX.

    from repro_torch.api import TopoMap
    tm = TopoMap(side=30, dim=784, batch=16, device="cuda").fit(xtr, ytr)
"""
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws, ReplayDraws

__all__ = ["GeneratorDraws", "ReplayDraws", "resolve_device"]
