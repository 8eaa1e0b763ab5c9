"""Device choice for every entry point of the port, the card's SM count
that the kernels' split plans size their grids to, and the switch that
keeps its float32 products exact."""
from __future__ import annotations

import contextlib
import functools

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for and there is none, so that a run
    never continues silently on the CPU."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available()"
            " is false; pass device='cpu' to run the plain PyTorch versions")
    return device


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products inside the block run in full float32, not
    TF32; the caller's setting of the switch is restored on the way out."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def exact_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32. TF32 keeps ten mantissa bits, which would
    reorder near-tied distances, so the switch is set off for this product
    rather than trusted to its default."""
    with no_tf32():
        return a @ b
