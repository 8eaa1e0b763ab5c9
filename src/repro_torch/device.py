"""Device choice for every entry point of the port."""
from __future__ import annotations

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


def exact_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32. TF32 keeps ten mantissa bits, which would
    reorder near-tied distances, so the switch is set off at each use rather
    than trusted to its default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b
