"""Wrapper of the BMU kernel: the plain version for CPU tensors, the CUDA
kernel (``bmu.cu``) for CUDA tensors, with no fallback between the two."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bmu import ref

PRECISIONS = ("exact", "bf16")

#: kernel launches made by ``bmu`` (CPU calls do not count)
launches = 0


def bmu(w: torch.Tensor, s: torch.Tensor, *, precision: str = "exact"):
    """argmin_j |w_j - s_i|^2 over units. Returns (idx (B,) int32, q2 (B,) f32).

    ``precision`` picks the distance tier: ``'exact'`` (f32) or ``'bf16'``
    (bf16 cross term, f32 accumulate, exact-f32 polish of the winner's q2).
    w: (N, D) and s: (B, D), float32, on one device; on CUDA both must be
    contiguous.
    """
    global launches
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if w.dim() != 2 or s.dim() != 2 or w.shape[1] != s.shape[1]:
        raise ValueError(f"bmu needs w (N, D) and s (B, D), got "
                         f"{tuple(w.shape)} and {tuple(s.shape)}")
    if w.dtype != torch.float32 or s.dtype != torch.float32:
        raise ValueError(f"bmu takes float32, got {w.dtype} and {s.dtype}")
    if w.shape[0] == 0:
        raise ValueError("bmu needs at least one unit")
    if w.device.type == "cpu" and s.device.type == "cpu":
        return ref.bmu_ref(w, s) if precision == "exact" else \
            ref.bmu_bf16_ref(w, s)
    if w.device.type != "cuda" or s.device != w.device:
        raise ValueError(f"bmu runs on CPU or one CUDA device, got "
                         f"{w.device} and {s.device}")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError("bmu's kernel needs contiguous w and s")
    lib = _build.load()
    (n, d), b = w.shape, s.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=w.device)
    q2 = torch.empty(b, dtype=torch.float32, device=w.device)
    if b:
        with torch.cuda.device(w.device):
            err = lib.repro_bmu(w.data_ptr(), s.data_ptr(), n, b, d,
                                int(precision == "bf16"), idx.data_ptr(),
                                q2.data_ptr(), _build.stream_of(w))
        _build.check(lib, err, "bmu kernel launch")
        launches += 1
    if precision == "bf16":
        q2 = ref.polish(w, s, idx)
    return idx, q2
