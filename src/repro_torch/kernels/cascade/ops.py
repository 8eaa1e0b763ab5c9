"""Wrapper of the cascade-wave kernel: the plain version for CPU tensors,
the CUDA kernel (``cascade.cu``) for CUDA tensors, with no fallback."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cascade import ref

#: kernel launches made by ``cascade_wave`` (CPU calls do not count)
launches = 0


def cascade_wave(c: torch.Tensor, fired: torch.Tensor, bern: torch.Tensor,
                 theta: int):
    """One parallel toppling wave; see ``ref.cascade_wave_ref``.

    c: (n, n) int32, fired: (n, n) bool, bern: (4, n, n) bool, on one device;
    on CUDA all contiguous. Returns (new_c, new_fired, n_recv).
    """
    global launches
    side = c.shape[0]
    if (c.shape != (side, side) or fired.shape != c.shape
            or bern.shape != (4, side, side)):
        raise ValueError(f"cascade_wave needs c, fired (n, n) and bern "
                         f"(4, n, n), got {tuple(c.shape)}, "
                         f"{tuple(fired.shape)}, {tuple(bern.shape)}")
    if (c.dtype != torch.int32 or fired.dtype != torch.bool
            or bern.dtype != torch.bool):
        raise ValueError(f"cascade_wave takes int32 c and bool fired/bern, "
                         f"got {c.dtype}, {fired.dtype}, {bern.dtype}")
    devices = {c.device, fired.device, bern.device}
    if devices == {torch.device("cpu")}:
        return ref.cascade_wave_ref(c, fired, bern, theta)
    if len(devices) != 1 or c.device.type != "cuda":
        raise ValueError(f"cascade_wave runs on CPU or one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not (c.is_contiguous() and fired.is_contiguous()
            and bern.is_contiguous()):
        raise ValueError("cascade_wave's kernel needs contiguous inputs")
    lib = _build.load()
    new_c = torch.empty_like(c)
    new_fired = torch.empty_like(fired)
    recv = torch.empty_like(c)
    with torch.cuda.device(c.device):
        err = lib.repro_cascade_wave(
            c.data_ptr(), fired.data_ptr(), bern.data_ptr(), side, int(theta),
            new_c.data_ptr(), new_fired.data_ptr(), recv.data_ptr(),
            _build.stream_of(c))
    _build.check(lib, err, "cascade_wave kernel launch")
    launches += 1
    return new_c, new_fired, recv
