"""Wrapper of the sliding-window decode kernel: the plain version for CPU
tensors, the CUDA kernel (``swa.cu``) for CUDA tensors, with no fallback."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa import ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)
MAX_REP = 8

#: kernel launches made by ``swa_decode`` (CPU calls do not count)
launches = 0


def _check(q, k, v, pos) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"swa_decode needs q (B, H, hd) and k, v "
                         f"(B, W, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, h, hd), (bk, w, hkv, hdk) = q.shape, k.shape
    if bk != b or hdk != hd or pos.shape != (b,) or w < 1:
        raise ValueError(f"swa_decode: shapes disagree: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}, pos {tuple(pos.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa_decode takes head dims {HEAD_DIMS}, got {hd}")
    if hkv < 1 or h % hkv or not 1 <= h // hkv <= MAX_REP:
        raise ValueError(f"swa_decode needs H a multiple of Hkv with "
                         f"1 <= H / Hkv <= {MAX_REP}, got H {h}, Hkv {hkv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"swa_decode takes q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32:
        raise ValueError(f"swa_decode takes int32 positions, got {pos.dtype}")


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Flash decode of one query token per head over a ring-buffer cache of
    W = k.shape[1] slots; see ``ref.swa_decode_ref`` (window = W).

    q: (B, H, hd); k, v: (B, W, Hkv, hd) in q's dtype (float32 or bfloat16);
    pos: (B,) int32, >= 0. hd is 64 or 128 and H / Hkv is 1 to 8. On CUDA
    all four must be contiguous on one card. Returns (B, H, hd) in q's dtype.
    """
    global launches
    _check(q, k, v, pos)
    devices = {q.device, k.device, v.device, pos.device}
    if devices == {torch.device("cpu")}:
        return ref.swa_decode_ref(q, k, v, pos, window=k.shape[1])
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"swa_decode runs on CPU or one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (q, k, v, pos)):
        raise ValueError("swa_decode's kernel needs contiguous q, k, v, pos")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("swa_decode's kernel needs 16-byte aligned q, k, v")
    (b, h, hd), (w, hkv) = q.shape, k.shape[1:3]
    if b > 65535:
        raise ValueError(f"swa_decode's kernel takes at most 65535 rows, "
                         f"got {b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.repro_swa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), b, hkv,
            w, h // hkv, hd, int(q.dtype == torch.bfloat16), out.data_ptr(),
            _build.stream_of(q))
    _build.check(lib, err, "swa_decode kernel launch")
    launches += 1
    return out
