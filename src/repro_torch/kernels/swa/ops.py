"""Wrapper of the sliding-window decode kernel: the plain version for CPU
tensors, the CUDA kernel (``swa.cu``) for CUDA tensors, with no fallback."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.swa import ref

DTYPES = (torch.float32, torch.bfloat16)
#: head dims the kernel is built for (32: the MoE configs' smoke widths;
#: 256: recurrentgemma-2b's local attention)
HEAD_DIMS = (32, 64, 128, 256)
#: the most query heads a kv head serves (recurrentgemma-2b's MQA: 10)
MAX_REP = 16

#: calls of ``swa_decode`` that ran the kernel on the card, one per call
#: (one CUDA launch: with several splits the last block of each (row, kv
#: head) combines them); CPU calls do not count
launches = 0

#: a split takes at least this many slots (so W = 192 is one split)
MIN_SPLIT_SLOTS = 256
#: splits are added until B x Hkv x splits blocks reach this many a SM
BLOCKS_PER_SM = 2
#: splits the in-kernel combine takes (its shared-memory table)
MAX_SPLITS = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``swa.cu`` cuts the slots of each (batch row, kv head): ``splits``
    blocks of ``slots`` consecutive slots each (the last may hold fewer)."""
    splits: int
    slots: int


def plan(b: int, hkv: int, w: int, sms: int) -> Plan:
    """The split plan of a decode over a W-slot cache, from the shapes and
    the SM count alone (never from ``pos``, which lives on the card):
    enough splits for ``BLOCKS_PER_SM`` blocks a SM, each of at least
    ``MIN_SPLIT_SLOTS`` slots. long_500k (B 1, Hkv 8, W 8192) on 132 SMs:
    32 splits of 256 slots; the serve shape (W 192): one split."""
    if min(b, hkv, w, sms) < 1:
        raise ValueError(f"swa plan needs b, hkv, w, sms >= 1, got "
                         f"{b}, {hkv}, {w}, {sms}")
    want = -(-BLOCKS_PER_SM * sms // (b * hkv))
    splits = max(1, min(want, w // MIN_SPLIT_SLOTS, MAX_SPLITS))
    slots = -(-w // splits)
    return Plan(-(-w // slots), slots)


#: (device, stream) -> int32 tickets of the split combine, zero between
#: calls (the kernel's last block of each (row, kv head) resets its own);
#: one buffer a stream, since calls on one stream never overlap
_tickets: dict = {}


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero tickets for calls on ``stream`` of ``device``."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                          device=device)
    return buf


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
    pos: (B,) int32, >= 0. hd is 32, 64, 128 or 256 and H / Hkv is 1 to 16
    (outside that set it raises on both devices). On CUDA
    all four must be contiguous on one card. Returns (B, H, hd) in q's dtype.

    On the card the slots of each (batch row, kv head) are split across
    blocks as ``plan`` cuts them (bf16 on the tensor cores, f32 on the
    SIMT cores); with more than one split the partial
    (m, l, acc) go to f32 scratch from ``torch.empty`` and the last block
    to finish combines them in a fixed order (an integer ticket a (row, kv
    head) picks it; no float atomics, so two calls are bitwise equal). No
    host sync: ``pos`` is read on the card. ``launches`` counts the call
    once.
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
    rep = h // hkv
    p = plan(b, hkv, w, sm_count(q.device))
    stream = _build.stream_of(q)
    scratch = [None] * 3          # held until the launch is queued
    if p.splits > 1:
        scratch = [
            torch.empty((b, hkv, p.splits, rep, 2), dtype=torch.float32,
                        device=q.device),
            torch.empty((b, hkv, p.splits, rep, hd), dtype=torch.float32,
                        device=q.device),
            tickets(q.device, stream, b * hkv)]
    ml, acc, tk = (None if x is None else x.data_ptr() for x in scratch)
    with torch.cuda.device(q.device):
        err = lib.repro_swa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), b, hkv,
            w, rep, hd, int(q.dtype == torch.bfloat16), p.splits, p.slots,
            ml, acc, tk, out.data_ptr(), stream)
    _build.check(lib, err, "swa_decode kernel launch")
    launches += 1
    return out
