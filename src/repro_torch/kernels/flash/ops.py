"""Wrapper of the causal flash-attention kernels: the plain version
(``ref.py``) for CPU tensors, the CUDA kernels (``flash.cu``) for CUDA
tensors, with no fallback; a ``torch.autograd.Function`` binds the forward
and the backward."""
from __future__ import annotations

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.flash import ref

#: head dims the kernels are built for (granite-moe-1b-a400m and
#: llama3.2-1b: 64; deepseek-moe-16b: 128)
HEAD_DIMS = (64, 128)
#: a forward block takes 128 query rows when the grid still holds this many
#: blocks a SM, else 64
BLOCKS_PER_SM = 2

#: calls that ran the forward and the backward kernels on the card, one
#: each a call (the backward's call launches three kernels: D and a zeroed
#: dQ buffer, the main kernel, dQ's cast); CPU calls do not count
launches_fwd = 0
launches_bwd = 0


def plan(b: int, h: int, s: int, hd: int, sms: int) -> int:
    """The query rows a forward block takes (``flash.cu`` fixes the rest of
    both directions' tiles), from the shapes and the SM count alone: 128
    where B x H x ceil(S / 128) blocks still give ``BLOCKS_PER_SM`` a SM
    (granite's B 32 x 16 heads x 1,024 tokens: 4,096 blocks), else 64, so a
    short prompt fills the card (B 1 x 16 heads x 576 tokens: 144 blocks
    of 64 rows on 132 SMs, not 80 of 128)."""
    if min(b, h, s, sms) < 1:
        raise ValueError(f"flash plan needs b, h, s, sms >= 1, got "
                         f"{b}, {h}, {s}, {sms}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    return 128 if b * h * -(-s // 128) >= BLOCKS_PER_SM * sms else 64


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q (B, S, H, hd) and k, v "
                         f"(B, S, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, s, h, hd), (bk, sk, hkv, hdk) = q.shape, k.shape
    if (bk, sk, hdk) != (b, s, hd) or s < 1:
        raise ValueError(f"flash_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention needs H a multiple of Hkv, got "
                         f"H {h}, Hkv {hkv}")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise ValueError(f"flash_attention takes q, k, v of one float "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def _on_card(*tensors) -> bool:
    """False for CPU tensors; True for bf16 ones, contiguous and 16-byte
    aligned on one card; raises for anything else."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    if tensors[0].dtype != torch.bfloat16:
        raise ValueError(f"flash_attention's kernels take bfloat16, got "
                         f"{tensors[0].dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention's kernels need contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention's kernels need 16-byte aligned "
                         "tensors")
    return True


def _forward(q, k, v):
    """(out, lse) of the forward kernel; see ``ref.flash_forward_ref``."""
    global launches_fwd
    (b, s, h, hd), hkv = q.shape, k.shape[2]
    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rows = plan(b, h, s, hd, sm_count(q.device))
    with torch.cuda.device(q.device):
        err = lib.repro_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  b, s, h, hkv, hd, rows, out.data_ptr(),
                                  lse.data_ptr(), _build.stream_of(q))
    _build.check(lib, err, "flash forward kernel launch")
    launches_fwd += 1
    return out, lse


def _backward(q, k, v, out, lse, d_out):
    """(dq, dk, dv) of the backward kernels; see ``ref.flash_backward_ref``."""
    global launches_bwd
    (b, s, h, hd), hkv = q.shape, k.shape[2]
    lib = _build.load()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    with torch.cuda.device(q.device):
        err = lib.repro_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), b, s, h, hkv, hd,
            delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _build.stream_of(q))
    _build.check(lib, err, "flash backward kernel launch")
    launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward saves only (q, k, v, out, lse) and
    whose backward recomputes P from lse: the kernels on the card, the
    plain version (``ref``) on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v):
        card = _on_card(q, k, v)
        run = _forward if card else ref.flash_forward_ref
        out, lse = run(q, k, v)
        ctx.card = card
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.contiguous()
        if ctx.card:
            return _backward(q, k, v, out, lse, d_out)
        return ref.flash_backward_ref(q, k, v, out, lse, d_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, Hkv, hd) before
    any GQA repeat (query head h reads kv head h // (H / Hkv)); hd 64 or
    128 (outside that set it raises on both devices). Returns (B, S, H, hd)
    in q's dtype, differentiable in q, k and v.

    On CUDA the three must be bf16, contiguous and on one card: the forward
    (its query rows a block from ``plan``) and backward kernels run with no
    host sync; ``launches_fwd`` and ``launches_bwd`` count their calls. CPU
    tensors of any float dtype take the plain version, the same
    algorithm."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v)
