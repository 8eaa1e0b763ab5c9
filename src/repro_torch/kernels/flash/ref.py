"""Plain PyTorch version of the causal flash-attention kernels
(``flash.cu``): the forward and the backward written out as the kernels'
algorithms, for CPU tensors and for the tests.

q (B, S, H, hd) and k, v (B, S, Hkv, hd), query head h reading kv head
h // (H / Hkv); query row i sees keys j <= i. Every product runs in f32
with TF32 off, and each value is rounded to q's dtype only where the
kernel rounds it (nowhere in f32)."""
from __future__ import annotations

import math

import torch

from repro_torch.device import no_tf32

#: keys a tile of the forward's loop (``flash.cu``'s BC)
KEY_TILE = 64
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
NEG_INF = -1e30


def _expand(x: torch.Tensor, rep: int) -> torch.Tensor:
    """k or v (B, S, Hkv, hd) as f32 (B, S, H, hd), each kv head repeated
    for its rep query heads."""
    return x.float().repeat_interleave(rep, dim=2)


def flash_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_tile: int = KEY_TILE, scale: float | None = None):
    """The forward kernels' online softmax over key tiles of ``key_tile``:
    logits (q . k) log2(e) scale in f32 (``scale`` 1 / sqrt(hd) unless
    given; v may be narrower than q and k, as in latent attention's
    kernel), keys past a row at -inf; per tile m = max(m, tile max), l and
    acc scaled by 2^(m_old - m), p = 2^(logit - m) added to l in f32 and
    rounded to q's dtype for the PV product. Returns (out = acc / max(l,
    1e-30) in q's dtype, (B, S, H, v's hd), lse (B, H, S) f32 = (m + log2
    l) ln 2, the natural log-sum-exp of the scaled logits)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    qf, kf, vf = q.float(), _expand(k, rep), _expand(v, rep)
    scale2 = LOG2E / math.sqrt(hd) if scale is None else LOG2E * scale
    m = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    row = torch.arange(s, device=q.device)[:, None]
    for lo in range(0, s, key_tile):
        hi = min(lo + key_tile, s)
        with no_tf32():
            x = torch.einsum("bqhd,bkhd->bqhk", qf, kf[:, lo:hi]) * scale2
        past = torch.arange(lo, hi, device=q.device)[None, :] > row
        x = torch.where(past[None, :, None, :], -math.inf, x)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        with no_tf32():
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(q.dtype).float(),
                              vf[:, lo:hi])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    lse = ((m + torch.log2(l)) * LN2).permute(0, 2, 1).contiguous()
    return out, lse


def flash_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       d_out: torch.Tensor):
    """The backward kernel's algorithm: P = 2^(logit - lse log2 e) from the
    saved log-sum-exp (0 for a key past its row); D = rowsum(dO o O) in
    f32; dV = P^T dO with P rounded to q's dtype; dP = dO V^T; dS = P (dP -
    D) / sqrt(hd) in f32, which enters dQ = dS K and dK = dS^T Q as a high
    part (dS in q's dtype) and a low part (the rest, in q's dtype); dK and
    dV of a kv head summed over its query heads in f32. Returns (dq, dk,
    dv) in q's, k's and v's dtypes."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), _expand(k, rep), _expand(v, rep)
    dof = d_out.float()
    with no_tf32():
        x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    idx = torch.arange(s, device=q.device)
    past = idx[None, :] > idx[:, None]                     # key past row
    p = torch.where(past, 0.0, torch.exp2(x - (lse * LOG2E)[..., None]))
    delta = (dof * out.float()).sum(dim=-1).permute(0, 2, 1)   # (B, H, S)
    with no_tf32():
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    ds_hi = ds.to(q.dtype)
    ds_lo = (ds - ds_hi.float()).to(q.dtype)
    with no_tf32():
        dq = sum(torch.einsum("bhqk,bkhd->bqhd", part.float(), kf)
                 for part in (ds_hi, ds_lo))
        dk = sum(torch.einsum("bhqk,bqhd->bkhd", part.float(), qf)
                 for part in (ds_hi, ds_lo))

    def per_kv_head(g):
        return g.reshape(b, s, hkv, rep, hd).sum(dim=3)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def err_units(got: torch.Tensor, want: torch.Tensor, slack=0.0) -> float:
    """The largest |got - want| in units of 2^-7 max(|want|, the RMS of
    want's row over the last dim, 2^-8 of want's RMS): at least one bf16
    ulp of the value, for a value near 0 one of its row's typical size,
    and for a row that is rounding noise (dq of query 0, where dS = P (dP -
    D) cancels to 0) one ulp of a value 2^-8 of the tensor's typical size.
    A unit of the row keeps a check as tight on a late causal row (an
    average over thousands of keys, ~0.03 for unit-normal inputs) as on
    row 0 (v[0] itself). ``slack`` (a number or a tensor like ``want``)
    is taken off each |got - want| first: a modelled difference of two
    algorithms."""
    w = want.float()
    d = ((got.float() - w).abs() - slack).clamp(min=0.0)
    sq = w.square()
    floor = 2.0 ** -8 * float(sq.mean()) ** 0.5
    scale = torch.maximum(w.abs(), sq.mean(dim=-1, keepdim=True).sqrt())
    unit = 2.0 ** -7 * scale.clamp(min=floor)
    return float(torch.where(d == 0, 0.0, d / unit).max())
