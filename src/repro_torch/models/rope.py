"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, a copy
of ``repro.models.rope``; and, for latent attention's rotated sub-head
(port-only), YaRN's frequencies (arXiv:2309.00071) applied to pairs (2i,
2i + 1) as DeepSeek-V2 rotates them.

M-RoPE (multimodal rotary, arXiv:2409.12191): the head_dim/2 frequency slots
are cut into (temporal, height, width) sections; slot j rotates by
coordinate ``sec_id[j]`` of a 3-D position id. Both halves of a head rotate
by the same angle (JAX's layout, not Hugging Face's rotate-half over a
duplicated table). Text tokens carry equal (t, h, w) coordinates, so M-RoPE
over text is standard RoPE.
"""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); angles: (B, S, hd/2) f32. Rotates the two halves
    of each head in f32 and casts back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """x: (B, S, H, hd); positions3: (3, B, S) integers (t, h, w);
    ``sections`` sum to hd/2."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    # section i's slots take coordinate i (JAX gathers by repeat(arange(3),
    # sections); slices of freqs need no index tensor on the device)
    parts, lo = [], 0
    for axis, n in enumerate(sections):
        parts.append(positions3[axis][..., None].float() * freqs[lo:lo + n])
        lo += n
    return _rotate(x, torch.cat(parts, dim=-1))                  # (B, S, half)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 0.1 mscale ln(factor) + 1, or 1 where the
    context is not stretched (factor <= 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, theta: float,
                    orig: int) -> float:
    """The frequency dim whose wavelength fits ``rotations`` times in
    ``orig`` positions."""
    return dim * math.log(orig / (rotations * 2 * math.pi)) / (
        2 * math.log(theta))


def yarn_freqs(dim: int, theta: float, factor: float, orig: int,
               beta_fast: float, beta_slow: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(dim/2,) YaRN inverse frequencies, f32: below the correction range
    (floor of ``beta_fast``'s dim, ceil of ``beta_slow``'s, clipped to [0,
    dim - 1]) the plain frequencies, above it those divided by ``factor``,
    and a linear ramp between."""
    plain = rope_freqs(dim, theta, device)
    low = max(math.floor(_correction_dim(beta_fast, dim, theta, orig)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, theta, orig)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    return plain / factor * ramp + plain * (1.0 - ramp)


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor,
                     freqs: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, d), positions: (B, S), freqs (d/2,): each pair (2i, 2i
    + 1) rotated by position x freqs[i] and scaled by ``mscale``, in f32,
    returned in the halves layout (evens then odds), as DeepSeek-V2's
    published code permutes a head before its rotation. The layout is
    internal: q and k take the same one, so their products are those of
    the pairs rotated in place."""
    halves = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    angles = positions[..., None].float() * freqs
    if mscale == 1.0:
        return _rotate(halves, angles)
    return (_rotate(halves.float(), angles) * mscale).to(x.dtype)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions: (B, S) -> (3, B, S), equal coordinates
    (a broadcast view)."""
    return positions[None].expand((3,) + tuple(positions.shape))


def grid_positions3(batch: int, seq: int, rows: int, cols: int,
                    device=None) -> torch.Tensor:
    """(3, batch, seq) int32 M-RoPE positions of a prompt that opens with a
    rows x cols grid of patch embeddings, as Qwen2-VL numbers an image at
    the start of a prompt: the patches at t = 0, h = their row, w = their
    column, then the text from the grid's largest coordinate + 1 on, equal
    in all three."""
    n = rows * cols
    if n > seq:
        raise ValueError(f"a {rows}x{cols} grid of patches does not fit a "
                         f"{seq}-token prompt")
    idx = torch.arange(n, dtype=torch.int32, device=device)
    text = (torch.arange(seq - n, dtype=torch.int32, device=device)
            + max(rows, cols))
    grid = torch.stack([torch.zeros_like(idx), idx // cols, idx % cols])
    pos = torch.cat([grid, text[None].expand(3, -1)], dim=1)     # (3, seq)
    return pos[:, None].expand(3, batch, seq).contiguous()
