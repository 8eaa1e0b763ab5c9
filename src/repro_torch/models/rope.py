"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, a copy
of ``repro.models.rope``.

M-RoPE (multimodal rotary, arXiv:2409.12191): the head_dim/2 frequency slots
are cut into (temporal, height, width) sections; slot j rotates by
coordinate ``sec_id[j]`` of a 3-D position id. Both halves of a head rotate
by the same angle (JAX's layout, not Hugging Face's rotate-half over a
duplicated table). Text tokens carry equal (t, h, w) coordinates, so M-RoPE
over text is standard RoPE.
"""
from __future__ import annotations

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
