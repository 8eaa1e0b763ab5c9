"""Wrapper of the BMU kernel: the plain version for CPU tensors, the CUDA
kernel (``bmu.cu``) for CUDA tensors, with no fallback between the two."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.bmu import ref

PRECISIONS = ("exact", "bf16")

#: calls of ``bmu`` that ran the kernel on the card (one per call, which
#: makes two CUDA launches: the split search and the merge; CPU calls do
#: not count)
launches = 0

ROWS_SAMPLES = 16            # samples a block of rows_kernel
TILE_SAMPLES = 128           # samples a block of tile_kernel
TILE_UNITS = 128             # units a tile of tile_kernel
#: tile_kernel only where its blocks reach 1 / TILE_MIN_FILL of the SMs: it
#: runs near the f32 rate, rows_kernel (16 shared-memory float4 reads a 64
#: FMAs) near a quarter of it
TILE_MIN_FILL = 3
#: tile_kernel gives a split several unit tiles only past this many blocks
#: a card's SM
TILE_BLOCKS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``bmu.cu`` cuts an (n units, b samples) search across blocks.

    ``kernel`` is ``"rows"`` (a warp a unit, ``sample_tile`` = 16 samples a
    block) or ``"tiles"`` (128 x 128 register-blocked tiles). The grid is
    (``splits``, sample tiles); split ``i`` owns the units
    ``unit_range(i)``, which may be empty."""
    kernel: str
    n: int
    b: int
    sample_tile: int
    splits: int

    @property
    def unit_step(self) -> int:
        """Split edges fall on multiples of this many units."""
        return 1 if self.kernel == "rows" else TILE_UNITS

    @property
    def grid(self) -> tuple[int, int]:
        return self.splits, -(-self.b // self.sample_tile)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def unit_range(self, split: int) -> tuple[int, int]:
        """[lo, hi) of the units of one split, as the kernel computes it."""
        steps = -(-self.n // self.unit_step)
        lo = split * steps // self.splits * self.unit_step
        hi = (split + 1) * steps // self.splits * self.unit_step
        return min(lo, self.n), min(hi, self.n)


def plan(n: int, b: int, d: int, sms: int) -> Plan:
    """The split and tile plan of an (n, d) x (b, d) search on a card with
    ``sms`` SMs: at least one block a SM wherever the units allow it.

    ``tile_kernel`` where its 128 x 128 tiles alone give a third of the SMs
    a block: each split one 128-unit tile (8 at N = 900: 632 blocks at
    B = 10000), or several once the blocks would pass
    ``TILE_BLOCKS_PER_SM`` a SM. Otherwise (B = 16, and any B up to 32 at
    N = 900) ``rows_kernel``: 16 samples a block and the units cut into
    ``ceil(sms / sample tiles)`` splits (132 splits of 6-7 units at B = 16
    on an H100), at most one split a unit. ``d`` does not change the plan.
    """
    if n < 1 or b < 1 or d < 1 or sms < 1:
        raise ValueError(f"bmu plan needs n, b, d, sms >= 1, got "
                         f"{n}, {b}, {d}, {sms}")
    tiles = -(-b // TILE_SAMPLES)
    unit_tiles = -(-n // TILE_UNITS)
    if TILE_MIN_FILL * tiles * unit_tiles >= sms:
        per = max(1, tiles * unit_tiles // (TILE_BLOCKS_PER_SM * sms))
        return Plan("tiles", n, b, TILE_SAMPLES, math.ceil(unit_tiles / per))
    tiles = -(-b // ROWS_SAMPLES)
    return Plan("rows", n, b, ROWS_SAMPLES, min(n, -(-sms // tiles)))


def bmu(w: torch.Tensor, s: torch.Tensor, *, precision: str = "exact"):
    """argmin_j |w_j - s_i|^2 over units. Returns (idx (B,) int32, q2 (B,) f32).

    ``precision`` picks the distance tier: ``'exact'`` (f32) or ``'bf16'``
    (bf16 cross term, f32 accumulate, exact-f32 polish of the winner's q2).
    w: (N, D) and s: (B, D), float32, on one device; on CUDA both must be
    contiguous. On the card the search runs as ``plan`` cuts it: the units
    split across blocks, per-split (min, argmin) partials in scratch from
    ``torch.empty``, and a merge in a second launch that is deterministic
    (the lowest index wins a tie, also across splits). ``launches`` counts
    the call once.
    """
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
    return run_plan(w, s, precision=precision)


def run_plan(w: torch.Tensor, s: torch.Tensor, p: Plan | None = None, *,
             precision: str = "exact"):
    """``bmu`` on the card as plan ``p`` cuts it (``plan``'s by default;
    any plan of these n and b, also one with empty splits). w and s as
    ``bmu`` checks them."""
    global launches
    lib = _build.load()
    (n, d), b = w.shape, s.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=w.device)
    q2 = torch.empty(b, dtype=torch.float32, device=w.device)
    if b and d:
        p = plan(n, b, d, sm_count(w.device)) if p is None else p
        if (p.n, p.b) != (n, b):
            raise ValueError(f"a plan of n={p.n}, b={p.b} for n={n}, b={b}")
        part_v = torch.empty((p.splits, b), dtype=torch.float32,
                             device=w.device)
        part_i = torch.empty((p.splits, b), dtype=torch.int32,
                             device=w.device)
        with torch.cuda.device(w.device):
            err = lib.repro_bmu(w.data_ptr(), s.data_ptr(), n, b, d,
                                int(precision == "bf16"), p.sample_tile,
                                p.splits, part_v.data_ptr(),
                                part_i.data_ptr(), idx.data_ptr(),
                                q2.data_ptr(), _build.stream_of(w))
        _build.check(lib, err, "bmu kernel launch")
        launches += 1
    elif b:                 # D = 0: every distance is 0, unit 0 wins
        idx.zero_()
        q2.zero_()
    if precision == "bf16":
        q2 = ref.polish(w, s, idx)
    return idx, q2
