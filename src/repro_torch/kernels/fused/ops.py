"""Wrapper of the fused training-step kernel, port of
``repro.kernels.fused.ops``.

``fused_step`` runs one post-sample step: the plain version
(``ref.fused_step_ref``) for CPU tensors, the CUDA kernel (``fused.cu``)
for CUDA tensors, with no fallback between the two.

``fused_step_parts`` is the step-sized op: it draws the drive
(``uniform((8, side, side))``) and then **one** block of wave draws
(``uniform((wave_cap, 4, side, side))``) from the draw source, runs
``fused_step``, and finishes a cascade that outlives the block with a tail
loop that draws ``uniform((4, side, side))`` per wave (``kernels.cascade.
ops.draw_block`` and ``finish_tail``, which the staged step's cascade stage
runs too). Those are the JAX key chain's positions, so a replay of JAX's
draws feeds both packages the same numbers. Deciding whether a tail is
needed reads the front back once per step, and only when ``max_waves``
exceeds ``wave_cap``.
``make_fused_stage`` adapts the op to the ``afm.Stages.fused`` seam.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import afm as afm_lib
from repro_torch.kernels import _build
from repro_torch.kernels.bmu.ops import PRECISIONS
from repro_torch.kernels.cascade import ops as cascade_ops
from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP, wave_budget
from repro_torch.kernels.fused import ref

#: kernel launches made by ``fused_step`` (CPU calls do not count)
launches = 0


class FusedStep(NamedTuple):
    """One full training step's outputs (flat layout)."""
    w: torch.Tensor       # (N, D) f32
    c: torch.Tensor       # (N,) i32
    gmu: torch.Tensor     # (B,) i32
    q2: torch.Tensor      # (B,) f32
    greedy: torch.Tensor  # (B,) i32 (zeros unless an external search ran)
    size: torch.Tensor    # () i32
    waves: torch.Tensor   # () i32
    recv: torch.Tensor    # (N,) i32 per-unit broadcast receipts


THREADS = 512                 # threads a block, as fused.cu is built
SEARCH_WARPS = 8              # warps of a block that search
SAMPLE_TILE = 16              # samples a warp of the search sums at once
CHUNK = 512                   # features a staged chunk of the search
W_BOX_COLS, W_BOX_ROWS = 8, 256   # a TMA box of the W slice
#: waves of draws a block stages in shared memory at most (a 500-step fit
#: at 30x30x784 averages 5.5 waves a step); later waves read theirs from
#: device memory
MAX_STAGED_WAVES = 8


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def boxes_needed(d: int, ds: int, blocks: int) -> int:
    """Columns of 8-feature TMA boxes the block with the most needs: a box
    starts at a multiple of 4 features (16 bytes), so a slice that starts k
    features past one is read from k features earlier."""
    return max(-(-(f0 % 4 + min(ds, d - f0)) // W_BOX_COLS)
               for f0 in range(0, min(d, blocks * ds), ds))


def shared_bytes(n: int, b: int, d: int, ds: int, staged: int,
                 w_boxes: int) -> int:
    """Shared memory of one block of ``fused.cu`` (its ``layout``): each
    region rounded up to 16 bytes."""
    box_rows = -(-n // W_BOX_ROWS) * W_BOX_ROWS
    regions = [4 * W_BOX_COLS * box_rows * w_boxes,  # the W slice's TMA boxes
               4 * SAMPLE_TILE * max(CHUNK, d),     # search: samples
               4 * ds * n, 4 * ds * n,              # two weight slices
               4 * SEARCH_WARPS * SAMPLE_TILE,      # search: per-warp values
               4 * n, 4 * n, 4 * n, 4 * n, 4 * n,   # c, recv, counts, first,
               2 * 4 * n,                           # fired wave; receipts x2
               8 * n, 4 * n * staged,               # drive and wave draws
               2 * 2 * n, 2 * 2 * n,                # fronts x2, receivers x2
               4 * b, 4 * b * ds,                   # GMUs, samples' slice
               n,                                   # edge masks
               6 * 4, 3 * 8]                        # flags, 3 mbarriers
    return sum(_up16(r) for r in regions)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``fused.cu`` runs an (n units, d features, b samples) step: a
    cooperative grid of ``blocks`` blocks of ``threads`` threads, one an SM.
    Block ``i`` searches the units ``unit_range(i)`` (one split each) and
    then owns the features ``feature_range(i)`` (empty past d), in ``smem``
    bytes of shared memory, with the draws of the first ``staged_waves``
    waves, and ``w_boxes`` columns of TMA boxes for the W slice (0: it comes
    in by 4-byte copies)."""
    n: int
    d: int
    b: int
    blocks: int
    ds: int
    staged_waves: int
    w_boxes: int
    threads: int = THREADS

    @property
    def splits(self) -> int:
        return self.blocks

    @property
    def feature_blocks(self) -> int:
        """Blocks that own at least one feature."""
        return -(-self.d // self.ds)

    @property
    def smem(self) -> int:
        return shared_bytes(self.n, self.b, self.d, self.ds,
                            self.staged_waves, self.w_boxes)

    def unit_range(self, block: int) -> tuple[int, int]:
        """[lo, hi) of the units block ``block`` searches."""
        return (block * self.n // self.blocks,
                (block + 1) * self.n // self.blocks)

    def feature_range(self, block: int) -> tuple[int, int]:
        """[lo, hi) of the features block ``block`` owns."""
        return (min(self.d, block * self.ds),
                min(self.d, (block + 1) * self.ds))

    def c_array(self):
        """The plan as ``repro_fused_plan`` and ``repro_fused_step`` take
        it: int32 blocks, features a block, threads, shared bytes, staged
        waves, samples a search tile, features a search chunk, columns of
        TMA boxes."""
        return (ctypes.c_int32 * 8)(self.blocks, self.ds, self.threads,
                                    self.smem, self.staged_waves,
                                    SAMPLE_TILE, CHUNK, self.w_boxes)


def plan(n: int, d: int, b: int, sms: int, smem_optin: int) -> Plan:
    """The launch plan of the fused kernel on a card with ``sms`` SMs whose
    blocks may opt into ``smem_optin`` bytes of shared memory: one block an
    SM (all co-resident, which the grid barrier needs); ``ceil(d / sms)``
    features a block (6 at D = 784 on an H100: 131 blocks own features, the
    last only searches); room for the W slice to come in by TMA boxes where
    rows are whole 16-byte units (D % 4 == 0) and it fits; as many waves of
    draws staged as fit, up to ``MAX_STAGED_WAVES``. Raises when a block's
    shared memory cannot fit."""
    if n < 1 or d < 1 or b < 1 or sms < 1:
        raise ValueError(f"fused plan needs n, d, b, sms >= 1, got "
                         f"{n}, {d}, {b}, {sms}")
    ds = -(-d // sms)
    need = shared_bytes(n, b, d, ds, 0, 0)
    if need > smem_optin:
        raise ValueError(
            f"fused kernel: N={n}, D={d}, B={b} needs {need} bytes of shared "
            f"memory a block ({ds} features of {n} units on {sms} SMs), more "
            f"than the {smem_optin} this card allows")
    w_boxes = boxes_needed(d, ds, sms) if d % 4 == 0 else 0
    if shared_bytes(n, b, d, ds, 0, w_boxes) > smem_optin:
        w_boxes = 0
    staged = MAX_STAGED_WAVES
    while shared_bytes(n, b, d, ds, staged, w_boxes) > smem_optin:
        staged -= 1
    return Plan(n, d, b, sms, ds, staged, w_boxes)


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, n: int, d: int, b: int) -> Plan:
    """``plan`` for this card, checked by the kernel as built
    (``repro_fused_plan``). Raises when the kernel disagrees or the grid
    cannot be co-resident."""
    props = torch.cuda.get_device_properties(device_index)
    p = plan(n, d, b, props.multi_processor_count,
             props.shared_memory_per_block_optin)
    lib = _build.load()
    out = (ctypes.c_int32 * 3)()
    with torch.cuda.device(device_index):
        err = lib.repro_fused_plan(n, d, b, p.c_array(), out)
    _build.check(lib, err, f"fused kernel plan {p}")
    sms, smem_max, fits = tuple(out)
    if (sms, smem_max) != (props.multi_processor_count,
                           props.shared_memory_per_block_optin):
        raise ValueError(f"fused kernel: the card reports {sms} SMs and "
                         f"{smem_max} shared bytes, torch {props}")
    if p.blocks > fits:
        raise ValueError(
            f"fused kernel: {p.blocks} blocks of {p.smem} shared bytes cannot "
            f"all be resident at once ({fits} fit), which its grid barrier "
            f"needs")
    return p


def fused_step(w, c2, s, l_s: float, l_c: float, drive, bern, gmu=None, *,
               theta: int, budget: int, precision: str = "exact"):
    """One fused post-sample step; see ``ref.fused_step_ref`` for the
    contract. w (N, D) f32, c2 (side, side) int32, s (B, D) f32, drive
    (8, side, side) bool, bern (w_cap, 4, side, side) bool, gmu (B,) int32
    or None (search in the step, on the ``precision`` tier), 0 <= budget <=
    w_cap. All on one device; on CUDA all contiguous. GMUs outside [0, N)
    raise on the CPU; the kernel drops them, as JAX's scatter does.

    Returns ``(w, c2, fired, stats, recv[, gmu, q2])``.
    """
    global launches
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if w.dim() != 2 or s.dim() != 2 or c2.dim() != 2 or bern.dim() != 4:
        raise ValueError(
            f"fused_step needs w (N, D), s (B, D), c2 (side, side) and bern "
            f"(w_cap, 4, side, side), got {tuple(w.shape)}, {tuple(s.shape)},"
            f" {tuple(c2.shape)}, {tuple(bern.shape)}")
    (n, d), b, side, w_cap = w.shape, s.shape[0], c2.shape[0], bern.shape[0]
    if (n != side * side or n < 1 or c2.shape != (side, side)
            or s.shape != (b, d) or b < 1
            or drive.shape != (8, side, side)
            or bern.shape != (w_cap, 4, side, side)
            or (gmu is not None and gmu.shape != (b,))):
        raise ValueError(
            f"fused_step needs w (side², D), c2 (side, side), s (B>=1, D), "
            f"drive (8, side, side), bern (w_cap, 4, side, side), gmu (B,); "
            f"got {tuple(w.shape)}, {tuple(c2.shape)}, {tuple(s.shape)}, "
            f"{tuple(drive.shape)}, {tuple(bern.shape)}, "
            f"{None if gmu is None else tuple(gmu.shape)}")
    if (w.dtype != torch.float32 or s.dtype != torch.float32
            or c2.dtype != torch.int32 or drive.dtype != torch.bool
            or bern.dtype != torch.bool
            or (gmu is not None and gmu.dtype != torch.int32)):
        raise ValueError("fused_step takes float32 w and s, int32 c2 and gmu, "
                         "bool drive and bern")
    if not 0 <= budget <= w_cap:
        raise ValueError(f"budget must lie in [0, {w_cap}], got {budget}")
    tensors = [w, c2, s, drive, bern] + ([] if gmu is None else [gmu])
    devices = {x.device for x in tensors}
    if devices == {torch.device("cpu")}:
        if gmu is not None and not bool(  # lint: sync-ok(CPU tensors only)
                ((gmu >= 0) & (gmu < n)).all()):
            raise ValueError(f"gmu must lie in [0, {n})")
        return ref.fused_step_ref(w, c2, s, l_s, l_c, drive, bern, gmu,
                                  theta=theta, budget=budget,
                                  precision=precision)
    if len(devices) != 1 or w.device.type != "cuda":
        raise ValueError(f"fused_step runs on CPU or one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_step's kernel needs contiguous inputs")
    dev = w.device
    p = _plan(dev.index if dev.index is not None
              else torch.cuda.current_device(), n, d, b)
    lib = _build.load()
    w_out = torch.empty_like(w)
    c_out = torch.empty_like(c2)
    fired = torch.empty((side, side), dtype=torch.bool, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    recv = torch.empty_like(c2)
    searched = gmu is None
    gmu_out = torch.empty(b, dtype=torch.int32, device=dev)
    q2 = torch.empty(b, dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * p.blocks * b if searched else 1,
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.repro_fused_step(
            w.data_ptr(), c2.data_ptr(), s.data_ptr(), drive.data_ptr(),
            bern.data_ptr(), None if searched else gmu.data_ptr(), side, d, b,
            int(theta), int(budget), int(precision == "bf16"), float(l_s),
            float(l_c), w_out.data_ptr(), c_out.data_ptr(), fired.data_ptr(),
            stats.data_ptr(), recv.data_ptr(), gmu_out.data_ptr(),
            q2.data_ptr(), scratch.data_ptr(), p.c_array(),
            _build.stream_of(w))
    _build.check(lib, err, "fused kernel launch")
    launches += 1
    out = (w_out, c_out, fired, stats, recv)
    return (out + (gmu_out, q2)) if searched else out


def fused_step_parts(w, c, samples, draws, cfg, *, l_c: float, p_i: float,
                     search_result=None, precision: str = "exact",
                     wave_cap: int = DEFAULT_WAVE_CAP,
                     recv0=None) -> FusedStep:
    """The step body after sampling (and after the relay race, when one ran).

    Args:
      w / c:         flat (N, D) f32 weights and (N,) int32 counters.
      samples:       (B, D) f32.
      draws:         the draw source; this op takes the drive, one block of
                     ``wave_cap`` waves and, when the cascade outlives it,
                     one draw per tail wave.
      l_c / p_i:     the step's schedule values.
      search_result: a ``SearchResult`` when search ran outside (the relay
                     race); ``None`` searches in the step.
      precision:     'exact' or 'bf16' tier of that search.
      wave_cap:      waves drawn in the block (the kernel's wave budget).
      recv0:         optional (N,) int32 receive counts to add to.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if wave_cap < 1:
        raise ValueError(f"wave_cap must be positive, got {wave_cap}")
    side, theta = cfg.side, cfg.theta
    b = samples.shape[0]
    max_waves = wave_budget(cfg)
    drive, bern = cascade_ops.draw_block(draws, side, p_i, wave_cap)
    budget = min(wave_cap, max_waves)
    gmu = None if search_result is None else \
        search_result.gmu.to(torch.int32).contiguous()
    out = fused_step(w, c.reshape(side, side), samples, cfg.l_s, l_c, drive,
                     bern, gmu, theta=theta, budget=budget,
                     precision=precision)
    if search_result is None:
        wk, ck, fired, stats, recv, gmu, q2 = out
        greedy = torch.zeros(b, dtype=torch.int32, device=samples.device)
    else:
        wk, ck, fired, stats, recv = out
        q2, greedy = search_result.q2, search_result.greedy_steps
    if recv0 is not None:
        recv = recv + recv0.reshape(side, side)
    wk, ck, size, waves, recv = cascade_ops.finish_tail(
        wk, ck, fired, stats, recv, draws, l_c=l_c, p_i=p_i, theta=theta,
        budget=budget, max_waves=max_waves)
    return FusedStep(wk, ck.reshape(-1), gmu, q2, greedy, size, waves,
                     recv.reshape(-1))


def make_fused_stage(*, search: str = "exact", precision: str = "exact",
                     wave_cap: int = DEFAULT_WAVE_CAP):
    """An ``afm.Stages.fused`` callable: one fused training step with the
    schedule evaluation and draw order of ``afm._step``. ``search=
    'heuristic'`` runs the paper's relay race outside the kernel and fuses
    merge, drive and cascade; ``'exact'`` searches in the kernel on the
    ``precision`` tier."""
    if search not in ("heuristic", "exact"):
        raise ValueError(
            f"search must be 'heuristic' or 'exact', got {search!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")

    def fused(state, samples, draws, cfg):
        l_c, p_i = afm_lib.schedule_values(state.i, cfg)
        res = (afm_lib.search_heuristic(state, samples, draws, cfg)
               if search == "heuristic" else None)
        parts = fused_step_parts(state.w, state.c, samples, draws, cfg,
                                 l_c=l_c, p_i=p_i, search_result=res,
                                 precision=precision, wave_cap=wave_cap)
        new_state = afm_lib.AFMState(w=parts.w, c=parts.c, far=state.far,
                                     near=state.near,
                                     i=state.i + samples.shape[0])
        aux = afm_lib.StepAux(parts.gmu, parts.q2, parts.size, parts.waves,
                              parts.greedy)
        return new_state, aux

    return fused
