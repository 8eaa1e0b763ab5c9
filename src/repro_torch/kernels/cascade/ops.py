"""Wrappers of the cascade kernels (``cascade.cu``): the plain versions
(``ref.py``) for CPU tensors, the CUDA kernels for CUDA tensors, with no
fallback between the two.

- ``cascade_wave``: one counter wave, the ``wave_fn`` seam of
  ``core.cascade`` and the kernel of the tail loop.
- ``drive_cascade``: a staged step's whole drive and cascade, up to a wave
  budget, in one launch (``plan_cascade`` cuts it over the card's SMs).

``drive_cascade_stage`` is the staged step's cascade stage
(``afm.Stages.cascade``) on that op. It takes its draws as the fused step
does: the drive (``uniform((8, side, side))``), then **one** block of wave
draws (``uniform((wave_cap, 4, side, side))``), then one
``uniform((4, side, side))`` per wave of a cascade that outlives the block,
which ``finish_tail`` runs on ``cascade_wave``. Deciding whether a tail is
needed reads the front back once a step, and only when ``max_waves``
exceeds ``wave_cap``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import cascade as cascade_lib
from repro_torch.kernels import _build
from repro_torch.kernels.cascade import ref

#: Default wave budget of one launch (``drive_cascade`` and the fused
#: step); deeper cascades continue in the tail loop on the same draws, so
#: this is a speed knob, not a semantic one.
DEFAULT_WAVE_CAP = 16

#: kernel launches made by ``cascade_wave`` (CPU calls do not count)
launches = 0
#: kernel launches made by ``drive_cascade`` (CPU calls do not count)
drive_launches = 0


def wave_budget(cfg) -> int:
    """The step's wave bound (``None`` -> 8·side²), as ``core.cascade``."""
    return (8 * cfg.side * cfg.side if cfg.max_waves is None
            else cfg.max_waves)


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


THREADS = 512                 # threads a block, as cascade.cu is built
#: waves of draws a block stages in shared memory at most (a 500-step fit
#: at 30x30x784 averages ~5.5 waves a step); later waves read theirs from
#: device memory
MAX_STAGED_WAVES = 8


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def cascade_shared_bytes(n: int, ds: int, staged: int) -> int:
    """Shared memory of one block of ``drive_cascade_kernel`` (its
    ``layout``): each region rounded up to 16 bytes."""
    regions = [4 * ds * n, 4 * ds * n,              # two weight slices
               4 * n, 4 * n, 4 * n, 4 * n,          # c, recv, counts, fired
               2 * 4 * n,                           # wave; receipts x2
               8 * n, 4 * n * staged,               # drive and wave draws
               2 * 2 * n, 2 * 2 * n,                # fronts x2, receivers x2
               n,                                   # edge masks
               6 * 4]                               # flags
    return sum(_up16(r) for r in regions)


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """How ``drive_cascade_kernel`` runs an (n units, d features) step: an
    ordinary grid of ``blocks`` blocks of ``threads`` threads, block ``i``
    owning the features ``feature_range(i)`` of every unit in ``smem``
    bytes of shared memory, with the draws of the first ``staged_waves``
    waves."""
    n: int
    d: int
    blocks: int
    ds: int
    staged_waves: int
    threads: int = THREADS

    @property
    def smem(self) -> int:
        return cascade_shared_bytes(self.n, self.ds, self.staged_waves)

    def feature_range(self, block: int) -> tuple[int, int]:
        """[lo, hi) of the features block ``block`` owns."""
        return (min(self.d, block * self.ds),
                min(self.d, (block + 1) * self.ds))

    def c_array(self):
        """The plan as ``repro_cascade_plan`` and ``repro_drive_cascade``
        take it: int32 blocks, features a block, threads, shared bytes,
        staged waves."""
        return (ctypes.c_int32 * 5)(self.blocks, self.ds, self.threads,
                                    self.smem, self.staged_waves)


def plan_cascade(n: int, d: int, sms: int, smem_optin: int) -> CascadePlan:
    """The launch plan of ``drive_cascade`` on a card with ``sms`` SMs whose
    blocks may opt into ``smem_optin`` bytes of shared memory:
    ``ceil(d / sms)`` features a block and as many blocks as that takes to
    cover d (6 features and 131 blocks at D = 784 on an H100), as many waves
    of draws staged as fit, up to ``MAX_STAGED_WAVES``. Raises when a
    block's shared memory cannot fit, or the sites do not fit the kernel's
    16-bit lists."""
    if n < 1 or d < 1 or sms < 1:
        raise ValueError(f"cascade plan needs n, d, sms >= 1, got "
                         f"{n}, {d}, {sms}")
    if n > 65535:
        raise ValueError(f"cascade plan: {n} units are more than the "
                         f"kernel's 16-bit site lists hold (65,535)")
    ds = -(-d // sms)
    need = cascade_shared_bytes(n, ds, 0)
    if need > smem_optin:
        raise ValueError(
            f"drive_cascade kernel: N={n}, D={d} needs {need} bytes of shared"
            f" memory a block ({ds} features of {n} units on {sms} SMs), more "
            f"than the {smem_optin} this card allows")
    staged = MAX_STAGED_WAVES
    while cascade_shared_bytes(n, ds, staged) > smem_optin:
        staged -= 1
    return CascadePlan(n, d, -(-d // ds), ds, staged)


@functools.lru_cache(maxsize=None)
def _cascade_plan(device_index: int, n: int, d: int) -> CascadePlan:
    """``plan_cascade`` for this card, checked by the kernel as built
    (``repro_cascade_plan``). Raises when the kernel disagrees."""
    props = torch.cuda.get_device_properties(device_index)
    p = plan_cascade(n, d, props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    lib = _build.load()
    out = (ctypes.c_int32 * 2)()
    with torch.cuda.device(device_index):
        err = lib.repro_cascade_plan(n, d, p.c_array(), out)
    _build.check(lib, err, f"drive_cascade kernel plan {p}")
    if tuple(out) != (props.multi_processor_count,
                      props.shared_memory_per_block_optin):
        raise ValueError(f"drive_cascade kernel: the card reports "
                         f"{tuple(out)} SMs and shared bytes, torch {props}")
    return p


def drive_cascade(w, c2, counts, drive, bern, *, l_c: float, theta: int,
                  budget: int):
    """A staged step's drive and cascade, up to ``budget`` waves; see
    ``ref.drive_cascade_ref`` for the contract. w (N, D) f32, the merge's
    output; c2 and counts (side, side) int32; drive (8, side, side) bool;
    bern (w_cap, 4, side, side) bool; 0 <= budget <= w_cap. All on one
    device; on CUDA all contiguous. The kernel writes a new weight tensor
    (out of place), as the plain version returns one.

    Returns ``(w, c2, fired, stats, recv)``: stats (2,) int32 is [size,
    waves], on the inputs' device.
    """
    global drive_launches
    if w.dim() != 2 or c2.dim() != 2 or bern.dim() != 4:
        raise ValueError(
            f"drive_cascade needs w (N, D), c2 (side, side) and bern "
            f"(w_cap, 4, side, side), got {tuple(w.shape)}, "
            f"{tuple(c2.shape)}, {tuple(bern.shape)}")
    (n, d), side, w_cap = w.shape, c2.shape[0], bern.shape[0]
    if (n != side * side or n < 1 or d < 1 or c2.shape != (side, side)
            or counts.shape != (side, side)
            or drive.shape != (8, side, side)
            or bern.shape != (w_cap, 4, side, side)):
        raise ValueError(
            f"drive_cascade needs w (side², D), c2 and counts (side, side), "
            f"drive (8, side, side), bern (w_cap, 4, side, side); got "
            f"{tuple(w.shape)}, {tuple(c2.shape)}, {tuple(counts.shape)}, "
            f"{tuple(drive.shape)}, {tuple(bern.shape)}")
    if (w.dtype != torch.float32 or c2.dtype != torch.int32
            or counts.dtype != torch.int32 or drive.dtype != torch.bool
            or bern.dtype != torch.bool):
        raise ValueError("drive_cascade takes float32 w, int32 c2 and "
                         "counts, bool drive and bern")
    if not 0 <= budget <= w_cap:
        raise ValueError(f"budget must lie in [0, {w_cap}], got {budget}")
    tensors = (w, c2, counts, drive, bern)
    devices = {x.device for x in tensors}
    if devices == {torch.device("cpu")}:
        return ref.drive_cascade_ref(w, c2, counts, drive, bern, l_c=l_c,
                                     theta=theta, budget=budget)
    if len(devices) != 1 or w.device.type != "cuda":
        raise ValueError(f"drive_cascade runs on CPU or one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("drive_cascade's kernel needs contiguous inputs")
    dev = w.device
    p = _cascade_plan(dev.index if dev.index is not None
                      else torch.cuda.current_device(), n, d)
    lib = _build.load()
    w_out = torch.empty_like(w)
    c_out = torch.empty_like(c2)
    fired = torch.empty((side, side), dtype=torch.bool, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    recv = torch.empty_like(c2)
    with torch.cuda.device(dev):
        err = lib.repro_drive_cascade(
            w.data_ptr(), c2.data_ptr(), counts.data_ptr(), drive.data_ptr(),
            bern.data_ptr(), side, d, int(theta), int(budget), float(l_c),
            w_out.data_ptr(), c_out.data_ptr(), fired.data_ptr(),
            stats.data_ptr(), recv.data_ptr(), p.c_array(),
            _build.stream_of(w))
    _build.check(lib, err, "drive_cascade kernel launch")
    drive_launches += 1
    return w_out, c_out, fired, stats, recv


def draw_block(draws, side: int, p_i: float, wave_cap: int):
    """A step's cascade draws before any tail: the drive, then one block of
    ``wave_cap`` waves (``bern[k]`` is wave k's)."""
    drive = draws.uniform((8, side, side)) < p_i
    bern = draws.uniform((wave_cap, 4, side, side)) < p_i
    return drive, bern


def finish_tail(w, c2, fired, stats, recv, draws, *, l_c: float, p_i: float,
                theta: int, budget: int, max_waves: int):
    """The end of a cascade after a kernel ran its first ``budget`` waves:
    when the front is still alive and ``max_waves`` allows more, the tail
    loop runs the rest on ``cascade_wave``, one draw a wave. w (N, D);
    c2, fired and recv (side, side). Returns (w, c2, size, waves, recv),
    size and waves 0-d int32 tensors on the lattice's device."""
    size, waves = stats[0], stats[1]
    # a non-empty front after the kernel means it ran all ``budget`` waves
    if budget < max_waves and bool(fired.any()):     # the step's host sync
        side, d = c2.shape[0], w.shape[1]
        w3, c2, size, waves, recv = ref.wave_loop(
            w.reshape(side, side, d), c2, fired, draws, l_c=l_c, p_i=p_i,
            theta=theta, max_waves=max_waves, size0=size, waves0=budget,
            recv0=recv, wave_fn=cascade_wave)
        w = w3.reshape(-1, d)
    return w, c2, size, waves, recv


def drive_cascade_stage(w, c, counts, l_c: float, p_i: float, draws, cfg, *,
                        wave_cap: int = DEFAULT_WAVE_CAP
                        ) -> cascade_lib.CascadeResult:
    """An ``afm.Stages.cascade`` callable: the drive and up to ``wave_cap``
    waves in one ``drive_cascade`` call, the rest (if any) in the tail loop.
    w (N, D) merged weights, c (N,) int32 counters, counts (N,) the
    adaptations of each unit (any dtype). size and waves come back as 0-d
    tensors on the weights' device: nothing here syncs but the tail
    decision."""
    side = cfg.side
    max_waves = wave_budget(cfg)
    budget = min(wave_cap, max_waves)
    drive, bern = draw_block(draws, side, p_i, wave_cap)
    out = drive_cascade(w, c.reshape(side, side),
                        counts.to(torch.int32).reshape(side, side), drive,
                        bern, l_c=l_c, theta=cfg.theta, budget=budget)
    w, c2, size, waves, _ = finish_tail(*out, draws, l_c=l_c, p_i=p_i,
                                        theta=cfg.theta, budget=budget,
                                        max_waves=max_waves)
    return cascade_lib.CascadeResult(w.reshape(side, side, cfg.dim), c2,
                                     size, waves)
