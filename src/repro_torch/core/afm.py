"""AFM, the asynchronously-trained feature map (paper §2), port of
``repro.core.afm``.

``AFMConfig`` holds the paper's hyper-parameters with the §3 defaults;
``AFMState`` is the trainable state. Two step flavours:

- ``train_step``       faithful per-sample dynamics (B = 1 semantics);
- ``train_step_batch`` B concurrent samples (bulk-asynchronous): B searches
  at once, conflicting GMU updates merge by averaging Eq. (3) applied once
  per sample, and the batch's threshold crossings seed one cascade.

``train`` loops either step over the sample stream. A step is three
injectable stages (``Stages``):

- **search**  (state, samples, draws, cfg) -> SearchResult;
- **adapt**   (state, samples, gmu, cfg) -> (w, counts), the Eq. (3) merge;
- **cascade** (w, c, counts, l_c, p, draws, cfg) -> CascadeResult;

or one optional **fused** stage (state, samples, draws, cfg) -> (state,
aux) that takes the whole step, as the fused CUDA kernel does
(``repro_torch.kernels.fused``).

Randomness comes from a draw source (``repro_torch.draws``) in place of the
JAX key chain, consumed in the key chain's order: search draws, then the
drive, then one draw per wave.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import cascade as cascade_lib
from repro_torch.core import links, schedules
from repro_torch.core import search as search_lib


@dataclasses.dataclass(frozen=True)
class AFMConfig:
    """Paper §3 'Default configuration' unless overridden.

    ``batch`` and ``max_waves`` interact: one step seeds **one** cascade from
    all B threshold crossings of the batch, and ``max_waves`` caps its wave
    count (``None`` -> 8·side², in effect quiescence). Units cut off by the
    cap fire at the start of the next step's cascade.
    """
    side: int = 30                 # map is side x side units (N = side^2)
    dim: int = 784                 # sample-space dimensionality
    phi: int = 20                  # far links per unit
    theta: int = 4                 # cascading threshold (= |N_j|, BTW mapping)
    l_s: float = 0.05              # sample learning rate (Eq. 3)
    c_o: float = 0.5               # l_c offset (Eq. 5)
    c_s: float = 0.5               # l_c slope (Eq. 5)
    c_m: float = 0.1               # early characteristic cascade size (Eq. 6)
    c_d: float = 100.0             # cascade decay rate (Eq. 6)
    e_factor: float = 3.0          # exploration iterations e = e_factor * N
    i_max: int = 0                 # total training samples; 0 -> 600 * N
    greedy_use_far: bool = True    # §2.1 step 3: compare near AND far neighbours
    batch: int = 1                 # samples in flight per step
    max_waves: int | None = None   # cascade safety bound

    @property
    def n_units(self) -> int:
        return self.side * self.side

    @property
    def e(self) -> int:
        return max(1, int(self.e_factor * self.n_units))

    @property
    def total_samples(self) -> int:
        return self.i_max if self.i_max > 0 else 600 * self.n_units

    @property
    def num_steps(self) -> int:
        return self.total_samples // self.batch


class AFMState(NamedTuple):
    w: torch.Tensor     # (N, D) float32 unit weights
    c: torch.Tensor     # (N,) int32 cascading counters
    far: torch.Tensor   # (N, phi) int32 far-link table
    near: torch.Tensor  # (N, 4) int32 near-link table (-1 padded)
    i: int              # samples consumed so far; a host int, since the
                        # host loop that counts steps also reads the schedules


class StepAux(NamedTuple):
    gmu: torch.Tensor           # (B,) int32
    q2: torch.Tensor            # (B,) float32
    cascade_size: torch.Tensor  # () int32, a_i for the step (the plain
                                # staged cascade: a CPU tensor of its host
                                # count; the kernel stages: on device)
    waves: torch.Tensor         # () int32 (as cascade_size)
    greedy_steps: torch.Tensor  # (B,) int32


def init(draws, cfg: AFMConfig,
         samples: torch.Tensor | None = None) -> AFMState:
    """Initialise weights (uniform in the sample bounding box, or N(0, 0.1))
    and the link tables, on the draw source's device."""
    n = cfg.n_units
    device = draws.device
    if samples is not None:
        samples = samples.to(device=device, dtype=torch.float32)
        lo = samples.min(dim=0).values
        hi = samples.max(dim=0).values
        u = draws.uniform((n, cfg.dim))
        w = torch.maximum(lo, u * (hi - lo) + lo)
    else:
        w = 0.1 * draws.normal((n, cfg.dim))
    return AFMState(
        w=w.to(torch.float32).contiguous(),
        c=torch.zeros(n, dtype=torch.int32, device=device),
        far=links.far_links(draws, cfg.side, cfg.phi),
        near=links.near_neighbor_table(cfg.side, device=device),
        i=0,
    )


class Stages(NamedTuple):
    """The three injectable phases of one AFM step, plus an optional
    whole-step seam: when ``fused`` is set, ``_step`` hands it the entire
    step and bypasses the other three. A fused stage evaluates the
    schedules (``schedule_values``) and takes its draws in the staged
    step's order: search, drive, waves."""
    search: Callable    # (state, samples, draws, cfg) -> SearchResult
    adapt: Callable     # (state, samples, gmu, cfg) -> (w (N,D), counts (N,))
    cascade: Callable   # (w, c, counts, l_c, p, draws, cfg) -> CascadeResult
    fused: Callable | None = None  # (state, samples, draws, cfg) -> (state, aux)


def search_heuristic(state: AFMState, samples: torch.Tensor, draws,
                     cfg: AFMConfig) -> search_lib.SearchResult:
    """Paper §2.1: far-link relay-race exploration + greedy exploitation."""
    return search_lib.heuristic_search(
        state.w, state.near, state.far, samples, draws, cfg.e,
        greedy_use_far=cfg.greedy_use_far,
    )


def search_exact(state: AFMState, samples: torch.Tensor, draws,
                 cfg: AFMConfig) -> search_lib.SearchResult:
    """Exact BMU via a full distance pass (draws unused: deterministic)."""
    del draws, cfg
    gmu, q2 = search_lib.exact_bmu(state.w, samples)
    zeros = torch.zeros(samples.shape[:1], dtype=torch.int32,
                        device=samples.device)
    return search_lib.SearchResult(gmu, q2, zeros, zeros)


def adapt_merge(w: torch.Tensor, samples: torch.Tensor, gmu: torch.Tensor,
                cfg: AFMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (3) on a flat (N, D) weight matrix: each hit unit moves by l_s
    towards the mean of the samples that chose it.

    The mean is formed per sample over the (B, B) "same GMU" mask, not with
    ``index_add_``: on CUDA that sums duplicate GMUs with atomics in no
    fixed order, and this form is deterministic on every device. Samples
    that share a GMU get bitwise-equal new rows, so the duplicate writes of
    ``index_copy`` agree. Counts are whole numbers, exact in any order.
    """
    gmu = gmu.long()
    counts = torch.zeros(cfg.n_units, dtype=torch.float32, device=w.device)
    counts.index_add_(0, gmu, torch.ones_like(gmu, dtype=torch.float32))
    same = (gmu[:, None] == gmu[None, :]).to(samples.dtype)       # (B, B)
    mean = (same[:, :, None] * samples[None]).sum(dim=1) / same.sum(
        dim=1, keepdim=True)
    rows = w[gmu]
    return w.index_copy(0, gmu, rows + cfg.l_s * (mean - rows)), counts


def adapt_gmu(state: AFMState, samples: torch.Tensor, gmu: torch.Tensor,
              cfg: AFMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (3): GMU adaptation; conflicting GMUs merge by averaging the
    per-sample targets (B = 1: exactly Eq. 3). Returns (w, per-unit counts)."""
    return adapt_merge(state.w, samples, gmu, cfg)


def cascade_default(w: torch.Tensor, c: torch.Tensor, counts: torch.Tensor,
                    l_c: float, p_i: float, draws, cfg: AFMConfig,
                    wave_fn=None) -> cascade_lib.CascadeResult:
    """Drive + cascade on the lattice view. ``wave_fn`` lets the CUDA cascade
    kernel replace the counter-wave stencil (the same integers)."""
    side = cfg.side
    return cascade_lib.drive_and_cascade(
        w.reshape(side, side, cfg.dim), c.reshape(side, side),
        counts.to(torch.int32).reshape(side, side),
        l_c=l_c, p=p_i, theta=cfg.theta, draws=draws,
        max_waves=cfg.max_waves, wave_fn=wave_fn,
    )


DEFAULT_STAGES = Stages(search_heuristic, adapt_gmu, cascade_default)
EXACT_STAGES = Stages(search_exact, adapt_gmu, cascade_default)


def schedule_values(i: int, cfg: AFMConfig) -> tuple[float, float]:
    """The step's cascade learning rate l_c(i) (Eq. 5) and probability p_i
    (Eq. 6), as float32 values in host floats."""
    l_c = float(schedules.cascade_learning_rate(i, cfg.total_samples,
                                                cfg.c_o, cfg.c_s))
    p_i = float(schedules.cascade_probability(i, cfg.total_samples,
                                              cfg.n_units, cfg.c_m, cfg.c_d))
    return l_c, p_i


def _step(state: AFMState, samples: torch.Tensor, draws, cfg: AFMConfig,
          stages: Stages = DEFAULT_STAGES) -> tuple[AFMState, StepAux]:
    """Shared body for faithful (B=1) and batched (B>1) steps."""
    if stages.fused is not None:
        return stages.fused(state, samples, draws, cfg)
    n = cfg.n_units
    b = samples.shape[0]
    i = state.i
    l_c, p_i = schedule_values(i, cfg)

    res = stages.search(state, samples, draws, cfg)
    w, counts = stages.adapt(state, samples, res.gmu, cfg)
    out = stages.cascade(w, state.c, counts, l_c, p_i, draws, cfg)

    new_state = AFMState(
        w=out.w.reshape(n, cfg.dim),
        c=out.c.reshape(n),
        far=state.far,
        near=state.near,
        i=i + b,
    )
    # a host count becomes a CPU tensor; a device count stays where it is
    # (no sync)
    aux = StepAux(res.gmu, res.q2,
                  torch.as_tensor(out.size, dtype=torch.int32),
                  torch.as_tensor(out.waves, dtype=torch.int32),
                  res.greedy_steps)
    return new_state, aux


def train_step(state: AFMState, sample: torch.Tensor, draws, cfg: AFMConfig,
               stages: Stages = DEFAULT_STAGES) -> tuple[AFMState, StepAux]:
    """Faithful per-sample step. sample: (D,)."""
    return _step(state, sample[None, :], draws, cfg, stages)


def train_step_batch(state: AFMState, samples: torch.Tensor, draws,
                     cfg: AFMConfig, stages: Stages = DEFAULT_STAGES
                     ) -> tuple[AFMState, StepAux]:
    """Bulk-asynchronous step over (B, D) samples."""
    return _step(state, samples, draws, cfg, stages)


def stack_aux(auxes: list[StepAux]) -> StepAux:
    """Per-step aux stacked along a leading step axis."""
    return StepAux(*(torch.stack(field) for field in zip(*auxes)))


def _empty_aux(cfg: AFMConfig, device) -> StepAux:
    """The stacked aux of zero steps: each field with a zero-length step
    axis and the dtype and trailing shape of a step's."""
    b = cfg.batch
    return StepAux(
        gmu=torch.zeros((0, b), dtype=torch.int32, device=device),
        q2=torch.zeros((0, b), dtype=torch.float32, device=device),
        cascade_size=torch.zeros((0,), dtype=torch.int32, device=device),
        waves=torch.zeros((0,), dtype=torch.int32, device=device),
        greedy_steps=torch.zeros((0, b), dtype=torch.int32, device=device))


def train(state: AFMState, data: torch.Tensor, draws, cfg: AFMConfig,
          num_steps: int | None = None, stages: Stages = DEFAULT_STAGES
          ) -> tuple[AFMState, StepAux]:
    """Loop the batched step over a sample stream.

    data: (num_samples, D), sampled with replacement: each step draws
    ``randint(0, num_samples, (B,))`` indices before its own draws.
    Returns the final state and the per-step aux stacked. Zero steps return
    the state as it is and an aux with a zero-length step axis, as JAX's
    ``lax.scan`` does.
    """
    num_steps = cfg.num_steps if num_steps is None else num_steps
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if num_steps == 0:
        return state, _empty_aux(cfg, state.w.device)
    auxes = []
    for _ in range(num_steps):
        idx = draws.randint(0, data.shape[0], (cfg.batch,))
        state, aux = _step(state, data[idx], draws, cfg, stages)
        auxes.append(aux)
    return state, stack_aux(auxes)
