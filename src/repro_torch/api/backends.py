"""Execution backends for the port's ``TopoMap``, port of
``repro.api.backends``.

A backend owns *how* the AFM step runs, while the dynamics stay the shared
injectable stages of ``repro_torch.core.afm``. Backends register under a
string key:

=============  ==============================================================
``reference``  Faithful per-sample dynamics (B = 1), plain PyTorch.
``batched``    Bulk-asynchronous: B relay-race searches per step.
``kernel``     The counterpart of the JAX ``pallas`` backend: exact search
               through the CUDA BMU kernel and each step's drive and cascade
               through one launch of the CUDA drive-cascade kernel
               (``kernel="staged"``), or the whole step as one CUDA kernel
               (``kernel="fused"``); on CPU tensors the wrappers run their
               plain versions.
``sharded``    Mesh training over ``torch.distributed`` ranks
               (``core.distributed``): lattice rows over the ``model`` axis,
               samples over ``data``, one process a rank.
``async``      Event-driven: per-sample dynamics under a message-latency
               model (``repro_torch.training.async_trainer`` over
               ``core.events``), its zero-latency fast path on the
               ``drive_cascade`` or fused kernel; ``placement='mesh'``
               partitions it over ranks (``core.placement.mesh``).
=============  ==============================================================

Every backend implements the ``Backend`` protocol:

- ``init(draws, samples)``            -> backend-native state
- ``step(state, samples, draws)``     -> one training step (``partial_fit``)
- ``run(state, data, draws, steps)``  -> training loop (``fit``)
- ``to_dense(state)`` / ``from_dense(state)`` -> the dense ``AFMState``
- ``bmu(w, samples)``                 -> the backend's exact-BMU path
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import afm, distributed
from repro_torch.core import search as search_lib
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.device import resolve_device
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.cascade import ops as cascade_ops
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.sharding import compat

BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("batched")``."""
    def deco(cls):
        cls.name = name
        BACKENDS[name] = cls
        return cls
    return deco


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(BACKENDS))


def add_backend_argument(parser, *, default: str = "batched",
                         flag: str = "--backend"):
    """Add a ``--backend`` CLI argument whose choices and help text come
    from the live registry, so launchers can never drift from the set of
    registered backends."""
    choices = sorted(available_backends())
    return parser.add_argument(
        flag, default=default, choices=choices,
        help=f"execution backend ({', '.join(choices)}; "
             f"default: {default})")


def get_backend(name: str, cfg: AFMConfig, **options):
    """Instantiate a registered backend for ``cfg``."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    return cls(cfg, **options)


@runtime_checkable
class Backend(Protocol):
    name: str
    cfg: AFMConfig
    device: torch.device

    def init(self, draws, samples: torch.Tensor | None = None) -> Any: ...
    def step(self, state: Any, samples: torch.Tensor, draws): ...
    def run(self, state: Any, data: torch.Tensor, draws,
            num_steps: int | None = None): ...
    def to_dense(self, state: Any) -> AFMState: ...
    def from_dense(self, state: AFMState) -> Any: ...
    def bmu(self, w: torch.Tensor, samples: torch.Tensor): ...


def _stages_for(search: str) -> afm.Stages:
    if search == "heuristic":
        return afm.DEFAULT_STAGES
    if search == "exact":
        return afm.EXACT_STAGES
    raise ValueError(f"search must be 'heuristic' or 'exact', got {search!r}")


class _DenseBackend:
    """Shared dense-state machinery: init / step loop / conversions."""

    def __init__(self, cfg: AFMConfig, *, search: str = "heuristic",
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stages = _stages_for(search)

    def init(self, draws, samples=None) -> AFMState:
        return afm.init(draws, self.cfg, samples)

    def step(self, state, samples, draws):
        return afm.train_step_batch(state, samples, draws, self.cfg,
                                    stages=self.stages)

    def run(self, state, data, draws, num_steps=None):
        return afm.train(state, data, draws, self.cfg, num_steps=num_steps,
                         stages=self.stages)

    def to_dense(self, state: AFMState) -> AFMState:
        return state

    def from_dense(self, state: AFMState) -> AFMState:
        return state

    def bmu(self, w, samples):
        return search_lib.exact_bmu(w, samples)


@register_backend("batched")
class BatchedBackend(_DenseBackend):
    """Bulk-asynchronous training: ``cfg.batch`` samples in flight per step."""


@register_backend("reference")
class ReferenceBackend(_DenseBackend):
    """Faithful B = 1 dynamics: one sample, one relay race, one cascade per
    step, whatever ``cfg.batch`` says. Consumes the same total sample budget
    as ``batched`` and is bit-identical to it when ``cfg.batch == 1``."""

    def __init__(self, cfg: AFMConfig, *, search: str = "heuristic",
                 device: torch.device | str | None = None):
        super().__init__(dataclasses.replace(cfg, batch=1), search=search,
                         device=device)

    def step(self, state, samples, draws):
        """Consume a (B, D) batch strictly sequentially (B per-sample steps);
        aux comes back stacked per sample."""
        auxes = []
        for sample in samples:
            state, aux = afm.train_step(state, sample, draws, self.cfg,
                                        stages=self.stages)
            auxes.append(aux)
        return state, afm.stack_aux(auxes)


def _kernel_search(state, samples, draws, cfg, *, precision: str = "exact"
                   ) -> search_lib.SearchResult:
    """The exact search stage on the ``bmu`` kernel (its plain version on
    CPU tensors)."""
    del draws, cfg
    idx, q2 = bmu_ops.bmu(state.w, samples, precision=precision)
    zeros = torch.zeros(samples.shape[:1], dtype=torch.int32,
                        device=samples.device)
    return search_lib.SearchResult(idx, q2, zeros, zeros)


def kernel_stages(search: str = "exact", *, kernel: str = "staged",
                  precision: str = "exact") -> afm.Stages:
    """The stages of the ``kernel`` backend's step (see ``KernelBackend``):
    ``'staged'`` puts the exact search on the ``bmu`` kernel (the relay
    race stays as it is) and the cascade on ``drive_cascade_stage``;
    ``'fused'`` hands the whole step to the fused kernel. The AFM probe
    (``core.probe``) trains its map on the staged stages."""
    stages = _stages_for(search)
    if kernel == "fused":
        return stages._replace(fused=fused_ops.make_fused_stage(
            search=search, precision=precision))
    stages = stages._replace(cascade=cascade_ops.drive_cascade_stage)
    if search == "exact":
        stages = stages._replace(search=functools.partial(
            _kernel_search, precision=precision))
    return stages


@register_backend("kernel")
class KernelBackend(_DenseBackend):
    """Training through the CUDA kernels.

    ``kernel`` picks the step's execution:

    - ``'staged'`` (default): exact-BMU search via ``kernels.bmu.ops.bmu``,
      the plain Eq. 3 merge, then the drive and up to ``DEFAULT_WAVE_CAP``
      (16) waves in one launch of ``kernels.cascade.ops.drive_cascade``
      (``drive_cascade_stage``), which counts the front on the card.
    - ``'fused'``: the whole step after sampling (search, merge, drive and
      up to 16 waves) as one launch of ``kernels.fused``, plugged in through
      ``afm.Stages.fused``.

    Either way a longer cascade finishes in a tail loop of
    ``cascade_wave`` launches, and the step reads the front back once to
    decide whether it needs one; both take their cascade draws in the same
    order (drive, one block of 16 waves, one per tail wave), so one draw
    source trains both on the same numbers.

    ``search='heuristic'`` keeps the paper's relay race outside the kernels.
    ``precision`` picks the distance tier of the training search: ``'exact'``
    (f32) or ``'bf16'``. ``bmu()``, which serves inference, always stays on
    the exact tier of the BMU kernel.
    """

    KERNELS = ("staged", "fused")

    def __init__(self, cfg: AFMConfig, *, search: str = "exact",
                 kernel: str = "staged", precision: str = "exact",
                 device: torch.device | str | None = None):
        if kernel not in self.KERNELS:
            raise ValueError(f"kernel must be one of {self.KERNELS}, got "
                             f"{kernel!r}")
        if precision not in bmu_ops.PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{bmu_ops.PRECISIONS}, got {precision!r}")
        super().__init__(cfg, search=search, device=device)
        self.kernel = kernel
        self.precision = precision
        self.stages = kernel_stages(search, kernel=kernel,
                                    precision=precision)

    def bmu(self, w, samples):
        return bmu_ops.bmu(w, samples)


@register_backend("sharded")
class ShardedBackend:
    """Mesh training via ``core.distributed``: lattice rows over ``model``,
    samples over ``data``, one process a rank of ``mesh`` (a
    ``repro_torch.sharding.ShardMesh``; default 1 x 1, which needs no
    process group). The backend-native state is this rank's band
    (``shard_state_for_mesh``); ``to_dense`` gathers the bands back into
    the (N, D) form on every rank.

    Every rank is handed the same draw source and the same data (as JAX's
    replicated key): ``run`` draws each step's ``randint(0, num_samples,
    (B,))`` indices from it alike on every rank, and a rank trains on its
    data block of that batch. A step's own sources are ``spawn()`` of it
    with the rank's indices folded in (``GeneratorDraws.fold_in``), JAX's
    ``fold_in(fold_in(key, data index), model index)`` for the search and
    ``fold_in(fold_in(key, 10_000_019), model index)`` for the cascade.
    """

    def __init__(self, cfg: AFMConfig, *, mesh=None, data_axes=("data",),
                 model_axis: str = "model",
                 device: torch.device | str | None = None):
        if mesh is None:
            mesh = compat.ShardMesh((1, 1), ("data", "model"))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.model_axis = model_axis
        self.n_data = math.prod(mesh.axis_size(a) for a in self.data_axes)
        if cfg.batch % self.n_data:
            raise ValueError(f"batch={cfg.batch} must divide over the data "
                             f"axes' {self.n_data} ranks")
        self.step_fn = distributed.make_sharded_train_step(
            cfg, mesh, data_axes=self.data_axes, model_axis=model_axis)

    def init(self, draws, samples=None):
        return self.from_dense(afm.init(draws, self.cfg, samples))

    def from_dense(self, state: AFMState):
        return distributed.shard_state_for_mesh(state, self.cfg, self.mesh,
                                                self.model_axis)

    def step(self, state, samples, draws):
        """One step on the global (B, D) batch, of which this rank takes
        its data block."""
        child = draws.spawn()
        didx = distributed.data_index(self.mesh, self.data_axes)
        me = self.mesh.axis_index(self.model_axis)
        b = samples.shape[0] // self.n_data
        return self.step_fn(
            state, samples[didx * b:(didx + 1) * b],
            child.fold_in(didx).fold_in(me),
            child.fold_in(distributed.CASCADE_FOLD).fold_in(me))

    def run(self, state, data, draws, num_steps=None):
        num_steps = self.cfg.num_steps if num_steps is None else num_steps
        if num_steps < 0:
            raise ValueError(f"num_steps must be >= 0, got {num_steps}")
        auxes = []
        for _ in range(num_steps):
            idx = draws.randint(0, data.shape[0], (self.cfg.batch,))
            state, aux = self.step(state, data[idx], draws)
            auxes.append(aux)
        if not auxes:
            empty = torch.zeros((0,), dtype=torch.int32)
            return state, distributed.ShardedAux(
                empty, empty, torch.zeros((0,), dtype=torch.float32))
        return state, distributed.ShardedAux(
            *(torch.stack(field) for field in zip(*auxes)))

    def to_dense(self, state) -> AFMState:
        return distributed.gather_state(state, self.cfg, self.mesh,
                                        self.model_axis)

    def bmu(self, w, samples):
        return bmu_ops.bmu(w, samples)


# The event-driven trainer lives with the training code; importing it here
# (after the registry above exists: the module imports this one back) keeps
# "async" registered whenever the registry is.
from repro_torch.training import async_trainer as _async_trainer  # noqa: E402,F401
