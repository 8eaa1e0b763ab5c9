"""The ``async`` execution backend: event-driven asynchronous training,
port of ``repro.training.async_trainer``.

Wires the discrete-event engine (``repro_torch.core.events``) into the
``Backend`` protocol of ``repro_torch.api.backends``. Where ``batched``
approximates the paper's asynchrony by merging B relay races into one
synchronous step, ``async`` executes it: sample deliveries and weight
broadcasts are timed messages between units, cascades of different samples
overlap in flight, and a latency model sets how stale a broadcast's weights
may be. At zero latency every cascade completes before the next sample
arrives, and the backend runs ``reference``'s dynamics on the kernels.

State between calls is the plain dense ``AFMState``: ``run_events`` drains
the message queue before it returns, so ``to_dense`` / ``from_dense`` are
the identity.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import backends as backends_lib
from repro_torch.core import afm
from repro_torch.core import events as events_lib
from repro_torch.core import placement as placement_lib
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.core.events import EventConfig, EventReport  # noqa: F401
from repro_torch.core.placement import mesh as mesh_lib
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws
from repro_torch.faults import resolve_plan
from repro_torch.kernels.bmu import ops as bmu_ops

_SEARCHES = {"heuristic": afm.search_heuristic,
             "exact": events_lib.search_exact}


@backends_lib.register_backend("async")
class AsyncBackend:
    """Event-driven training: per-sample dynamics under a message-latency
    model (``repro_torch.core.events``).

    Options:
      latency:   'zero' (default) | 'constant' | 'exponential'.
      delay:     latency scale in sample periods (see ``EventConfig``).
      sample_spacing / capacity / max_rounds / engine: forwarded to
                 ``EventConfig``; ``engine='auto'`` sends eligible
                 zero-latency runs to the fast path, ``engine='event'``
                 always simulates rounds.
      search:    'heuristic' (the paper's relay race, default) or 'exact'
                 (the ``bmu`` kernel at B = 1; the fused fast path searches
                 in its kernel).
      kernel:    the zero-latency fast path's step, 'staged' (the search,
                 the plain merge and one ``drive_cascade`` launch) or
                 'fused' (one ``fused_step`` launch).
      placement: 'single' (one pool, one device) or 'mesh' (row bands
                 of the lattice over ``shards`` ranks of a
                 ``torch.distributed`` group, one process a shard:
                 ``core.placement.mesh``; every rank runs the same calls).
      shards:    ranks of the mesh; must divide ``cfg.side``. ``shards=1``
                 runs the single-pool engine.
      lat_seed:  seed of the exponential-latency draw source
                 (``lat_draws``), kept apart from the training draws; on a
                 multi-shard mesh each run splits a source off it
                 (``GeneratorDraws.split``) and each shard draws from that
                 source's ``fold_in(shard)``.
      faults:    ``None``, a ``repro_torch.faults.FaultPlan`` or a mapping
                 of its fields (broadcast loss, dropout windows, pool
                 pressure, per-shard stragglers); an active plan runs the
                 discrete-event engine. ``shard_latency_mult`` needs the
                 mesh placement, one multiplier a shard.
      donate_run: let each ``run()`` update its input state's tensors in
                 place (the engine's runners), saving a copy of the dense
                 state per run; only for callers that drop the state they
                 pass, as ``TopoMap.fit`` does.
      device:    where the backend runs (CUDA unless the caller asks for
                 the CPU).

    Like ``reference`` the config is forced to ``batch=1``: the engine is
    per-sample, and the ``i_max`` sample budget maps to ``i_max`` events.
    ``last_report`` holds the latest run's ``EventReport``. ``lat_draws``
    is the latency stream (the counterpart of JAX's ``lat_key``); its
    position, ``lat_draws.generator.get_state()``, is what a checkpoint
    keeps to replay an exponential-latency run's delays on resume. On a
    multi-shard mesh that one state is every shard's position too: a run
    moves it by one draw, whose value seeds the run's shard streams, as
    JAX splits ``lat_key`` once a run and folds the shard in.

    On a multi-shard mesh a run's events draw from ``draws.spawn()`` with
    the shard's index folded in (``GeneratorDraws.fold_in``), the
    counterpart of JAX's ``fold_in(step_key, shard)``, after the sample
    indices, which every rank draws alike from ``draws``.
    """

    def __init__(self, cfg: AFMConfig, *, latency: str = "zero",
                 delay: float = 0.0, sample_spacing: float = 1.0,
                 capacity: int | None = None, max_rounds: int | None = None,
                 engine: str = "auto", search: str = "heuristic",
                 kernel: str = "staged", placement: str = "single",
                 shards: int = 1, lat_seed: int = 0, faults=None,
                 donate_run: bool = False,
                 device: torch.device | str | None = None):
        if search not in _SEARCHES:
            raise ValueError(f"search must be one of {sorted(_SEARCHES)}, "
                             f"got {search!r}")
        self.cfg = dataclasses.replace(cfg, batch=1)
        self.ecfg = EventConfig(latency=latency, delay=delay,
                                sample_spacing=sample_spacing,
                                capacity=capacity, max_rounds=max_rounds,
                                engine=engine, kernel=kernel,
                                faults=resolve_plan(faults))
        # fail fast: a bad placement spec or an indivisible shard count
        # surfaces at construction, not on the first training call
        self.placement = placement_lib.resolve_placement(
            placement, shards=int(shards))
        if self.placement.shards > 1:
            if cfg.side % self.placement.shards:
                raise ValueError(
                    f"side={cfg.side} must divide into shards="
                    f"{self.placement.shards} contiguous row bands")
            if max_rounds is not None:
                raise ValueError("max_rounds is single-pool only; drop it "
                                 "or use placement='single'")
        self.device = resolve_device(device)
        self.search = _SEARCHES[search]
        self.lat_draws = GeneratorDraws(lat_seed, self.device)
        self.last_report: EventReport | None = None
        self._donate_run = bool(donate_run)

    def init(self, draws, samples=None) -> AFMState:
        return afm.init(draws, self.cfg, samples)

    def _run(self, state, samples, draws, donate=False):
        lat_draws = self.lat_draws
        if self.placement.shards > 1:
            shard = mesh_lib.shard_mesh(self.placement.shards).axis_index(
                mesh_lib.AXIS)
            draws = draws.spawn().fold_in(shard)
            lat_draws = self.lat_draws.split().fold_in(shard)
        state, aux, report = events_lib.run_events(
            state, samples, draws, self.cfg, self.ecfg, search=self.search,
            lat_draws=lat_draws, donate=donate, placement=self.placement)
        self.last_report = report
        return state, aux

    def step(self, state: AFMState, samples, draws):
        """Consume a (B, D) batch as B timed sample-delivery events."""
        return self._run(state, samples.to(torch.float32), draws)

    def run(self, state: AFMState, data, draws, num_steps=None):
        """A training run of ``num_steps`` events drawn with replacement:
        ``randint(0, num_samples, (num_steps,))`` indices first (JAX's
        ``_select_run_samples`` selects the whole run's samples before it),
        then the events' own draws."""
        num_steps = self.cfg.num_steps if num_steps is None else num_steps
        idx = draws.randint(0, data.shape[0], (num_steps,))
        return self._run(state, data[idx].to(torch.float32), draws,
                         donate=self._donate_run)

    def to_dense(self, state: AFMState) -> AFMState:
        return state

    def from_dense(self, state: AFMState) -> AFMState:
        return state

    def bmu(self, w, samples):
        return bmu_ops.bmu(w, samples)
