"""Deterministic fault injection for the event engine (``FaultPlan``), port
of ``repro.faults``.

The paper's claim is robustness by construction: units adapt on their own
through sparse local messages, so the map should degrade gracefully when
messages are lost or units die. A ``FaultPlan`` is a frozen, hashable
description of the faults to inject, seeded by a stream of its own, so a
faulty run replays bitwise for a given ``(plan, draws)`` and a run without
an active axis consumes exactly the fault-free engine's draws.

Fault axes, composable and each counted in ``EventReport``:

- **broadcast loss** (``p_loss``): each weight-broadcast message is lost
  with probability ``p_loss``, drawn from the plan's own source
  (``GeneratorDraws(seed)``, made anew for every run). Lost messages count
  as ``dropped_fault``, so ``sent == deliveries + dropped_overflow +
  dropped_fault + stranded`` always holds (on a mesh, shard by shard: a
  shard draws its loss from ``GeneratorDraws(seed).fold_in(shard)``).
- **unit dropout windows** (``dropout_frac`` / ``dropout_start`` /
  ``dropout_len``): ``dead_units`` is dead for the simulated time window
  ``[dropout_start, dropout_start + dropout_len)``. Dead units neither
  adapt nor broadcast; messages to a dead unit are consumed as
  ``dropped_fault``; samples routed to a dead GMU count in
  ``samples_dead``. After the window a unit rejoins with its counter.
- **shard stragglers** (``shard_latency_mult``): per-shard latency
  multipliers of the mesh placement, one a shard: every message entering
  shard k's pool (its own and the halo arrivals, whose delays the receiver
  draws) takes ``mult[k]`` times longer. The single pool refuses them.
- **pool pressure** (``pool_reserve``): slots withheld from the pool,
  forcing overflow drops, which count as ``dropped_overflow``, never as
  fault drops.

``EventConfig(faults=plan)`` (or ``backend_options={"faults": {...}}`` on
the ``async`` backend) threads a plan into the engine. ``None``,
``FaultPlan.none()`` and a seed-only plan run the fault-free engine.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

__all__ = ["FaultPlan", "resolve_plan"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, hashable fault-injection plan (fields as ``repro.faults``).

    seed:               root of the plan's draws (message loss, the dead
                        set), apart from the training and latency streams.
    p_loss:             per-message broadcast loss probability in [0, 1].
    dropout_frac:       fraction of units dead during the window, in [0, 1].
    dropout_start:      simulated time the window opens (sample periods).
    dropout_len:        window length; 0 disables dropout.
    shard_latency_mult: per-shard latency multipliers (mesh only).
    pool_reserve:       pool slots withheld to force overflow (>= 0).
    """
    seed: int = 0
    p_loss: float = 0.0
    dropout_frac: float = 0.0
    dropout_start: float = 0.0
    dropout_len: float = 0.0
    shard_latency_mult: tuple = ()
    pool_reserve: int = 0

    def __post_init__(self):
        for name, kind in (("seed", int), ("p_loss", float),
                           ("dropout_frac", float), ("dropout_start", float),
                           ("dropout_len", float), ("pool_reserve", int)):
            object.__setattr__(self, name, kind(getattr(self, name)))
        object.__setattr__(self, "shard_latency_mult",
                           tuple(float(x) for x in self.shard_latency_mult))
        if not 0.0 <= self.p_loss <= 1.0:
            raise ValueError(f"p_loss must be in [0, 1], got {self.p_loss}")
        if not 0.0 <= self.dropout_frac <= 1.0:
            raise ValueError(
                f"dropout_frac must be in [0, 1], got {self.dropout_frac}")
        if self.dropout_start < 0 or self.dropout_len < 0:
            raise ValueError("dropout_start/dropout_len must be >= 0")
        if any(x <= 0 for x in self.shard_latency_mult):
            raise ValueError("shard_latency_mult entries must be > 0, got "
                             f"{self.shard_latency_mult}")
        if self.pool_reserve < 0:
            raise ValueError(
                f"pool_reserve must be >= 0, got {self.pool_reserve}")

    @classmethod
    def none(cls) -> "FaultPlan":
        """The fault-free plan: the same engine as ``faults=None``."""
        return cls()

    def is_none(self) -> bool:
        """True when no fault axis is active (a seed alone activates
        nothing)."""
        return (self.p_loss == 0.0 and not self.dropout_active
                and not self.shard_latency_mult and self.pool_reserve == 0)

    @property
    def dropout_active(self) -> bool:
        return self.dropout_frac > 0.0 and self.dropout_len > 0.0

    def dead_units(self, n: int) -> torch.Tensor:
        """(N,) bool CPU tensor: exactly ``round(dropout_frac * n)`` units,
        the head of ``torch.randperm(n)`` from a CPU generator seeded with
        ``seed``, so the set is the same whichever device the run is on.
        (JAX draws its set with ``jax.random.permutation``: the two
        packages' sets differ, as their link tables do.)"""
        dead = torch.zeros(n, dtype=torch.bool)
        k = int(round(self.dropout_frac * n))
        if k == 0 or not self.dropout_active:
            return dead
        gen = torch.Generator().manual_seed(self.seed)
        dead[torch.randperm(n, generator=gen)[:k]] = True
        return dead


def resolve_plan(spec) -> FaultPlan | None:
    """``None`` and a ``FaultPlan`` pass through; a mapping becomes
    ``FaultPlan(**spec)`` (the ``backend_options={"faults": {...}}``
    spelling)."""
    if spec is None or isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, Mapping):
        return FaultPlan(**spec)
    raise ValueError(
        f"faults must be None, a FaultPlan, or a mapping of FaultPlan "
        f"fields, got {spec!r}")
