"""Fault plans for the event engine, port of ``repro.faults``.

A ``FaultPlan`` describes faults to inject into ``core.events``: broadcast
loss (``p_loss``), unit dropout windows (``dropout_frac`` /
``dropout_start`` / ``dropout_len``), shard stragglers
(``shard_latency_mult``) and pool pressure (``pool_reserve``), seeded by a
stream of its own. The port has the plan and its validation; the engine
accepts ``None`` or a plan with no active axis and raises
``NotImplementedError`` for an active one (fault injection is ROADMAP
queue 1, item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["FaultPlan", "resolve_plan"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, hashable fault-injection plan (fields as ``repro.faults``)."""
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

    def is_none(self) -> bool:
        """True when no fault axis is active (a seed alone activates
        nothing)."""
        return (self.p_loss == 0.0 and not self.dropout_active
                and not self.shard_latency_mult and self.pool_reserve == 0)

    @property
    def dropout_active(self) -> bool:
        return self.dropout_frac > 0.0 and self.dropout_len > 0.0


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
