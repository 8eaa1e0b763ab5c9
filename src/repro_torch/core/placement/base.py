"""The placement seam of the discrete-event engine, port of
``repro.core.placement.base``.

``core.events`` simulates rounds over a message pool; a ``Placement``
decides where that pool (and the unit state it serves) lives. The engine
asks it four things:

- **pool allocation**: ``pool_capacity(cfg, ecfg)``, the message slots of
  one pool;
- **round selection**: ``pack_scale`` / ``make_selector``, how the minimal
  ``(time, generation, cascade-id)`` round key is found (a packed
  two-lane min when ``gen · E + cid`` fits 32 bits, the exact 3-field
  lexicographic min otherwise);
- **message routing**: ``routing(near)``, the (source, destination,
  receiver-side direction) tables of a fire's outgoing broadcasts;
- **execution**: ``build_runner(...)``, the run itself,
  ``go(state, samples, draws, lat_draws, donate, fault_draws=, dead=)
  -> (state, aux, report)``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Placement(Protocol):
    """What the event engine needs from a placement (see module docstring)."""

    name: str

    @property
    def shards(self) -> int: ...

    def pool_capacity(self, cfg, ecfg) -> int: ...

    def pack_scale(self, cfg, ecfg, num_events: int) -> int | None: ...

    def make_selector(self, cfg, ecfg, num_events: int): ...

    def routing(self, near): ...

    def build_runner(self, cfg, ecfg, num_events: int,
                     search, p_fn, l_c_fn): ...


def resolve_placement(spec=None, *, shards: int | None = None) -> Placement:
    """Normalise a placement spec: ``None`` / ``'single'`` -> ``SinglePool``,
    ``'mesh'`` -> ``MeshPlacement(shards)``, a ``Placement`` instance passes
    through (its shard count must agree with ``shards`` when both are
    given)."""
    from repro_torch.core.placement.mesh import MeshPlacement
    from repro_torch.core.placement.single import SinglePool

    if spec is None or spec == "single":
        if shards not in (None, 1):
            raise ValueError(
                f"placement 'single' is one pool on one device; shards="
                f"{shards} needs placement='mesh'")
        return SinglePool()
    if spec == "mesh":
        return MeshPlacement(shards=1 if shards is None else int(shards))
    if isinstance(spec, Placement):
        if shards is not None and spec.shards != shards:
            raise ValueError(
                f"placement {spec!r} has shards={spec.shards}, but shards="
                f"{shards} was also requested")
        return spec
    raise ValueError(
        f"placement must be None, 'single', 'mesh', or a Placement, "
        f"got {spec!r}")
