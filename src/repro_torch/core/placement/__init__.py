"""Placement seam of the discrete-event engine, port of
``repro.core.placement``.

A ``Placement`` answers the engine's four questions: pool allocation,
round selection, message routing and execution. ``SinglePool`` is one
dense pool on one device; ``MeshPlacement`` partitions the units and the
pool into row bands over ``torch.distributed`` ranks, one process a shard.
"""
from repro_torch.core.placement.base import Placement, resolve_placement
from repro_torch.core.placement.mesh import MeshPlacement
from repro_torch.core.placement.single import SinglePool

__all__ = ["MeshPlacement", "Placement", "SinglePool", "resolve_placement"]
