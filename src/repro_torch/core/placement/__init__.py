"""Placement seam of the discrete-event engine, port of
``repro.core.placement``.

A ``Placement`` answers the engine's four questions: pool allocation,
round selection, message routing and execution. ``SinglePool`` is one
dense pool on one device. The mesh placement (``'mesh'``, units and pool
partitioned across devices) is ROADMAP queue 1, item 5:
``resolve_placement('mesh')`` raises ``NotImplementedError``.
"""
from repro_torch.core.placement.base import Placement, resolve_placement
from repro_torch.core.placement.single import SinglePool

__all__ = ["Placement", "SinglePool", "resolve_placement"]
