"""Meshes of ``torch.distributed`` ranks for the port (``ShardMesh``, the
counterpart of ``repro.sharding``'s ``make_mesh``) and the launcher that
starts them (``spawn_ranks``)."""
from repro_torch.sharding.compat import (DIST_BACKENDS, ShardMesh,
                                         init_distributed, rank_device,
                                         spawn_ranks, transport)

__all__ = ["DIST_BACKENDS", "ShardMesh", "init_distributed", "rank_device",
           "spawn_ranks", "transport"]
