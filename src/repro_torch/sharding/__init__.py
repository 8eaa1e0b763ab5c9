"""Meshes of ``torch.distributed`` ranks for the port (``ShardMesh``, the
counterpart of ``repro.sharding``'s ``make_mesh``), the launcher that
starts them (``spawn_ranks``), abstract meshes, and the partition-spec
rules of the production meshes (``rules``)."""
from repro_torch.sharding.compat import (DIST_BACKENDS, AbstractMesh,
                                         ShardMesh, abstract_mesh,
                                         init_distributed, rank_device,
                                         spawn_ranks, transport)
from repro_torch.sharding.rules import (P, batch_specs, cache_specs,
                                        param_specs, placements,
                                        train_state_specs)

__all__ = ["DIST_BACKENDS", "AbstractMesh", "P", "ShardMesh",
           "abstract_mesh", "batch_specs", "cache_specs", "init_distributed",
           "param_specs", "placements", "rank_device", "spawn_ranks",
           "train_state_specs", "transport"]
