"""Production and host meshes, a port of ``repro.launch.mesh``.

Defined as functions, not module-level constants, so that importing this
module touches no device and no process group. The production meshes are
``DeviceMesh``es over the initialised default group: NCCL ranks under
``torchrun`` on a cluster, or the dry run's fake group
(``repro_torch.launch.dryrun``) with ``device_type="cpu"``. The host mesh is
a ``ShardMesh`` over the initialised group (none for 1 x 1).
"""
from __future__ import annotations

from repro_torch.sharding.compat import ShardMesh
from repro_torch.sharding.rules import mesh_shape


def production_shape(multi_pod: bool = False) -> tuple:
    """(sizes, names): 16 x 16 (data, model) a pod; 2 x 16 x 16 (pod, data,
    model) over two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, which
    must have 256 (or, ``multi_pod``, 512) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sizes, names = production_shape(multi_pod)
    need = 1
    for s in sizes:
        need *= s
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"the {'x'.join(map(str, sizes))} production mesh needs an "
            f"initialised process group of {need} ranks, found {have}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1) -> ShardMesh:
    """A (data, model) mesh over the ranks of the initialised group (tests);
    1 x 1 needs none."""
    return ShardMesh((data, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """The mesh's batch axes, ``pod`` before ``data``."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)
