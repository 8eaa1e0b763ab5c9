"""Joining the ranks of a run, shared by the CLIs that train over several
processes (``launch/train_map.py``, ``launch/stream_train.py``).

A run of several ranks is one process a rank, as ``torchrun`` starts them:
each joins the process group from ``torchrun``'s environment unless it is
in one already (``repro_torch.sharding.spawn_ranks``), and the group's
transport is the one ``--dist-backend`` names, never another.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding import compat


def ranks_needed(args, mesh_shape: tuple[int, int] = (1, 1)) -> int:
    """The ranks a run of these flags needs: the sharded backend's
    ``mesh_shape`` (data x model), the async backend's ``--shards``, else
    one."""
    if args.backend == "sharded":
        return mesh_shape[0] * mesh_shape[1]
    return args.shards if args.backend == "async" else 1


def join_ranks(args, world: int, module: str) -> tuple[int, torch.device]:
    """(this rank, its device) for a run of ``world`` ranks of the CLI
    ``module`` (named in the message that says how to start it). One rank
    outside a process group needs none."""
    if world == 1 and not dist.is_initialized():
        return 0, resolve_device(args.device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"this run needs {world} ranks, one process each: start it "
                f"under torchrun --nproc-per-node {world} -m {module} ... "
                f"--dist-backend {args.dist_backend}")
        compat.init_distributed(
            int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            dist_backend=args.dist_backend, init_method="env://",
            local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    if compat.transport() != args.dist_backend:
        raise SystemExit(f"the process group runs over "
                         f"{compat.transport()}, not --dist-backend "
                         f"{args.dist_backend}")
    if dist.get_world_size() != world:
        raise SystemExit(f"this run needs {world} ranks, but the process "
                         f"group has {dist.get_world_size()}")
    rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.dist_backend == "nccl":
        return rank, compat.rank_device("nccl", local)
    return rank, resolve_device(args.device)
