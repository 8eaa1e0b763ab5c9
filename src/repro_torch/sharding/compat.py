"""Named meshes over ``torch.distributed`` ranks (``ShardMesh``), the
counterpart of ``repro.sharding.compat``'s ``make_mesh``.

The JAX package runs a mesh as one SPMD program over devices
(``shard_map``); the port runs it as one process a shard, one rank each, as
under ``torchrun``. A ``ShardMesh`` names the axes of the ranks of an
initialised process group (``("data", "model")`` for the sharded backend,
``("shards",)`` for the event engine), rank ``r`` at the row-major
coordinates of ``r``, and gives the collectives the two JAX modules use,
under JAX's names: ``axis_index``, ``psum``, ``pmax``, ``all_gather`` and
``ppermute``. A collective over an axis of size 1 is the identity; an axis
that spans some of the ranks runs over a sub-group from ``new_group``
(``DeviceMesh`` would build the same groups, but binds one backend to one
device type, which the host traffic below does not fit).

Transport. The caller names it (``dist_backend``) and it is never switched:

- ``"nccl"``: one card a rank (``rank_device``); device tensors go over
  NCCL, host (CPU) tensors over gloo (the group is ``cpu:gloo,cuda:nccl``).
  NCCL refuses two ranks on one card in one communicator, so asking for
  it with more ranks than cards raises, naming gloo.
- ``"gloo"``: any number of ranks on one card (or on the CPU). Gloo's
  collectives on CUDA tensors are broadcast and all_reduce only, so
  ``all_gather`` (and ``ppermute``, built on it) on a CUDA tensor is an
  all_reduce of a zeroed buffer with one slot a rank, each rank writing
  the bytes of its tensor, viewed as int32 words, into its own slot: the
  sum leaves every slot as its owner wrote it, bit for bit. Gloo stages
  the buffer through host memory on its own; the tensors stay on the card
  in this code.

Every ``all_gather`` moves raw bytes, so floats (``-0.0`` and NaN
payloads too) arrive bitwise. A 1 x 1 mesh with no process group needs
none: its collectives are identities on the one rank, as JAX's default
``make_mesh((1, 1))`` is one device (``ShardMesh((1, 1), ("data",
"model"))``).
"""
from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

#: transports a caller may name
DIST_BACKENDS = ("gloo", "nccl")


def _check_backend(dist_backend: str) -> None:
    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"dist_backend must be one of {DIST_BACKENDS}, got "
                         f"{dist_backend!r}")


def rank_device(dist_backend: str, local_rank: int = 0,
                device: torch.device | str | None = None) -> torch.device:
    """The device a rank computes on: under NCCL the card of its local
    rank; under gloo ``device`` (CUDA by default), shared by all ranks."""
    _check_backend(dist_backend)
    if dist_backend == "nccl":
        return torch.device("cuda", local_rank)
    return torch.device("cuda" if device is None else device)


def init_distributed(rank: int, world_size: int, *, dist_backend: str = "gloo",
                     init_method: str = "env://", local_rank: int | None = None,
                     timeout: float = 600.0) -> None:
    """Join this process to a ``world_size``-rank process group as ``rank``
    over the transport ``dist_backend`` (see the module docstring).
    ``init_method`` is torch's rendezvous (``env://`` under ``torchrun``,
    ``file://<path>`` for spawned ranks). A collective that waits longer
    than ``timeout`` seconds fails."""
    _check_backend(dist_backend)
    backend = "gloo"
    if dist_backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not cards:
            raise ValueError("dist_backend='nccl' runs one rank a CUDA card "
                             "and none is visible; use dist_backend='gloo' "
                             "on the CPU")
        if world_size > cards:
            raise ValueError(
                f"dist_backend='nccl' runs one rank a card, but {world_size} "
                f"rank(s) share {cards} card(s): NCCL refuses two ranks on one"
                f" device in one communicator; use dist_backend='gloo' to put"
                f" several ranks on one card")
        torch.cuda.set_device(rank if local_rank is None else local_rank)
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def transport() -> str:
    """The initialised process group's transport for device tensors."""
    return "nccl" if "nccl" in str(dist.get_backend()) else "gloo"


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


class ShardMesh:
    """Named axes over the ranks of the process group (see the module
    docstring). ``shape`` maps axis names to sizes, as JAX's
    ``mesh.shape``; their product must equal the group's world size."""

    def __init__(self, axis_sizes: tuple[int, ...],
                 axis_names: tuple[str, ...]):
        sizes = tuple(int(s) for s in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one unique name an axis, got "
                             f"sizes {sizes} and names {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        self.shape = dict(zip(names, sizes))
        self.axis_names = names
        self.size = math.prod(sizes)
        self.distributed = dist.is_available() and dist.is_initialized()
        if self.distributed:
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(
                    f"a {'x'.join(map(str, sizes))} mesh needs {self.size} "
                    f"rank(s), but the process group has {world}")
            self.rank = dist.get_rank()
            self.dist_backend = transport()
        elif self.size > 1:
            raise RuntimeError(
                f"a {'x'.join(map(str, sizes))} mesh runs one process a rank:"
                f" initialise torch.distributed first (run under torchrun, or"
                f" repro_torch.sharding.spawn_ranks), {self.size} ranks")
        else:
            self.rank, self.dist_backend = 0, None
        self.coords = tuple(_unravel(self.rank, sizes))
        #: collectives this mesh has run (identities excluded)
        self.calls = 0
        self._groups = {name: self._axis_group(i, sizes)
                        for i, name in enumerate(names)}

    def _axis_group(self, axis: int, sizes: tuple[int, ...]):
        """The process group of one axis: None (the default group) when it
        spans every rank or there is no group; else this rank's sub-group,
        made with ``new_group`` on every rank in the same order."""
        if not self.distributed or sizes[axis] == self.size:
            return None
        mine = None
        for other in itertools.product(*[range(s) for i, s in
                                         enumerate(sizes) if i != axis]):
            ranks = []
            for k in range(sizes[axis]):
                coords = list(other)
                coords.insert(axis, k)
                ranks.append(_ravel(coords, sizes))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def __repr__(self):
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"ShardMesh({axes}; rank {self.rank}, "
                f"{self.dist_backend or 'no process group'})")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape): every rank's ``x`` along ``axis`` in
        coordinate order, bitwise, on ``x``'s device."""
        n = self.shape[axis]
        if not self.distributed:
            return x.unsqueeze(0).clone()
        group = self._groups[axis]
        self.calls += 1
        raw = _bytes(x)
        if x.is_cuda and self.dist_backend == "gloo":
            # gloo on CUDA tensors: an all_reduce of one slot a rank
            words = -(-raw.numel() // 4)
            buf = torch.zeros((n, 4 * words), dtype=torch.uint8,
                              device=x.device)
            buf[self.axis_index(axis), :raw.numel()] = raw
            dist.all_reduce(buf.view(torch.int32), group=group)
            out = buf[:, :raw.numel()].contiguous()
        else:
            outs = [torch.empty_like(raw) for _ in range(n)]
            dist.all_gather(outs, raw, group=group)
            out = torch.stack(outs)
        return out.view(x.dtype).reshape((n,) + tuple(x.shape))

    def _reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        if not self.distributed:
            return x.clone()
        self.calls += 1
        y = (x.to(torch.int32) if x.dtype == torch.bool else x).clone()
        flat = y.reshape(-1)
        dist.all_reduce(flat, op=op, group=self._groups[axis])
        return flat.reshape(x.shape)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over ``axis`` (bool counts as int32). Float sums of more than
        two ranks come in the transport's order: ULP-bounded."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """JAX's ``ppermute``: rank ``j`` receives the ``x`` of the ``i``
        with ``(i, j)`` in ``perm`` (coordinates on ``axis``), zeros when no
        pair names it. One ``all_gather``, then a slice."""
        src = {j: i for i, j in perm}.get(self.axis_index(axis))
        if src is None:
            if self.distributed:
                self.all_gather(x, axis)       # every rank joins
            return torch.zeros_like(x)
        return self.all_gather(x, axis)[src]


class SumOver(torch.autograd.Function):
    """``SumOver.apply(x, mesh, dims)``: the sum of a local tensor over the
    ``DeviceMesh`` dims ``dims`` (a functional all-reduce of each), whose
    gradient is the incoming one unchanged: Megatron's reduce from the
    model-parallel region, for code on local shards under ``local_map``
    (the functional collectives carry no gradient, and a ``Partial``
    output of ``local_map`` hands each rank 1/n of it)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        import torch.distributed._functional_collectives as funcol
        for m in dims:
            x = funcol.all_reduce(x, "sum", (mesh, m))
            x = x.wait() if hasattr(x, "wait") else x
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class DeviceMeshAxes:
    """``ShardMesh``'s collective interface (``shape``, ``axis_index``,
    ``psum``, ``all_gather``) over the named dims of a
    ``DeviceMesh``, for code that runs on local shards under
    ``local_map`` (the MoE layer's ``moe_ep_path`` in the dry run, as JAX
    runs it under ``shard_map``). The collectives are functional
    collectives over one mesh dim, which ``CommDebugMode`` counts;
    ``psum`` is differentiable (``SumOver``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))
        self.size = math.prod(mesh.shape)

    def axis_index(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def _group(self, axis: str):
        return (self.mesh, self.axis_names.index(axis))

    @staticmethod
    def _wait(x):
        return x.wait() if hasattr(x, "wait") else x

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis``; its gradient passes through unchanged
        (``SumOver``), as the sum of a replicated consumer's partials."""
        return SumOver.apply(x, self.mesh, (self.axis_names.index(axis),))

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape), every rank's ``x`` along ``axis``."""
        import torch.distributed._functional_collectives as funcol
        out = self._wait(funcol.all_gather_tensor(x.contiguous(), 0,
                                                  self._group(axis)))
        return out.reshape((self.shape[axis],) + tuple(x.shape))


class AbstractMesh(NamedTuple):
    """Axis names and sizes with no ranks behind them, JAX's
    ``AbstractMesh``: enough for the sharding rules (``shape``)."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...]) -> AbstractMesh:
    """``abstract_mesh((16, 16), ("data", "model"))``, JAX's
    ``compat.abstract_mesh``: a mesh shape and no process group."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"a mesh needs one name an axis, got sizes "
                         f"{axis_sizes} and names {axis_names}")
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))


def _unravel(index: int, sizes: tuple[int, ...]) -> list[int]:
    out = []
    for s in reversed(sizes):
        out.append(index % s)
        index //= s
    return out[::-1]


def _ravel(coords, sizes) -> int:
    index = 0
    for c, s in zip(coords, sizes):
        index = index * s + c
    return index


# ---------------------------------------------------------------- launcher


def _rank_main(fn, rank, world_size, dist_backend, init_method, timeout,
               args, results):
    try:
        init_distributed(rank, world_size, dist_backend=dist_backend,
                         init_method=init_method, timeout=timeout)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn_ranks(fn, world_size: int, args: tuple = (), *,
                dist_backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes (the spawn
    start method: CUDA cannot fork), joined in one process group over
    ``dist_backend`` through a ``FileStore`` in a temporary directory, and
    return each rank's result in rank order. ``fn`` must be importable by
    the children (a module-level function) and its result picklable.

    Fails, after stopping every rank, as soon as one raises or dies, or
    when the ranks have not all finished within ``timeout`` seconds: a
    deadlocked collective ends in a ``TimeoutError``, never in a hang."""
    _check_backend(dist_backend)
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, dist_backend, init_method, timeout, args,
            results)) for r in range(world_size)]
        out = {}
        try:
            for p in procs:
                p.start()
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} rank(s) of {fn.__name__} did not "
                        f"finish within {timeout:.0f} s (ranks done: "
                        f"{sorted(out)})")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} of {fn.__name__} exited with "
                            f"code(s) {[procs[r].exitcode for r in dead]} "
                            f"and no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                       f"failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
            results.close()
    return [out[r] for r in range(world_size)]
