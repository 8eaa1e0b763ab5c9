"""Draw sources: where every random number of a training step comes from.

The JAX package threads PRNG keys; the port threads one *draw source* in
their place. A step asks it for its draws in a fixed order, the order in
which the JAX step consumes its key chain:

1. search (heuristic only): ``randint(0, N, (B,))`` start units, then
   ``randint(0, phi + 1, (e, B))`` exploration hops;
2. drive: ``uniform((8, side, side))``;
3. each cascade wave: ``uniform((4, side, side))``.

The kernel backend's steps (``TopoMap(backend="kernel")``, staged or
fused: ``kernels.cascade.ops.drive_cascade_stage`` and
``kernels.fused.ops.fused_step_parts``) take their cascade draws as one
block: after 1 and 2 they draw **one** ``uniform((wave_cap, 4, side,
side))`` for the first ``wave_cap`` waves (all of them, however many run),
then one ``uniform((4, side, side))`` per wave of a cascade that outlives
the block. In JAX each wave's draw depends only on its position in the key
chain, so a replay stacks JAX's first ``wave_cap`` per-wave draws into that
block and the port's steps see JAX's numbers. From one ``GeneratorDraws``
seed the staged and fused kernel paths consume the stream identically
(and so do their CPU and CUDA versions), so the same seed trains both on
the same draws. The plain backends (``reference``, ``batched``) draw one
``uniform((4, side, side))`` per wave that runs, as 3 says.

``afm.train`` draws ``randint(0, num_samples, (B,))`` sample indices before
each step. LM serving (``serving.serve_step``) draws one ``gumbel((B, V))``
per decode step when it samples at a temperature, as
``jax.random.categorical`` adds ``jax.random.gumbel`` noise to the logits.
``GeneratorDraws`` is the production source (a ``torch.Generator`` on the
step's device); ``ReplayDraws`` hands out given arrays in order, so a test
can feed the port exactly the numbers a JAX key chain produced.

The ``async`` backend (``core.events``) gives every cascade a source of its
own, as JAX gives each sample event its own ``k_cascade`` chain: per sample
event it asks the run's source for

1. the search's draws (heuristic only), as above;
2. ``spawn()``: a child source that stands for ``k_cascade``. The child
   hands out the drive ``uniform((8, side, side))``, then one block
   ``uniform((wave_cap, 4, side, side))`` for the cascade's first
   ``wave_cap`` delivery rounds, then one ``uniform((4, side, side))`` per
   later round: the kernel paths' layout.

At nonzero latency the waves of different cascades interleave, so one
ordered stream could not replay them; a child per cascade can, and since
children are independent it does not matter that the zero-latency fast
path draws a child's block at its sample round and the engine at its first
delivery round. ``AsyncBackend.run`` first draws ``randint(0, num_samples,
(E,))`` sample indices for the whole run (JAX's ``_select_run_samples``).
The exponential latency model draws ``exponential((4 N,))`` delays from a
latency source of its own, once per broadcast that enqueues messages; an
active fault plan's broadcast loss draws ``uniform((4 N,))`` from a source
of its own (``GeneratorDraws(plan.seed)``, anew every run), once per
broadcast that sends.

A training stream that must resume bitwise after a crash
(``launch/stream_train.py``) takes each step's draws from
``GeneratorDraws.for_step(seed, step)``, a source that depends on the seed
and the step's index alone, the counterpart of JAX's
``fold_in(PRNGKey(seed), step)``: a resumed run consumes exactly the draws
the uninterrupted run would have.

A mesh (``core.placement.mesh``, ``core.distributed``) runs one rank a
shard, and each rank draws from sources of its own, as JAX folds the shard
index into every per-shard key: ``GeneratorDraws.fold_in(data)`` is the
counterpart of ``jax.random.fold_in(key, data)``. The event engine's shard
asks its source, per sample event, for the probe search's
``randint(0, L, (e // K,))`` (heuristic only), then ``spawn()``: the
cascade's child, which hands out the drive ``uniform(())``, then one
``uniform((4, side // K, side))`` per delivery round of that cascade on
the shard. The ``async`` backend splits each run's latency source off
its own (``GeneratorDraws.split``, as JAX splits ``lat_key`` once a run)
and folds the shard in, so the backend's one generator state is every
shard's latency position, as JAX's one ``lat_key`` is. The latency and
fault sources draw once at every fire (``(4 L,)``) and at every halo
exchange (``(2 side,)``), so a replay of JAX's per-shard streams, whose
shapes interleave as the run goes, gives ``ReplayDraws`` a mapping of both
shapes per draw site.
"""
from __future__ import annotations

import collections
from typing import Iterable, Protocol

import numpy as np
import torch

from repro_torch.device import resolve_device


class Draws(Protocol):
    device: torch.device

    def randint(self, low: int, high: int, shape: tuple[int, ...]
                ) -> torch.Tensor: ...       # int64 in [low, high)
    def uniform(self, shape: tuple[int, ...]) -> torch.Tensor: ...  # f32 [0,1)
    def normal(self, shape: tuple[int, ...]) -> torch.Tensor: ...   # f32 N(0,1)
    def gumbel(self, shape: tuple[int, ...]) -> torch.Tensor: ...   # f32 Gumbel
    def exponential(self, shape: tuple[int, ...]) -> torch.Tensor: ...  # Exp(1)
    def spawn(self) -> "Draws": ...          # a child source (one cascade)


_MASK64 = (1 << 64) - 1
#: mixed into the seed of ``GeneratorDraws.for_step``
_STEP_TAG = 0x5354455053545245
#: mixed into the seed of ``GeneratorDraws.fold_in``
_FOLD_TAG = 0x464F4C44494E5F31


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a well-spread 64-bit value from ``x``."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class GeneratorDraws:
    """Draws from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int = 0, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.spawned = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    @classmethod
    def for_step(cls, seed: int, step: int,
                 device: torch.device | str | None = None
                 ) -> "GeneratorDraws":
        """The draw source of step ``step`` of a stream seeded with
        ``seed``: its seed is mixed on the host from both (a tag keeps it
        apart from the seeds ``spawn`` hands out), so it does not depend
        on the steps before it."""
        return cls(_mix64(_mix64(int(seed) ^ _STEP_TAG) + int(step)), device)

    def spawn(self) -> "GeneratorDraws":
        """The next child source, seeded on the host from (seed, the count
        of children so far): no device read, and the parent's own stream
        does not move."""
        self.spawned += 1
        return GeneratorDraws(_mix64(_mix64(self.seed) + self.spawned),
                              self.device)

    def fold_in(self, data: int) -> "GeneratorDraws":
        """The source ``data`` (a shard's index) folded into this one, as
        ``jax.random.fold_in``: seeded on the host from this source's seed
        and ``data`` alone (a tag keeps it apart from ``spawn`` and
        ``for_step``), so every rank derives it alike, whatever either
        stream has drawn."""
        return GeneratorDraws(_mix64(_mix64(self.seed ^ _FOLD_TAG)
                                     + int(data)), self.device)

    def split(self) -> "GeneratorDraws":
        """A new source seeded by this one's next draw, as
        ``jax.random.split`` advances a key chain: this source's generator
        moves by one draw, so its state alone is the position of every
        source split from it (one device read on the card)."""
        seed = torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                             device=self.device)
        return GeneratorDraws(int(seed.item()), self.device)

    def randint(self, low, high, shape):
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self.generator, device=self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def gumbel(self, shape):
        """-log(-log(u)), u uniform in [tiny, 1), as ``jax.random.gumbel``."""
        u = self.uniform(shape).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def exponential(self, shape):
        """-log1p(-u), u uniform in [0, 1), as ``jax.random.exponential``."""
        return -torch.log1p(-self.uniform(shape))


class ReplayDraws:
    """Hands out pre-drawn arrays in order; each request must match the
    next array's shape (and, for ``randint``, its range), else it raises.
    A nested list in the sequence is a child's draws, which ``spawn``
    hands out as a ``ReplayDraws`` of its own. A mapping is one draw site
    that JAX may draw at any of several shapes: ``{shape: array}``, of
    which the request takes the array of its shape."""

    def __init__(self, arrays: Iterable, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self._queue = collections.deque(
            list(a) if isinstance(a, list) else
            {tuple(k): np.asarray(v) for k, v in a.items()}
            if isinstance(a, dict) else np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self._queue)

    def _next(self, kind: str, shape) -> np.ndarray:
        if not self._queue:
            raise IndexError(f"replay exhausted: {kind}{tuple(shape)} requested")
        arr = self._queue.popleft()
        if isinstance(arr, list):
            raise ValueError(f"replay mismatch: {kind}{tuple(shape)} requested,"
                             f" next item is a child's draws")
        if isinstance(arr, dict):
            if tuple(shape) not in arr:
                raise ValueError(f"replay mismatch: {kind}{tuple(shape)} "
                                 f"requested, the draw site has shapes "
                                 f"{sorted(arr)}")
            arr = arr[tuple(shape)]
        if arr.shape != tuple(shape):
            raise ValueError(f"replay mismatch: {kind}{tuple(shape)} requested,"
                             f" next array has shape {arr.shape}")
        return arr

    def randint(self, low, high, shape):
        arr = self._next("randint", shape)
        if arr.size and (arr.min() < low or arr.max() >= high):
            raise ValueError(f"replayed randint outside [{low}, {high})")
        return torch.as_tensor(arr.astype(np.int64), device=self.device)

    def uniform(self, shape):
        arr = self._next("uniform", shape)
        return torch.as_tensor(arr.astype(np.float32), device=self.device)

    def normal(self, shape):
        arr = self._next("normal", shape)
        return torch.as_tensor(arr.astype(np.float32), device=self.device)

    def gumbel(self, shape):
        arr = self._next("gumbel", shape)
        return torch.as_tensor(arr.astype(np.float32), device=self.device)

    def exponential(self, shape):
        arr = self._next("exponential", shape)
        return torch.as_tensor(arr.astype(np.float32), device=self.device)

    def spawn(self) -> "ReplayDraws":
        if not self._queue:
            raise IndexError("replay exhausted: spawn requested")
        item = self._queue.popleft()
        if not isinstance(item, list):
            raise ValueError(f"replay mismatch: spawn requested, next item "
                             f"is not a child's draws")
        return ReplayDraws(item, device=self.device)
