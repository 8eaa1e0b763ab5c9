"""Everything a run is fed, made from ``--seed``: tokens, the probe's
draws, and the prompt-length ladder. Both the program and the reference
get these same tensors.

The token source is a frozen copy of the port's Markov corpus
(``repro_torch.data.tokens``): a first-order chain over the vocabulary
whose rows are sparse (8 successors a token, Zipf weights ``1/r``
normalised), with a 2 % uniform resample a step, drawn on a CPU
``torch.Generator`` and walked with numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
#: share of the steps of a sequence that resample a token uniformly
RESAMPLE = 0.02
SUCCESSORS = 8


def mix64(*parts: int) -> int:
    """A well-spread 63-bit seed from whole numbers (splitmix64's
    finaliser folded over ``parts``); any size of ``--seed`` goes in."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


class SeededDraws:
    """The draw source handed to the program's probe: uniform, normal and
    integer draws from a ``torch.Generator`` on ``device`` seeded with
    ``seed``. Two sources of one seed give the same numbers for the same
    requests, so the reference replays a step's draws by asking a fresh
    source for them."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def randint(self, low, high, shape):
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self.generator, device=self.device)


def step_draws(seed: int, step: int, device) -> SeededDraws:
    """The probe's draw source of train step ``step`` (0-based)."""
    return SeededDraws(mix64(seed, 0x5052, step), device)


def markov(generator: torch.Generator, vocab: int):
    """(vocab, 8) int64 successor table and (8,) f32 Zipf weights."""
    table = torch.randint(0, vocab, (vocab, SUCCESSORS), generator=generator)
    w = 1.0 / torch.arange(1, SUCCESSORS + 1, dtype=torch.float32)
    return table, w / w.sum()


def markov_rows(generator: torch.Generator, table: torch.Tensor,
                weights: torch.Tensor, rows: int, seq: int) -> torch.Tensor:
    """(rows, seq) int32 tokens on the CPU: a uniform first token, then the
    successor of the token before chosen by ``weights``, or with
    probability ``RESAMPLE`` a uniform token."""
    vocab = table.shape[0]
    first = torch.randint(0, vocab, (rows,), generator=generator)
    steps = max(seq - 1, 0)
    choice = torch.multinomial(weights, rows * steps, replacement=True,
                               generator=generator).reshape(rows, steps)
    fresh = torch.randint(0, vocab, (rows, steps), generator=generator)
    resample = torch.rand((rows, steps), generator=generator) < RESAMPLE
    table_np, choice_np = table.numpy(), choice.numpy()
    fresh_np, resample_np = fresh.numpy(), resample.numpy()
    out = np.empty((rows, seq), np.int32)
    tok = first.numpy()
    out[:, 0] = tok
    for t in range(steps):
        tok = np.where(resample_np[:, t], fresh_np[:, t],
                       table_np[tok, choice_np[:, t]])
        out[:, t + 1] = tok
    return torch.from_numpy(out)


class TokenStream:
    """The Markov chain of one run: ``rows(n, seq)`` hands out fresh rows,
    every row drawn anew, so no two rows of a run repeat."""

    def __init__(self, seed: int, vocab: int):
        self.generator = torch.Generator().manual_seed(mix64(seed, 0x544F4B))
        self.table, self.weights = markov(self.generator, vocab)

    def rows(self, n: int, seq: int) -> torch.Tensor:
        return markov_rows(self.generator, self.table, self.weights, n, seq)


def ladder(spec: dict) -> list[int]:
    """The ladder a mix's ``ladder`` entry gives: ``rungs`` quantiles of a
    log-uniform distribution of median ``median`` up to ``hi``, so on
    [median^2 / hi, hi] (a log-uniform's median is sqrt(lo hi)), in
    multiples of ``multiple``."""
    hi = spec["hi"]
    return length_ladder(spec["median"] ** 2 / hi, hi, spec["rungs"],
                         spec["multiple"])


def length_ladder(lo: float, hi: int, rungs: int, multiple: int) -> list[int]:
    """``rungs`` quantiles of a log-uniform distribution on [lo, hi], at
    the midpoints (k + 1/2) / rungs, rounded to multiples of ``multiple``."""
    out = []
    for k in range(rungs):
        q = (k + 0.5) / rungs
        x = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        out.append(max(multiple, int(round(x / multiple)) * multiple))
    return out


def permutation(seed: int, n: int, cycle: int) -> list[int]:
    """Cycle ``cycle``'s order of ``n`` rungs (ascending lengths) under
    ``seed``: the rungs in van der Corput order (rung k placed by the
    reversed bits of k), so that every stretch of a cycle holds short and
    long prompts alike and a window that ends inside a cycle sends the
    same mix whatever the seed; the seed rotates that order and may
    reverse it, anew each cycle."""
    bits = max(1, (n - 1).bit_length())
    base = sorted(range(n), key=lambda k: int(f"{k:0{bits}b}"[::-1], 2))
    g = torch.Generator().manual_seed(mix64(seed, 0x4C414444, cycle))
    shift, flip = torch.randint(0, 2 * n, (1,), generator=g).item() \
        .__divmod__(2)
    order = base[shift % n:] + base[:shift % n]
    return order[::-1] if flip else order
