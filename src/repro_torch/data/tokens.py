"""Synthetic LM token pipeline, port of ``repro.data.tokens``.

Sequences with learnable structure, so that training shows a falling
loss: a first-order Markov chain over the vocabulary whose transition rows
are sparse (``successors`` = 8 successors a token, Zipf weights ``1/r``
normalised), with a 2 % uniform resample a step (the noise floor). The
distribution is the JAX package's; its bits are not (the draws come from
an explicit CPU ``torch.Generator``, not a key chain).

The chain is sequential in the sequence axis, so a batch is generated on
the host: every draw of the batch at once, then a walk of ``seq - 1``
numpy gathers over the ``batch`` rows (a few ms at B 4 x S 1,024), and one
copy to the device, from pinned memory and not blocking the host on CUDA,
so that a loop can make the next batch while the card runs a step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

#: share of the steps of a sequence that resample a token uniformly
RESAMPLE = 0.02


def make_markov(generator: torch.Generator, vocab: int,
                successors: int = 8):
    """(vocab, successors) int64 successor table and (successors,) f32 Zipf
    weights, on the generator's device (the CPU)."""
    table = torch.randint(0, vocab, (vocab, successors), generator=generator)
    w = 1.0 / torch.arange(1, successors + 1, dtype=torch.float32)
    return table, w / w.sum()


def sample_batch(generator: torch.Generator, table: torch.Tensor,
                 weights: torch.Tensor, batch: int, seq: int) -> torch.Tensor:
    """(batch, seq) int32 token batch from the Markov chain, on the CPU:
    a uniform first token, then each next token the successor of the one
    before it chosen by ``weights``, or with probability ``RESAMPLE`` a
    uniform token."""
    vocab, k = table.shape
    first = torch.randint(0, vocab, (batch,), generator=generator)
    steps = max(seq - 1, 0)
    choice = torch.multinomial(weights, batch * steps, replacement=True,
                               generator=generator).reshape(batch, steps)
    fresh = torch.randint(0, vocab, (batch, steps), generator=generator)
    resample = torch.rand((batch, steps), generator=generator) < RESAMPLE
    table_np, choice_np = table.numpy(), choice.numpy()
    fresh_np, resample_np = fresh.numpy(), resample.numpy()
    out = np.empty((batch, seq), np.int32)
    tok = first.numpy()
    out[:, 0] = tok
    for t in range(steps):
        tok = np.where(resample_np[:, t], fresh_np[:, t],
                       table_np[tok, choice_np[:, t]])
        out[:, t + 1] = tok
    return torch.from_numpy(out)


def batches(generator: torch.Generator, vocab: int, batch: int, seq: int,
            steps: int, *, device: torch.device | str | None = None):
    """Generator of ``steps`` ``{'tokens', 'labels'}`` batches (labels are
    the tokens; the step shifts them) on ``device`` (CUDA unless asked
    otherwise). The successor table is drawn first from ``generator``, a
    CPU generator."""
    device = resolve_device(device)
    table, weights = make_markov(generator, vocab)
    for _ in range(steps):
        toks = sample_batch(generator, table, weights, batch, seq)
        if device.type == "cuda":
            toks = toks.pin_memory().to(device, non_blocking=True)
        yield {"tokens": toks, "labels": toks}
