#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels``;
2. prints the card's name and power limit (``nvidia-smi``);
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones (``drive_cascade``, the staged
   step's drive and whole cascade in one launch, bit for bit at side 30 and
   7);
4. checks that the adapt and cascade stages of a full-width step on the card
   agree with the same stages on the CPU (same inputs, same draws): the
   cascade through the ``wave_fn`` seam (a ``cascade_wave`` launch a wave)
   and through the kernel backend's stage (one ``drive_cascade`` launch);
5. holds the fused training-step kernel against its plain version on the
   card (main-path and ragged shapes; GMUs given, exact and bf16 search; a
   wave budget cut by ``max_waves``; a cascade that outlives the kernel's
   wave block and finishes in the tail loop), its exact search against
   ``bmu``'s bitwise, and a fused step against a staged step from one state
   on one replayed draw list (GMUs and q2 bitwise), then 8 steps of both
   from one ``GeneratorDraws`` seed, each from the staged state (GMUs, q2,
   sizes, waves and counters bitwise, the same numbers consumed);
6. trains a 30x30 map on 784-d MNIST-shaped data through
   ``TopoMap(backend="kernel")`` and queries it with the 10,000 test
   samples, counting the kernel launches of that run (one ``drive_cascade``
   a step, ``cascade_wave`` only for waves past the 16-wave block); then
   trains it again through ``backend_options={"kernel": "fused"}``;
7. times each kernel beside its bound, its plain version and a library call,
   queued ahead of the card (the card's time), with the back-to-back time
   (the host's rate where the wrapper is slower) printed beside it, and
   prints each kernel's plan (grid, splits); the main path's queries run
   through the serving engine, ``bmu`` on chunks of at most 4,096;
7b. serves the staged map (``serving_path``): ``TopoMap.save`` / ``load``
   bitwise on the card; ``MapService`` on the 10,000 test samples and on
   one-sample and ragged requests of 2..8 under the tie-bound contract,
   one signature per bucket; a ``MapGateway`` under 8 threads x 250
   batch-1 requests and a 2-replica ``MapFleet`` from a ``MapStore``
   rolled to v2 mid-run, every answer held to the plain version
   (requests/s, mean dispatch, p50/p95/p99; no failure); ``update`` on
   the ``kernel`` backend bitwise ``partial_fit`` with no new signature;
   ``serve_map`` in-process; then ``BmuEngine.bmu`` at buckets 8 and
   4,096, a batch-1 request through the engine beside the bare wrapper
   and ``cdist().min``, and a 10,000-sample query as one launch beside the
   engine's 4,096 + 4,096 + 1,808;
8. holds the sliding-window decode kernel (``kernels/swa``) against its plain
   version on the card, f32 and bf16, at llama3.2-1b's long_500k and serve
   decode shapes and at ragged ones;
9. runs the LM decode path at ``configs.get_smoke("llama3.2-1b")`` width on
   the card and on the CPU from the same weights (a linear cache, and a
   window-16 ring the prompt has wrapped): greedy tokens equal except at
   near ties, teacher-forced logits within the tolerance;
10. serves llama3.2-1b at full width, bf16, through ``launch/serve.py``'s
    ``run``: B 4, a 128-token prompt, 64 new tokens on a 192-slot linear
    cache; then the long_500k path, B 1, an 8,704-token prompt (chunked
    prefill) and 64 new tokens on the 8,192-slot ring, counting the kernel's
    launches in each run and checking it on the layer-0 cache of the long
    prefill;
11. trains the same map through ``TopoMap(backend="async")``, one sample
    an event, on the mnist stand-in (seed 0): A. zero latency, exact search,
    ``kernel="fused"``, 8,000 events (one ``fused_step`` launch an event);
    B. the same with ``kernel="staged"`` (one ``bmu`` at B = 1 and one
    ``drive_cascade`` an event); each with the report's identities, QE
    falling and accuracy >= 0.9; A2. the fused path with the relay race's
    GMU given, 200 events; C. the discrete-event engine against A's runner,
    200 events from one ``GeneratorDraws`` seed (integers bitwise, per event
    with the state re-injected); D. constant latency (delay 1.0), the relay
    race, 1,000 events (message conservation, QE, rounds/s, launches and
    host syncs a round); E. a small constant-latency run on the card
    against the CPU; then ``drive_cascade`` after a one-sample merge, and
    the B = 1 rows of the kernel table (``bmu``, ``fused_step`` searching
    and given its GMU, ``drive_cascade``);
11F. faults (``async_faults``): the same map through
    ``backend_options={"faults": ...}``, ``engine='event'``, constant
    latency 1.0, exact search, 2,000 events under no plan, 10 % broadcast
    loss and a quarter of the units dead for [500, 1500): message
    conservation, fault drops and dead samples counted, QE finite, events/s,
    rounds/s and the QE ratio at 10 % loss beside JAX ``fault_bench``'s
    budget; a whole-run dropout window leaves the dead units' weights
    bitwise; then a small faulty run on the card against the CPU;
11G. the train-and-serve loop (``launch/stream_train.run_stream``): 4,096
    events on the fused fast path while 2 client threads read QE through a
    ``MapGateway``, swapped in memory; then store backed, uninterrupted
    against killed by SIGTERM at half the events and resumed, the final
    artifacts bitwise;
11H. the mesh placement (``mesh_phase``): ``run_events(placement="mesh")``
    at 30x30x784 on 2 gloo ranks on the one card (one process a shard),
    exact search (a ``bmu`` launch on the shard's 450-unit band a sample
    round, counted on every rank): 1,000 zero-latency events, 500 at
    constant latency 1.0, 500 under 10 % loss and ``shard_latency_mult``
    (1, 3) twice (bitwise the same), a profiled window (idle share), a
    small run on the card against the CPU; then 300 events on 3 ranks. Per
    shard ``sent == delivered + overflow + fault + stranded`` and the rows
    summing to the totals, every rank's dense state alike, QE within the
    single pool's band; events/s, rounds/s, collectives and device reads a
    drain iteration, time in the exchange; the ``bmu`` row at the band's
    shape;
11I. the sharded backend (``sharded_phase``): ``TopoMap(backend=
    "sharded")`` at 30x30x784, B = 16, 200 steps on (data 1, model 2) and
    (data 2, model 2) meshes of gloo ranks on the card (QE falls, no NaN,
    counters below theta, 3 steps on the card against the CPU), then a
    1 x 1 mesh without a process group and the same over a 1-rank NCCL
    group, bitwise equal;
11J. the train-and-serve loop on the mesh (``stream_mesh_phase``):
    ``launch/stream_train.run_stream`` with ``placement="mesh", shards=2``
    at 30x30x784 on 2 gloo ranks on the card, exact search, zero latency,
    chunks of 64, a publication every 256, rank 0 serving 2 client
    threads of batch 8: 1,024 events in memory (the phase's main path:
    1,024 ``bmu`` shard searches on each rank, rank 0's reads besides);
    then store backed, uninterrupted against killed by SIGTERM at 512 and
    resumed; then exponential latency (delay 0.5), 256 events killed at
    128 and resumed: the final artifacts bitwise, every rank's dense
    state alike, rank 0's QE finite and below the initial QE, its
    readers at least one read and no error;
11K. the SOM baseline and the port's examples and lint, after the LM
    phases (``som_phase``, ``examples_phase``, ``lint_phase``): a 30x30x784
    SOM (``repro_torch.core.som``) on the mnist stand-in, seed 0, 8,000
    samples (its ``i_max``): 500 steps at B = 16 and 8,000 at B = 1, each
    ``som.train`` run under ``set_sync_debug_mode("error")`` (no host
    sync) and launching ``bmu`` exactly once a step; 50 steps of each held
    to the plain step on the
    card (BMUs within the tie bound, weights bitwise on the same BMUs); the
    QE of the test samples falling by more than 30 %; samples/s, a profiled
    window's launches and syncs a step, and the accuracy beside the AFM
    main path's; then ``examples/quickstart_torch.py`` and
    ``classify_datasets_torch.py`` at their default sizes on the card,
    their tables printed; then ``python -m repro_torch.launch.lint
    --no-ruff``, which must exit 0;
11L. LM training with the AFM probe (``training_phase``), last: three
    smoke-width train steps (f32) with a side-6 probe on the card against
    the CPU, each from the CPU's state, on one batch and one list of draw
    numbers (loss, ce, lr, grad_norm within 1e-5; the probe's GMUs within
    the tie bound, its counters and cascade bitwise where they agree); the
    probe's kernels at its full-width shape (``bmu`` at B 4, N 64, D 2,048
    under the tie-bound contract; ``drive_cascade`` at side 8, D 2,048
    bitwise from a p = 0.9 drive; the probe's kernel stages against the
    plain stages); llama3.2-1b at full width, bf16, through
    ``launch/train.py``'s ``run``: B 4 x S 1,024, 30 steps with an 8x8
    probe (losses finite and falling, one ``bmu`` call and one
    ``drive_cascade`` launch a step; ms a step, tokens/s, peak memory,
    model FLOPs and their share of the bf16 peak; profiled steps'
    launches, host syncs and device busy; the probe update's device time
    and host syncs); 10 steps of ``configs.get_optimized``; then
    ``examples/lm_train_e2e_torch.py`` and ``activation_atlas_torch.py``
    at their default sizes; the two probe rows of the kernel table;
11M. the MoE family (``moe_phase``), last: (a) both MoE configs at smoke
    width (f32) on the card against the CPU for each ``moe_impl``
    (``dense``, ``ragged``, single-process ``ep``): forward logits and
    aux, prefill and 16 greedy decode steps, one train step's loss, ce,
    moe_aux and grad_norm; (b) one granite-moe-1b-a400m MoE layer at full
    width, bf16, 4,096 tokens: the ragged path against the dense path, the
    grouped product against its per-expert loop, ``moe`` with ``ep`` on 2
    gloo ranks on the card (16 experts a rank) against the dense path and,
    at a capacity that drops half the assignments, against
    ``moe_ep_path`` on one process; the probe's kernels at D 1,024; (c)
    granite-moe-1b-a400m and (d) deepseek-moe-16b served at full width,
    bf16, through ``launch/serve.py``'s ``run`` (B 4, a 128-token prompt,
    64 and 32 new tokens; ``dense`` and ``ragged``; prefill ms, decode
    ms/step, tok/s, peak memory, one ``swa_decode`` launch a layer a
    step), the kernel held to its plain version and timed at each decode
    shape; (e) granite trained at full width with an 8x8 probe through
    ``launch/train.py``'s ``run`` (B 4 x S 1,024, lr 3e-4): 20 steps of
    the faithful config (the loss falling), 10 of ``ragged`` (each loss
    within 1 % of the faithful run's while their learning rates agree),
    5 of ``get_optimized``; one ``bmu`` and one ``drive_cascade`` a step;
    on the naive attention path two flash forward launches a layer a step
    (the forward and its recompute) and one backward, none on the
    chunked path; ms a step, tokens/s, peak memory, model FLOPs on the
    active parameters beside the bf16 peak; the kernel rows at the new
    shapes; (f) the flash-attention kernels (``flash_rows``) at the
    benchmark cells' shapes, granite's training (B 32 x S 1,024, GQA
    16/8, hd 64: forward, and forward with backward) and deepseek's
    prefill (B 1, 16 heads, hd 128, at 1,500 and 3,968 tokens): each
    against its plain version, then timed in turns with it and with
    ``scaled_dot_product_attention`` (the yardstick, which the port never
    calls) beside the bound; (g) DeepSeek-V2-Lite whole prefilling 17,408
    tokens (its 192/128 forward's launches counted, one a layer, layer
    0's call held to the plain version, the latent cache's bytes), then
    the forward (``mla_flash_rows``) at 17,408 and 60,416 tokens as in (f);
11N. the recurrent families (``recurrent_phase``), last: (a)
    mamba2-1.3b and recurrentgemma-2b at smoke width (f32) on the card
    against the CPU: forward logits, prefill and 16 greedy decode steps
    (recurrentgemma also an 80-token prompt on its 64-slot ring, past its
    window), one train step's loss, ce and grad_norm; (b) ``swa_decode``
    at hd 256 with MQA (rep 10: B 4 x W 192 and B 1 x W 2,048 on a
    wrapped ring), a ragged rep 12 and rep 16, against its plain version,
    f32 and bf16; (c, d) both served at full width, bf16, through
    ``launch/serve.py``'s ``run``: B 4 x 128 + 64, then B 1 x 8,704 + 64
    (mamba2: 34 chunks of 256; recurrentgemma: its 2,048-slot long_500k
    ring, the prefill's attention chunked), the decode cache's bytes,
    exactly one ``swa_decode`` launch an attention layer a step (8 for
    recurrentgemma, none for mamba2), the kernel held to its plain version
    on recurrentgemma's layer-0 cache after the long prefill; (e) both
    trained at full width with an 8x8 probe through ``launch/train.py``'s
    ``run`` (B 4 x S 1,024, lr 3e-4, 20 steps): losses and grad norms
    finite (mamba2's at its chunk of 256, where the reference's SSD
    gradient is NaN), the loss falling, one ``bmu`` and one
    ``drive_cascade`` a step; ms a step, tokens/s, peak memory, model
    FLOPs beside the bf16 peak; (f) the swa rows at recurrentgemma's two
    decode shapes and the probe's rows at D 2,048 and 2,560;
11O. the audio family (``audio_phase``), last: (a) whisper-medium at
    smoke width (f32) on the card against the CPU with seeded frames:
    forward logits, prefill and 16 greedy decode steps on a linear cache
    and on a wrapped 16-slot ring (two ``swa_decode`` launches a decoder
    layer a step: self- and cross-attention), one train step's loss, ce
    and grad_norm; (b) ``swa_decode`` at whisper's decode shapes (B 4,
    MHA 16/16, hd 64: the self-attention over W 192, the cross-attention
    over the 1,500 frames in 5 splits of 300 slots) against its plain
    version, f32 and bf16, two calls bitwise; (c) served at full width
    (~821 M parameters, bf16) through ``launch/serve.py``'s ``run`` with
    zero frames, B 4 x 128 + 64: prefill (the encoder over 1,500 frames,
    then the prompt), decode ms/step, tok/s, peak memory, the cross K/V
    cache's bytes, 48 ``swa_decode`` launches a step, the kernel held to
    its plain version on a layer's cross K/V; (d) trained at full width
    with an 8x8 probe on the decoder's pooled hidden states through
    ``launch/train.py``'s ``run`` (B 4 x S 1,024, lr 3e-4, 20 steps):
    losses and grad norms finite, the loss falling, one ``bmu`` and one
    ``drive_cascade`` a step; ms a step, tokens/s, peak memory, model
    FLOPs (the encoder's frames and the cross K/V products counted)
    beside the bf16 peak; (e) the swa rows at both shapes (SDPA with no
    mask beside the cross-attention's) and the probe's rows at D 1,024;
11P. the VLM family (``vlm_phase``), last: (a) qwen2-vl-72b at smoke
    width (f32) on the card against the CPU: forward logits with seeded
    patch embeddings over a 4 x 4 grid of M-RoPE positions, prefill and 16
    greedy decode steps with the patches, text-only, and with the patches
    on a 16-slot ring the prompt has wrapped, one train step's loss, ce
    and grad_norm; (b) ``swa_decode`` at its decode shapes (GQA 64/8 at
    hd 128, rep 8: B 4 x W 192, one split; B 1 x W 8,192, 32 splits)
    against its plain version, f32 and bf16, two calls bitwise; (c) served
    at full width cut to 24 of its 80 layers (23.56 B parameters, 47.1 GB
    in bf16) through ``launch/serve.py``'s ``run``
    (``serve_step.generate(extra_batch=)``): B 4 x 128 + 64 with 64 seeded
    patches as an 8 x 8 grid, then long_500k, B 1 x 8,704 + 64 on the
    8,192-slot ring with 1,024 patches as a 32 x 32 grid; prefill ms,
    decode ms/step, tok/s, 24 ``swa_decode`` launches a step, the decode
    cache's bytes, peak memory, the kernel held to its plain version on
    the layer-0 cache after the long prefill; (d) trained at 2 of its 80
    layers with an 8x8 probe through ``launch/train.py``'s ``run`` (B 4 x
    S 1,024, the launcher's zero patches and text positions, lr 1e-4, 20
    steps): losses and grad norms finite, the loss falling, one ``bmu``
    and one ``drive_cascade`` a step; ms a step, tokens/s, peak memory,
    model FLOPs beside the bf16 peak; (e) the swa rows at both shapes and
    the probe's rows at D 8,192;
11Q. the dry run (``dryrun_phase``), last: (a) ``python -m
    repro_torch.launch.dryrun`` for llama3.2-1b ``train_4k`` and
    ``decode_32k`` on the 16 x 16 mesh and qwen2-vl-72b ``decode_32k`` on
    2 x 16 x 16, each in a subprocess on the CPU (no card visible), all at
    once: JAX's keys, ``ok``, no replicated op for the dense arch, the
    roofline line printed; (b) llama3.2-1b without the probe at B 4 x S
    1,024: the dry run's 1 x 1 tallies against one real train step on the
    card (FLOPs under ``FlopCounterMode`` within 0.1 %, argument bytes
    exactly, the peak above the arguments within a band of the predicted
    temp bytes); (c) its B 4 x 192 decode's argument bytes exactly;
12. prints ``{"kernels": [...]}``, the nvidia-smi line, and last
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is non-zero and the last line is
missing. Without a CUDA card it exits with code 1 before doing anything.
"""
import copy
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 500                 # training steps of the main path (B = 16 each)
SEED = 0

#: published peaks (NVIDIA data sheets, at the full power limit):
#: non-tensor f32 FLOP/s and memory bytes/s; the kernels use no tensor cores
PEAKS = {
    "SXM": (67e12, 3.35e12),
    "PCIe": (51e12, 2.0e12),
}


def peaks_for(name: str):
    return PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]


class HostDraws:
    """Draws made on the CPU by a seeded generator and moved to ``device``,
    so a CPU run and a CUDA run can consume the very same numbers."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed, self.spawned = seed, 0
        self.gen = torch.Generator().manual_seed(seed)

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape), generator=self.gen
                             ).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def exponential(self, shape):
        return -torch.log1p(-self.uniform(shape))

    def spawn(self):
        """A child source (one cascade of the event engine), seeded from
        this one's seed and its count of children."""
        self.spawned += 1
        return HostDraws(self.seed * 7919 + self.spawned, self.device)

    def fold_in(self, data):
        """A mesh shard's source, seeded from this one's seed and
        ``data``."""
        return HostDraws(self.seed * 1_000_003 + 104_729 * (data + 1),
                         self.device)


#: cycles of the sleep kernel that holds the card while the host queues a
#: timed loop (~50 ms at the H100's 1.98 GHz boost clock)
QUEUE_AHEAD_CYCLES = 100_000_000


def time_ms(fn, iters: int, queue_ahead: bool = False) -> float:
    """Mean device time of one call, from CUDA events around ``iters``.

    Without ``queue_ahead`` a call whose host work outlasts its device work
    is timed at the host's rate. With it, a sleep kernel holds the card
    while the host queues all ``iters`` calls behind it, so the events
    time the card's work alone (as long as the queue stays shorter than the
    sleep and the driver's launch queue)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict, iters: int, rounds: int = 3,
                  queue_ahead: bool = False) -> dict:
    """Median per-call time of each function, measured in alternating turns
    (a, b, ..., then reversed) on one card."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(time_ms(fns[k], iters, queue_ahead))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def time_both(fns: dict, iters: int, what: str) -> dict:
    """``time_in_turns`` queued ahead of the card (returned) and back to
    back (printed beside it)."""
    queued = time_in_turns(fns, iters, queue_ahead=True)
    b2b = time_in_turns(fns, iters)
    print(f"{what}: " + ", ".join(
        f"{k} {queued[k]:.5f} ms queued ahead ({b2b[k]:.5f} back to back)"
        for k in fns))
    return queued


def check_bmu(w, s, precision, what, quiet=False):
    """Kernel vs plain version on the same card: q2 within the f32 bound of
    the expanded form, indices equal except within that bound of a tie.
    Returns (max |dq2|, the kernel's indices); ``quiet`` prints nothing."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    idx, q2 = bmu_ops.bmu(w, s, precision=precision)
    plain = bmu_ref.bmu_ref if precision == "exact" else bmu_ref.bmu_bf16_ref
    idx_r, q2_r = plain(w, s)
    torch.cuda.synchronize()
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    n_differ = int(differ.sum())
    if n_differ:
        gap = bmu_ref.top2_gap(w, s)
        if not bool((gap[differ] <= bound[differ]).all()):
            raise AssertionError(f"bmu {precision} {what}: {n_differ} indices "
                                 f"differ away from ties")
    err = (q2 - q2_r).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"bmu {precision} {what}: q2 off by "
                             f"{float(err.max())} > bound")
    if not quiet:
        print(f"bmu {precision:5s} {what}: max|dq2| {float(err.max()):.3g}, "
              f"{n_differ} near-tie index differences")
    return float(err.max()), idx


def check_kernels(device):
    """Phase 3: each kernel against its plain version, main-path and ragged
    shapes; returns the worst error per kernel."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"bmu": 0.0, "cascade_wave": 0.0, "drive_cascade": 0.0}
    for b, n, d in ((16, 900, 784), (10000, 900, 784), (1, 900, 784)):
        w = torch.rand(n, d, generator=gen, device=device)
        s = torch.rand(b, d, generator=gen, device=device)
        for precision in ("exact", "bf16"):
            err, _ = check_bmu(w, s, precision, f"B={b} N={n} D={d}")
            if precision == "exact":
                worst["bmu"] = max(worst["bmu"], err)
            # the split merge has a fixed order: a second call is bitwise
            first = bmu_ops.bmu(w, s, precision=precision)
            again = bmu_ops.bmu(w, s, precision=precision)
            if not all(torch.equal(a, r) for a, r in zip(first, again)):
                raise AssertionError(f"bmu {precision} B={b}: two calls "
                                     f"differ")
    # ragged shape with planted exact ties: the lower index must win
    w = torch.randn(37, 13, generator=gen, device=device)
    pairs = torch.randperm(37, generator=gen, device=device)[:10].view(5, 2)
    lo, hi = pairs.min(1).values, pairs.max(1).values
    w[hi] = w[lo]
    s = w[hi] + 1e-3 * torch.randn(5, 13, generator=gen, device=device)
    for precision in ("exact", "bf16"):
        err, idx = check_bmu(w, s, precision, "B=5 N=37 D=13 ties")
        if not torch.equal(idx.long(), lo):
            raise AssertionError(f"bmu {precision}: a tie went to the higher "
                                 f"index: {idx.tolist()} vs {lo.tolist()}")
        if precision == "exact":
            worst["bmu"] = max(worst["bmu"], err)
    for side in (30, 7):
        c = torch.randint(0, 6, (side, side), generator=gen, device=device,
                          dtype=torch.int32)
        fired = torch.rand(side, side, generator=gen, device=device) < 0.25
        bern = torch.rand(4, side, side, generator=gen, device=device) < 0.8
        out = cas_ops.cascade_wave(c, fired, bern, 4)
        ref = cas_ref.cascade_wave_ref(c, fired, bern, 4)
        for a, r in zip(out, ref):
            if not torch.equal(a, r):
                raise AssertionError(f"cascade_wave side {side}: not bitwise")
        print(f"cascade_wave side {side}: bitwise equal to the plain version")
    for side, d in ((30, 784), (7, 13)):
        args = drive_inputs(torch.Generator().manual_seed(side + d), side, d,
                            16, device)
        for budget in (16, 3, 0):
            kw = dict(l_c=0.3, theta=4, budget=budget)
            out = cas_ops.drive_cascade(*args, **kw)
            ref = cas_ref.drive_cascade_ref(*args, **kw)
            again = cas_ops.drive_cascade(*args, **kw)
            torch.cuda.synchronize()
            for a, r, b in zip(out, ref, again):
                same = (torch.equal(a.view(torch.int32), r.view(torch.int32))
                        if a.is_floating_point() else torch.equal(a, r))
                if not (same and torch.equal(a, b)):
                    raise AssertionError(f"drive_cascade side {side} D={d} "
                                         f"budget {budget}: not bitwise")
            size, waves = out[3].tolist()
            if budget and not waves:
                raise AssertionError(f"drive_cascade side {side}: no wave")
            print(f"drive_cascade side {side} D={d} budget {budget}: "
                  f"{size} firings in {waves} waves, "
                  f"{int(out[2].sum())} still firing; bitwise equal to the "
                  f"plain version, and two calls bitwise equal")
    return worst


def drive_inputs(gen, side, d, w_cap, device, theta=4, p=0.9):
    """Random ``drive_cascade`` inputs with counters just below ``theta``:
    merged weights, counters, adaptation counts, drive and wave draws,
    drawn on the CPU (``gen``) and moved to ``device``."""
    n = side * side
    out = (torch.rand(n, d, generator=gen),
           torch.randint(max(theta - 2, 0), theta, (side, side), generator=gen,
                         dtype=torch.int32),
           torch.randint(0, 3, (side, side), generator=gen, dtype=torch.int32),
           torch.rand(8, side, side, generator=gen) < p,
           torch.rand(w_cap, 4, side, side, generator=gen) < p)
    return tuple(x.to(device) for x in out)


def check_step_stages(device, xtr):
    """Phase 4: the adapt and cascade stages of a full-width step on the card
    against the same stages on the CPU (plain versions), from one state, one
    set of GMUs and the same draws, for each cascade stage: the ``wave_fn``
    seam (``cascade_wave`` a wave) and the kernel backend's
    (``drive_cascade_stage``: the drive and up to 16 waves in one
    ``drive_cascade`` launch). The search stage is phase 3's. Counters,
    fired sizes and waves bitwise; weights within 8 f32 ULP per
    adaptation."""
    from repro_torch.core import afm, schedules
    from repro_torch.kernels.cascade import ops as cas_ops
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    state = afm.init(HostDraws(SEED, "cpu"), cfg, xtr[:4096].cpu())
    gen = torch.Generator().manual_seed(SEED)
    c = torch.randint(cfg.theta - 2, cfg.theta, (cfg.n_units,), generator=gen,
                      dtype=torch.int32)
    samples = xtr[:cfg.batch].cpu()
    gmu, _ = afm.search_exact(state, samples, None, cfg)[:2]
    l_c = float(schedules.cascade_learning_rate(0, cfg.total_samples, cfg.c_o,
                                                cfg.c_s))
    p = float(schedules.cascade_probability(0, cfg.total_samples, cfg.n_units,
                                            cfg.c_m, cfg.c_d))
    stages = {
        "wave_fn seam": lambda dev, *a: afm.cascade_default(
            *a, wave_fn=None if dev == "cpu" else cas_ops.cascade_wave),
        "drive_cascade stage": lambda dev, *a: cas_ops.drive_cascade_stage(
            *a)}
    for name, stage in stages.items():
        out = {}
        for dev in ("cpu", device):
            w, counts = afm.adapt_merge(state.w.to(dev), samples.to(dev),
                                        gmu.to(dev), cfg)
            before = cas_ops.drive_launches
            out[dev] = stage(dev, w, c.to(dev), counts, l_c, p,
                             HostDraws(SEED + 1, dev), cfg)
            launched = cas_ops.drive_launches - before
            if launched != (dev != "cpu" and name != "wave_fn seam"):
                raise AssertionError(f"stage parity, {name} on {dev}: "
                                     f"drive_cascade launched {launched}")
        cpu, gpu = out["cpu"], out[device]
        size, waves = int(cpu.size), int(cpu.waves)
        if (size, waves) != (int(gpu.size), int(gpu.waves)) or waves == 0:
            raise AssertionError(f"stage parity, {name}: size/waves "
                                 f"{size, waves} on the CPU, "
                                 f"{int(gpu.size), int(gpu.waves)} on the card")
        if not torch.equal(cpu.c, gpu.c.cpu()):
            raise AssertionError(f"stage parity, {name}: counters differ")
        dw = float((cpu.w - gpu.w.cpu()).abs().max())
        bound = (8 * (1 + waves) * torch.finfo(torch.float32).eps
                 * float(cpu.w.abs().max()))
        if dw > bound:
            raise AssertionError(f"stage parity, {name}: |dw| {dw} > {bound}")
        print(f"stage parity, {name} (adapt + cascade of {size} firings in "
              f"{waves} waves): integers bitwise, max|dw| {dw:.3g} <= "
              f"{bound:.3g}")


def _search_tier_ok(idx, q2, idx_r, q2_r, w, s, precision, what):
    """A fused search result against its plain version: indices equal
    except within ``tie_bound`` of a tie (for the bf16 tier a tie of the
    bf16-rounded distances, which that tier ranks by); q2 within
    ``tie_bound`` where the indices agree. Returns (max |dq2|, whether
    every index agrees)."""
    from repro_torch.kernels.bmu import ref as bmu_ref
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    if bool(differ.any()):
        rw, rs = (w, s) if precision == "exact" else (
            w.bfloat16().float(), s.bfloat16().float())
        gap = bmu_ref.top2_gap(rw, rs)
        if not bool((gap[differ] <= bound[differ]).all()):
            raise AssertionError(f"fused {what}: GMUs differ away from ties")
    err = (q2 - q2_r).abs()[~differ]
    if not bool((err <= bound[~differ]).all()):
        raise AssertionError(f"fused {what}: q2 off by {float(err.max())}")
    return (float(err.max()) if err.numel() else 0.0), not bool(differ.any())


def _fused_same(out, ref, what):
    """Integers bitwise; w within 8 (1 + waves) f32 ULP of max|w|, the bound
    of the stage-parity phase. Returns max |dw| and the wave count."""
    names = ("c", "fired", "stats", "recv")
    for name, a, r in zip(names, out[1:5], ref[1:5]):
        if not torch.equal(a, r):
            raise AssertionError(f"fused {what}: {name} not bitwise equal")
    waves = int(ref[3][1])
    if not bool(torch.isfinite(out[0]).all() & torch.isfinite(ref[0]).all()):
        raise AssertionError(f"fused {what}: non-finite weights")
    dw = float((out[0] - ref[0]).abs().max())
    bound = (8 * (1 + waves) * torch.finfo(torch.float32).eps
             * float(ref[0].abs().max()))
    if dw > bound:
        raise AssertionError(f"fused {what}: |dw| {dw} > {bound}")
    return dw, waves


def fused_inputs(gen, side, d, b, w_cap, device, theta=4, p=0.9):
    """Random fused-step inputs with counters just below ``theta``, so the
    drive sets off cascades; drawn on the CPU (``gen``) and moved to
    ``device``, so a CPU rehearsal sees the same numbers."""
    n = side * side
    out = (torch.rand(n, d, generator=gen),
           torch.randint(max(theta - 2, 0), theta, (side, side), generator=gen,
                         dtype=torch.int32),
           torch.rand(b, d, generator=gen),
           torch.rand(8, side, side, generator=gen) < p,
           torch.rand(w_cap, 4, side, side, generator=gen) < p,
           torch.randint(0, n, (b,), generator=gen, dtype=torch.int32))
    return tuple(x.to(device) for x in out)


def check_fused_kernel(device):
    """Phase 5a: the fused kernel against its plain version, both on the
    card, same inputs: GMUs given, exact and bf16 search, at the main
    path's shape and ragged ones (D % 4 != 0, B past two search tiles),
    with the budget cut below the wave block (``max_waves < wave_cap``) and
    with the front still alive after it. Integers bitwise, GMUs and q2
    within the tie bound, w within the stage bound; the exact search's GMUs
    and q2 bitwise equal to ``bmu``'s. Where a search picks another unit
    inside the tie bound, the plain version is run again with the kernel's
    GMUs."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.fused import ref as fused_ref
    gen = torch.Generator().manual_seed(SEED + 5)
    worst = {"dw": 0.0, "dq2": 0.0}
    cases = []
    for side, d, b in ((30, 784, 16), (7, 13, 5), (30, 783, 40),
                       (30, 784, 1)):
        for precision in ("given", "exact", "bf16"):
            cases.append((side, d, b, precision, 16, 16, 4))
    cases += [(30, 784, 16, "exact", 16, 5, 2),    # max_waves 5 < wave_cap
              (7, 13, 5, "given", 3, 3, 2)]        # front outlives 3 waves
    for side, d, b, precision, w_cap, budget, theta in cases:
        w, c, s, drive, bern, gmu = fused_inputs(gen, side, d, b, w_cap,
                                                 device, theta=theta)
        given = gmu if precision == "given" else None
        tier = "exact" if precision == "given" else precision
        what = (f"side {side} D={d} B={b} {precision} cap {w_cap} budget "
                f"{budget}")
        kw = dict(theta=theta, budget=budget, precision=tier)
        out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, given,
                                   **kw)
        ref = fused_ref.fused_step_ref(w, c, s, 0.05, 0.3, drive, bern, given,
                                       **kw)
        torch.cuda.synchronize()
        note = ""
        if given is None:
            dq2, agree = _search_tier_ok(out[5], out[6], ref[5], ref[6], w, s,
                                         tier, what)
            worst["dq2"] = max(worst["dq2"], dq2)
            if not agree:
                ref = fused_ref.fused_step_ref(w, c, s, 0.05, 0.3, drive,
                                               bern, out[5], **kw)
                note = " (a near-tie GMU differed; plain rerun on its GMUs)"
        if tier == "exact" and given is None:
            # the fused search shares bmu's rows_kernel arithmetic
            idx, q2 = bmu_ops.bmu(w, s)
            if not (torch.equal(idx, out[5]) and torch.equal(q2, out[6])):
                raise AssertionError(f"fused {what}: the search differs from "
                                     f"bmu's")
            note += "; GMUs and q2 bitwise equal to bmu's"
        dw, waves = _fused_same(out, ref, what)
        worst["dw"] = max(worst["dw"], dw)
        alive = int(out[2].sum())
        if budget < w_cap and waves != budget:
            raise AssertionError(f"fused {what}: budget not reached")
        if (side, w_cap) == (7, 3) and not alive:
            raise AssertionError(f"fused {what}: the front did not outlive "
                                 f"the block")
        print(f"fused {what}: {int(out[3][0])} firings in {waves} waves, "
              f"{alive} still firing; integers bitwise, max|dw| {dw:.3g}"
              f"{note}")
    return worst


def check_fused_parts(device, xtr):
    """Phase 5b: the step op with its tail, on the card (fused kernel, then
    the cascade kernel per tail wave) against the plain versions on the CPU,
    from one state and the same draws: a cascade that outlives a 4-wave
    block, and one cut by ``max_waves`` 3 < ``wave_cap``. The schedule is
    taken half-way through training (l_c = 0.5)."""
    from repro_torch.core import afm
    from repro_torch.core import search as search_lib
    from repro_torch.kernels.fused import ops as fused_ops
    for max_waves, wave_cap in ((None, 4), (3, 16)):
        cfg = afm.AFMConfig(side=30, dim=784, batch=16, max_waves=max_waves)
        theta = cfg.theta
        state = afm.init(HostDraws(SEED, "cpu"), cfg, xtr[:4096].cpu())
        gen = torch.Generator().manual_seed(SEED + wave_cap)
        c = torch.randint(theta - 2, theta, (cfg.n_units,), generator=gen,
                          dtype=torch.int32)
        samples = xtr[:cfg.batch].cpu()
        l_c, p_i = afm.schedule_values(cfg.total_samples // 2, cfg)
        what = f"step, max_waves {max_waves}, wave_cap {wave_cap}"

        def run(dev, search_result=None):
            return fused_ops.fused_step_parts(
                state.w.to(dev), c.to(dev), samples.to(dev),
                HostDraws(SEED + 2, dev), cfg, l_c=l_c, p_i=p_i,
                wave_cap=wave_cap, search_result=search_result)

        gpu, cpu = run(device), run("cpu")
        _search_tier_ok(gpu.gmu.cpu(), gpu.q2.cpu(), cpu.gmu, cpu.q2,
                        state.w, samples, "exact", what)
        if not torch.equal(cpu.gmu, gpu.gmu.cpu()):
            # a near tie: the CPU run again on the card's GMUs
            zeros = torch.zeros_like(cpu.gmu)
            cpu = run("cpu", search_lib.SearchResult(gpu.gmu.cpu(), cpu.q2,
                                                     zeros, zeros))
        for name in ("c", "size", "waves", "recv"):
            if not torch.equal(getattr(cpu, name),
                               getattr(gpu, name).cpu()):
                raise AssertionError(f"fused {what}: {name} differs")
        waves = int(cpu.waves)
        if not bool(torch.isfinite(cpu.w).all() & torch.isfinite(gpu.w).all()):
            raise AssertionError(f"fused {what}: non-finite weights")
        dw = float((cpu.w - gpu.w.cpu()).abs().max())
        bound = (8 * (1 + waves) * torch.finfo(torch.float32).eps
                 * float(cpu.w.abs().max()))
        if dw > bound:
            raise AssertionError(f"fused {what}: |dw| {dw} > {bound}")
        limit = fused_ops.wave_budget(cfg)
        if max_waves is None and waves <= wave_cap:
            raise AssertionError(f"fused {what}: no tail ({waves} waves)")
        if max_waves is not None and waves != limit:
            raise AssertionError(f"fused {what}: {waves} waves, expected the "
                                 f"cap {limit}")
        print(f"fused {what}: {int(cpu.size)} firings in {waves} waves on "
              f"both; integers bitwise, max|dw| {dw:.3g} <= {bound:.3g}")


def check_fused_vs_staged(device, xtr):
    """Phase 5c: one fused step against one staged step on the card, from
    one state, each replaying the same list: the drive, the first
    ``wave_cap`` waves' draws stacked and the rest one per tail wave (both
    paths' draw order), half-way through the schedule. GMUs, q2 and
    integers bitwise, w within the stage bound; then 8 steps of both from
    one ``GeneratorDraws`` seed (``check_fused_vs_staged_steps``)."""
    import numpy as np
    from repro_torch.api.backends import get_backend
    from repro_torch.core import afm
    from repro_torch.draws import ReplayDraws
    from repro_torch.kernels.fused import ops as fused_ops
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    side, cap = cfg.side, fused_ops.DEFAULT_WAVE_CAP
    state = afm.init(HostDraws(SEED, device), cfg, xtr[:4096])
    rng = np.random.default_rng(SEED)
    c = rng.integers(cfg.theta - 2, cfg.theta, cfg.n_units)
    state = state._replace(c=torch.as_tensor(c, dtype=torch.int32,
                                             device=device),
                           i=cfg.total_samples // 2)
    samples = xtr[16:32].contiguous()
    drive = rng.random((8, side, side), dtype=np.float32)
    waves = list(rng.random((400, 4, side, side), dtype=np.float32))
    staged = get_backend("kernel", cfg, device=device).stages
    fused = get_backend("kernel", cfg, kernel="fused", device=device).stages
    arrays = [drive, np.stack(waves[:cap])] + waves[cap:]
    draws_f = ReplayDraws(arrays, device=device)
    fnew, faux = afm._step(state, samples, draws_f, cfg, fused)
    draws_s = ReplayDraws(arrays, device=device)
    snew, saux = afm._step(state, samples, draws_s, cfg, staged)
    n_waves = int(saux.waves)
    if (n_waves >= len(waves) or len(draws_s) != len(draws_f)
            or len(draws_f) != len(waves) - max(cap, n_waves)):
        raise AssertionError("fused vs staged: the replays were not consumed "
                             "as the draw order says")
    # both searches run repro::rows_split and repro::merge_splits: the GMUs
    # and q2 are the same bits, near ties included
    for name in ("gmu", "q2", "cascade_size", "waves"):
        if not torch.equal(getattr(saux, name).cpu(),
                           getattr(faux, name).cpu()):
            raise AssertionError(f"fused vs staged: {name} differs")
    if not torch.equal(snew.c, fnew.c):
        raise AssertionError("fused vs staged: counters differ")
    if not bool(torch.isfinite(snew.w).all() & torch.isfinite(fnew.w).all()):
        raise AssertionError("fused vs staged: non-finite weights")
    dw = float((snew.w - fnew.w).abs().max())
    bound = (8 * (1 + n_waves) * torch.finfo(torch.float32).eps
             * float(snew.w.abs().max()))
    if dw > bound:
        raise AssertionError(f"fused vs staged: |dw| {dw} > {bound}")
    print(f"fused vs staged step: {int(saux.cascade_size)} firings in "
          f"{n_waves} waves (block {cap}) on both; GMUs, q2 and integers "
          f"bitwise, max|dw| {dw:.3g} <= {bound:.3g}")
    check_fused_vs_staged_steps(device, xtr, staged, fused)


#: steps of the staged-vs-fused trajectory check (phase 5c)
PAIRED_STEPS = 8


def check_fused_vs_staged_steps(device, xtr, staged, fused):
    """Phase 5c, continued: ``PAIRED_STEPS`` steps of the kernel backend's
    staged and fused stages from one ``GeneratorDraws`` seed, each step from
    the staged state and the same generator state (the trajectory contract:
    state re-injected from one side). GMUs, q2, cascade sizes, waves and
    counters bitwise, w within the stage bound, and both generators in the
    same state after each step: the two paths consume the same numbers."""
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    draws = GeneratorDraws(SEED + 21, device)
    state = afm.init(draws, cfg, xtr[:4096])
    state = state._replace(c=torch.full((cfg.n_units,), cfg.theta - 1,
                                        dtype=torch.int32, device=device))
    total, worst = [], 0.0
    for step in range(PAIRED_STEPS):
        samples = xtr[16 * step:16 * step + 16].contiguous()
        other = GeneratorDraws(0, device)
        other.generator.set_state(draws.generator.get_state())
        snew, saux = afm._step(state, samples, draws, cfg, staged)
        fnew, faux = afm._step(state, samples, other, cfg, fused)
        if not torch.equal(draws.generator.get_state(),
                           other.generator.get_state()):
            raise AssertionError(f"fused vs staged, step {step}: the two "
                                 f"paths consumed different draws")
        for name in ("gmu", "q2", "cascade_size", "waves"):
            if not torch.equal(getattr(saux, name), getattr(faux, name)):
                raise AssertionError(f"fused vs staged, step {step}: {name} "
                                     f"differs")
        if not torch.equal(snew.c, fnew.c):
            raise AssertionError(f"fused vs staged, step {step}: counters "
                                 f"differ")
        waves = int(saux.waves)
        dw = float((snew.w - fnew.w).abs().max())
        bound = (8 * (1 + waves) * torch.finfo(torch.float32).eps
                 * float(snew.w.abs().max()))
        if not dw <= bound:
            raise AssertionError(f"fused vs staged, step {step}: |dw| {dw} "
                                 f"> {bound}")
        worst = max(worst, dw)
        total.append((int(saux.cascade_size), waves))
        state = snew
    if not any(w for _, w in total):
        raise AssertionError("fused vs staged: no step cascaded")
    print(f"fused vs staged, {PAIRED_STEPS} steps from one GeneratorDraws "
          f"seed, each from the staged state: (firings, waves) {total}; "
          f"GMUs, q2, sizes, waves and counters bitwise, the same draws "
          f"consumed, max|dw| {worst:.3g}")


def _launch_counts():
    """Each kernel's launches through its wrapper's count, and
    ``bmu@<bucket>``: the serving engine's dispatches by bucket, each one
    ``bmu`` launch (counted in ``bmu`` too)."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.serving import maps
    counts = {"bmu": bmu_ops.launches,
              "cascade_wave": cas_ops.launches,
              "drive_cascade": cas_ops.drive_launches,
              "fused_step": fused_ops.launches,
              "swa_decode": swa_ops.launches,
              "flash_fwd": flash_ops.launches_fwd,
              "flash_bwd": flash_ops.launches_bwd}
    for key, n in sorted(maps.GLOBAL_COMPILE_CACHE.dispatches.items()):
        counts[f"bmu@{key[0]}"] = counts.get(f"bmu@{key[0]}", 0) + n
    return counts


def _reset_launch_counts():
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.serving import maps
    bmu_ops.launches = cas_ops.launches = fused_ops.launches = 0
    cas_ops.drive_launches = swa_ops.launches = 0
    flash_ops.launches_fwd = flash_ops.launches_bwd = 0
    maps.GLOBAL_COMPILE_CACHE.dispatches.clear()


def main_path(device, xtr, ytr, xte, yte, steps, kernel="staged",
              required=("bmu", "drive_cascade", "bmu@4096")):
    """Phase 6: train and query through the entry points a user
    calls, with the ``kernel`` backend's ``kernel`` option. Returns the
    trained map, the launch counts of its training and of the whole run,
    its fit samples/s and its test accuracy. Fails unless every kernel in
    ``required`` was launched in this run (the queries run through the
    serving engine: ``bmu`` on 4,096 + 4,096 + 1,808 samples, bucket
    4,096's chunks), the step kernel (``drive_cascade`` staged,
    ``fused_step`` fused) once a training step, and ``cascade_wave`` once
    a wave past the 16-wave block."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.bmu import ref as bmu_ref
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    opts = {"kernel": kernel}
    init_state = afm.init(GeneratorDraws(SEED, device), cfg, xtr)
    qe0 = TopoMap.from_state(init_state, cfg, backend="kernel",
                             device=device).quantization_error(xte)
    TopoMap(cfg, backend="kernel", backend_options=opts,
            device=device).fit(xtr, num_steps=3)

    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="kernel", backend_options=opts, device=device,
                 seed=SEED)
    tm.fit(xtr, num_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = _launch_counts()
    tm.label(xtr, ytr)
    t0 = time.perf_counter()
    units = tm.transform(xte)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    pred = tm.predict(xte)
    qe = tm.quantization_error(xte)
    torch.cuda.synchronize()
    launches = _launch_counts()

    n = cfg.n_units
    if not (units.shape == (len(xte),) and int(units.min()) >= 0
            and int(units.max()) < n):
        raise AssertionError("transform: units out of range")
    if not bool(torch.isfinite(tm.state_.w).all()):
        raise AssertionError("fit: non-finite weights")
    # the transform's units against f64 distances: each chosen unit must be
    # within the f32 bound of the expanded form of the true nearest one
    d = torch.cdist(xte.double(), tm.state_.w.double()) ** 2
    best = d.min(dim=1)
    chosen = d.gather(1, units.long()[:, None])[:, 0]
    slack = chosen - best.values
    within = bool((slack <= bmu_ref.tie_bound(tm.state_.w, xte)).all())
    agree = float((best.indices == units).float().mean())
    acc = float((pred == yte).float().mean())
    aux = tm.fit_aux_
    print(f"main path, kernel={kernel!r}: {steps} steps x B=16 on "
          f"{tuple(xtr.shape)} train, "
          f"{tuple(xte.shape)} test; waves/step {float(aux.waves.float().mean()):.2f}, "
          f"cascade size/step {float(aux.cascade_size.float().mean()):.2f}")
    print(f"QE initial {qe0:.4f} -> trained {qe:.4f}; accuracy {acc:.4f}; "
          f"transform: nearest unit for {agree:.5f} of samples, the rest "
          f"within {float(slack.max()):.3g} of it")
    print(f"launches: training {train_launches}, whole run {launches}")
    print(f"fit samples/s {steps * cfg.batch / fit_s:.1f} "
          f"({fit_s:.3f} s for {steps} steps, init included)")
    print(f"transform samples/s {len(xte) / transform_s:.1f} "
          f"({transform_s * 1e3:.3f} ms for {len(xte)} samples)")
    if not all(launches[k] for k in required):
        raise AssertionError(f"a kernel of the {kernel} path was not "
                             f"launched: {launches}, needs {required}")
    from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP
    tail = int((aux.waves - DEFAULT_WAVE_CAP).clamp(min=0).sum())
    step_kernel = "drive_cascade" if kernel == "staged" else "fused_step"
    if (train_launches[step_kernel] != steps
            or train_launches["cascade_wave"] != tail):
        raise AssertionError(f"{kernel} training launched {train_launches}: "
                             f"{step_kernel} must run once a step ({steps})"
                             f" and cascade_wave once a tail wave ({tail})")
    print(f"launches per training step: {step_kernel} 1, cascade_wave "
          f"{tail / steps:.4f} ({tail} waves past the {DEFAULT_WAVE_CAP}-wave"
          f" block)")
    if not qe < qe0:
        raise AssertionError(f"QE did not fall: {qe0} -> {qe}")
    if acc < ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {acc} below {ACCURACY_FLOOR}")
    if not within:
        raise AssertionError(f"transform: a unit beyond the tie bound, "
                             f"{float(slack.max())} from the nearest")
    return tm, train_launches, launches, steps * cfg.batch / fit_s, acc


#: chance is 0.1 on the ten classes; the first run on an H100 (500 steps,
#: seed 0) classified all 10,000 test samples right, so 0.9 leaves room for
#: other seeds and cards while a map that failed to organise falls below it
ACCURACY_FLOOR = 0.9


def kernel_table(device, tm, xtr, xte, train_launches, launches, worst):
    """Phase 7: time each kernel at the main path's shapes beside its plain
    version, a library call and its bound."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.device import sm_count
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    name = torch.cuda.get_device_name(0)
    f32_peak, bw = peaks_for(name)
    w = tm.state_.w
    rows = []
    for label, s, iters, n_launch in (
            ("bmu (training search, B=16)", xtr[:16].contiguous(), 200,
             train_launches["bmu"]),
            ("bmu (queries, bucket 4096)", xte[:4096].contiguous(), 40,
             launches.get("bmu@4096", 0))):
        (n, d), b = w.shape, s.shape[0]
        plan = bmu_ops.plan(n, b, d, sm_count(w.device))
        print(f"{label}: plan {plan.kernel}_kernel, grid {plan.grid} "
              f"({plan.blocks} blocks, {plan.splits} splits of the units), "
              f"then the merge")
        t = time_both({
            "plain": lambda: bmu_ref.bmu_ref(w, s),
            "kernel": lambda: bmu_ops.bmu(w, s),
            "library": lambda: torch.cdist(s, w).min(dim=1),
        }, iters, label)
        nbytes = 4 * (n * d + b * d) + 8 * b
        flops = 2 * b * n * d + 2 * (n + b) * d
        bound = max(nbytes / bw, flops / f32_peak) * 1e3
        print(f"{label}: bound {bound:.6f} ms, kernel at "
              f"{100 * bound / t['kernel']:.1f} % of it")
        rows.append({
            "name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/bmu/bmu.cu",
            "replaces": "src/repro/kernels/bmu/bmu.py:26",
            "launches": n_launch, "max_abs_err": worst["bmu"],
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": "bytes" if nbytes / bw > flops / f32_peak
            else "operations",
            "library_ms": t["library"]})
    side = tm.cfg.side
    gen = torch.Generator(device=device).manual_seed(SEED)
    c = torch.randint(0, 6, (side, side), generator=gen, device=device,
                      dtype=torch.int32)
    fired = torch.rand(side, side, generator=gen, device=device) < 0.25
    bern = torch.rand(4, side, side, generator=gen, device=device) < 0.8
    print(f"cascade_wave (side {side}): plan one thread a site, "
          f"{-(-side * side // 256)} block(s) of 256")
    t = time_both({
        "plain": lambda: cas_ref.cascade_wave_ref(c, fired, bern, 4),
        "kernel": lambda: cas_ops.cascade_wave(c, fired, bern, 4),
    }, 500, f"cascade_wave (side {side})")
    sites = side * side
    nbytes = sites * (4 + 1 + 4) + sites * (4 + 1 + 4)
    # ~16 integer operations a site, counted at half the f32 rate (an SM
    # has half as many int32 lanes as f32 lanes)
    ops = 16 * sites
    bound = max(nbytes / bw, ops / (f32_peak / 2)) * 1e3
    rows.append({
        "name": "cascade_wave (side 30)", "route": "cuda",
        "source": "src/repro_torch/kernels/cascade/cascade.cu",
        "replaces": "src/repro/kernels/cascade/cascade.py:38",
        "launches": launches["cascade_wave"],
        "max_abs_err": worst["cascade_wave"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > ops / (f32_peak / 2)
        else "operations",
        "library_ms": None})
    rows.append(drive_cascade_row(device, tm, xtr, launches, worst))
    return rows


def drive_cascade_row(device, tm, xtr, launches, worst, b=16):
    """Phase 7, the staged step's drive and cascade: one call at the main
    path's shape from the staged run's trained state (its counters, the
    schedule there), after the merge of a batch of ``b`` samples into their
    ``bmu`` GMUs, the first of up to 512 // b batches whose call runs at
    least 4 waves. No single PyTorch call computes it: ``library_ms`` is
    null. The bound counts W read and written once, the counters, counts,
    drive, the draws of the waves that ran and the lattices once, and
    6 N D operations a wave."""
    from repro_torch.core import afm
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    cfg, state = tm.cfg, tm.state_
    side, (n, d) = cfg.side, state.w.shape
    cap = cas_ops.DEFAULT_WAVE_CAP
    l_c, p_i = afm.schedule_values(state.i, cfg)
    gen = torch.Generator().manual_seed(SEED + 11)
    c = state.c.reshape(side, side)
    for k in range(512 // b):
        s = xtr[b * k:b * k + b].contiguous()
        gmu, _ = bmu_ops.bmu(state.w, s)
        merged, counts = afm.adapt_merge(state.w, s, gmu, cfg)
        counts = counts.to(torch.int32).reshape(side, side)
        drive = (torch.rand(8, side, side, generator=gen) < p_i).to(device)
        bern = (torch.rand(cap, 4, side, side, generator=gen) < p_i).to(
            device)
        args = (merged, c, counts, drive, bern)
        kw = dict(l_c=l_c, theta=cfg.theta, budget=cap)
        out = cas_ops.drive_cascade(*args, **kw)
        size, waves = out[3].tolist()
        if waves >= 4:
            break
    plan = cas_ops._cascade_plan(device.index or 0, n, d)
    print(f"drive_cascade: plan {plan.blocks} blocks of {plan.threads} "
          f"threads, {plan.ds} features a block, {plan.smem} bytes of shared"
          f" memory each, the draws of {plan.staged_waves} waves staged")
    print(f"drive_cascade timing call: {size} firings in {waves} waves, "
          f"state after {state.i} samples, batch {k}")
    t = time_both({
        "plain": lambda: cas_ref.drive_cascade_ref(*args, **kw),
        "kernel": lambda: cas_ops.drive_cascade(*args, **kw),
    }, 200, "drive_cascade")
    nbytes = 2 * 4 * n * d + n * (4 + 4 + 8 + 4 * waves) + n * (4 + 1 + 4) + 8
    ops = 6 * n * d * waves
    bound = max(nbytes / bw, ops / f32_peak) * 1e3
    print(f"drive_cascade: bound {bound:.6f} ms ({nbytes / 1e6:.3f} MB, "
          f"{ops / 1e6:.2f} M operations), kernel at "
          f"{100 * bound / t['kernel']:.1f} % of it")
    return {
        "name": f"drive_cascade (N=900, D=784, {waves} waves"
                + (")" if b == 16 else f", a {b}-sample merge: async staged)"),
        "route": "cuda",
        "source": "src/repro_torch/kernels/cascade/cascade.cu",
        "replaces": "src/repro/kernels/cascade/cascade.py:38",
        "launches": launches["drive_cascade"],
        "max_abs_err": worst["drive_cascade"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > ops / f32_peak
        else "operations",
        "library_ms": None}


def fused_row(device, tmf, xtr, launches, worst, given=False):
    """Phase 7, the fused step: one call at the main path's shape from the
    fused run's trained state (its counters, the schedule's p_i there), the
    kernel beside its plain version, with the wave count of that call (the
    first of up to 512 // b batches whose call runs at least 4 waves); the
    batch is the run's (16, or 1 for the async backend); ``given`` passes
    the batch's ``bmu`` GMUs in (the relay race's seam) instead of
    searching. No single PyTorch call computes a training step:
    ``library_ms`` is null."""
    from repro_torch.core import afm
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.fused import ref as fused_ref
    name = torch.cuda.get_device_name(0)
    f32_peak, bw = peaks_for(name)
    cfg, state = tmf.cfg, tmf.state_
    side, (n, d), b = cfg.side, state.w.shape, cfg.batch
    cap = fused_ops.DEFAULT_WAVE_CAP
    l_c, p_i = afm.schedule_values(state.i, cfg)
    gen = torch.Generator().manual_seed(SEED + 9)
    drive = (torch.rand(8, side, side, generator=gen) < p_i).to(device)
    bern = (torch.rand(cap, 4, side, side, generator=gen) < p_i).to(device)
    w, c = state.w, state.c.reshape(side, side)
    kw = dict(theta=cfg.theta, budget=cap)
    for k in range(512 // b):         # the first batch whose call runs 4 waves
        s = xtr[b * k:b * k + b].contiguous()
        gmu = bmu_ops.bmu(w, s)[0] if given else None
        args = (w, c, s, cfg.l_s, l_c, drive, bern, gmu)
        out = fused_ops.fused_step(*args, **kw)
        waves = int(out[3][1])
        if waves >= 4:
            break
    fplan = fused_ops._plan(w.device.index or 0, n, d, b)
    print(f"fused_step: plan {fplan.blocks} cooperative blocks of "
          f"{fplan.threads} threads, {fplan.splits} search splits, "
          f"{fplan.ds} features a block ({fplan.feature_blocks} blocks own "
          f"features), {fplan.smem} bytes of shared memory each, the "
          f"draws of {fplan.staged_waves} waves staged, "
          f"{fplan.w_boxes} column(s) of TMA boxes for the W slice")
    t = time_both({
        "plain": lambda: fused_ref.fused_step_ref(*args, **kw),
        "kernel": lambda: fused_ops.fused_step(*args, **kw),
    }, 100, "fused_step")
    nbytes = (2 * 4 * n * d + 4 * b * d
              + n * (4 + 8 + 4 * cap + 4 + 1 + 4) + 8 + 8 * b)
    flops = ((0 if given else 2 * b * n * d) + 2 * n * d + 2 * b * d
             + 3 * b * d + waves * 6 * n * d)
    bound = max(nbytes / bw, flops / f32_peak) * 1e3
    print(f"fused_step timing call: {int(out[3][0])} firings in {waves} "
          f"waves, state after {state.i} samples")
    return {
        "name": f"fused_step (B={b}, N=900, D=784, {waves} waves"
                + (", GMU given)" if given else ")"),
        "route": "cuda", "source": "src/repro_torch/kernels/fused/fused.cu",
        "replaces": "src/repro/kernels/fused/fused.py:75",
        "launches": launches["fused_step"], "max_abs_err": worst["dw"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > flops / f32_peak
        else "operations",
        "library_ms": None}


#: batch-1 requests of the gateway phase: 8 client threads x 250
GATEWAY_CLIENTS, GATEWAY_REQUESTS = 8, 250
#: fleet phase: 8 client threads x 40 requests of 8 samples, 2 replicas
FLEET_CLIENTS, FLEET_REQUESTS, FLEET_BATCH = 8, 40, 8
#: online updates of the update phase, B = 16 each
UPDATE_STEPS = 4


def _bmu_bound(n, b, d, f32_peak, bw):
    """Least time (ms) of an exact search of b samples over n units of d
    features, and what bounds it: w and s read once, idx and q2 written
    once; 2 b n d FLOPs of distances and 2 (n + b) d of norms."""
    nbytes = 4 * (n * d + b * d) + 8 * b
    flops = 2 * b * n * d + 2 * (n + b) * d
    by_bytes, by_ops = nbytes / bw, flops / f32_peak
    return max(by_bytes, by_ops) * 1e3, (
        "bytes" if by_bytes > by_ops else "operations")


def _client_threads(n_threads, fn):
    """Runs ``fn(k)`` on ``n_threads`` threads; re-raises the first error."""
    import threading
    errors = []

    def run(k):
        try:
            fn(k)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def _held_to_ref(w, s, idx, q2, what):
    """Holds a served (idx, q2) to the plain version on the same weights
    under the tie-bound contract: an index may differ only where the
    reference's top-two gap is within the tie bound, q2 (where given) only
    within that bound. Returns (index differences, max |dq2|)."""
    from repro_torch.kernels.bmu import ref as bmu_ref
    idx_r, q2_r = bmu_ref.bmu_ref(w, s)
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    if differ.any() and not bool((bmu_ref.top2_gap(w, s)[differ]
                                  <= bound[differ]).all()):
        raise AssertionError(f"{what}: indices differ away from ties")
    if q2 is None:
        return int(differ.sum()), 0.0
    dq2 = (q2 - q2_r).abs()
    if not bool((dq2 <= bound).all()):
        raise AssertionError(f"{what}: q2 off by {float(dq2.max())} > bound")
    return int(differ.sum()), float(dq2.max())


def _labels_of_ref(w, labels, s):
    """The plain version's predictions of ``s`` on a map (``labels`` of its
    exact BMUs), and the samples within the tie bound of a tie, where a
    served prediction may name the other unit's label."""
    from repro_torch.kernels.bmu import ref as bmu_ref
    idx_r, _ = bmu_ref.bmu_ref(w, s)
    near = bmu_ref.top2_gap(w, s) <= bmu_ref.tie_bound(w, s)
    return labels[idx_r.long()], near


def serving_path(device, tm, xte, worst):
    """Phase 7b, the map-serving tier on the staged main path's 30x30x784
    map: (1) ``tm.save`` and ``TopoMap.load`` on the card, bitwise, the
    checksums verified; (2) ``MapService.from_artifact`` serving the 10,000
    test samples (bucket 4,096: 4,096 + 4,096 + 1,808), 64 one-sample
    requests and ragged ones of 2..8 (bucket 8), each held to the plain
    version under the tie-bound contract and repeated bitwise, one
    signature per bucket, one ``bmu`` launch a dispatch; (3) a
    ``MapGateway`` with 8 client threads x 250 batch-1 requests, every
    answer held to the plain version; (4) a 2-replica ``MapFleet`` from a
    ``MapStore`` under 8 threads of batch-8 requests, v2 published and
    ``reload()`` mid-run, no failure, every prediction the plain version's
    on v1 or v2; (5) ``update`` on the ``kernel`` backend, 4 steps of
    B = 16, bitwise ``TopoMap.partial_fit``, no new signature, the new
    weights served; (6) ``serve_map.main`` in-process through the gateway.
    Launch counts are those of (1)-(6). Then (7) the kernel rows:
    ``BmuEngine.bmu`` at buckets 8 and 4,096, a batch-1 request through
    the engine beside the bare wrapper and ``cdist().min``, and the
    10,000-sample query as one B = 10,000 launch beside the engine's
    chunks."""
    import shutil
    from repro_torch.api import MapStore, TopoMap, load_artifact
    from repro_torch.device import sm_count
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.launch import serve_map
    from repro_torch.serving import (LatencyHistogram, MapFleet, MapGateway,
                                     MapService, maps)
    from repro_torch.training.checkpoint import file_sha256
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    cache = maps.GLOBAL_COMPILE_CACHE
    work = ROOT / "build" / "chip_smoke_maps"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    _reset_launch_counts()

    # (1) artifact round trip on the card
    path = tm.save(str(work / "art"), extra_meta={"by": "chip_smoke"})
    art = load_artifact(path, device=device)
    for fname, digest in art.meta["checksums"].items():
        if file_sha256(str(Path(path) / fname)) != digest:
            raise AssertionError(f"artifact {fname}: checksum differs")
    tm2 = TopoMap.load(path, device=device)
    if not (torch.equal(tm.transform(xte), tm2.transform(xte))
            and torch.equal(tm.predict(xte), tm2.predict(xte))
            and torch.equal(tm.state_.w, tm2.state_.w)):
        raise AssertionError("TopoMap.save/load: not bitwise")
    print(f"serving (1): save -> load on the card bitwise (transform, "
          f"predict, w); checksums of {sorted(art.meta['checksums'])} "
          f"verified")

    # (2) the service: 10,000 samples (bucket 4,096), one-sample and
    # ragged requests of 2..8 (bucket 8), each served twice
    svc = MapService.from_artifact(path, device=device)
    w = svc.snapshot()[0].w
    launches0, dispatches0 = bmu_ops.launches, sum(cache.dispatches.values())
    requests = ([("4096", xte)] + [("1", xte[i:i + 1]) for i in range(64)]
                + [("8", xte[64 + 8 * k:64 + 8 * k + b])
                   for k, b in enumerate(range(2, 9))])
    err = {"4096": 0.0, "1": 0.0, "8": 0.0}
    ties = {"4096": 0, "1": 0, "8": 0}
    for kind, s in requests:
        idx, q2, _ = svc.serve_bmu(s)
        idx2, q22, _ = svc.serve_bmu(s)
        if not (torch.equal(idx, idx2) and torch.equal(q2, q22)):
            raise AssertionError(f"service, {len(s)} samples: identical "
                                 f"requests differ")
        n_tie, e = _held_to_ref(w, s, idx, q2, f"service, {len(s)} samples")
        ties[kind] += n_tie
        err[kind] = max(err[kind], e)
    err["8"] = max(err["8"], err["1"])
    worst["bmu"] = max(worst["bmu"], *err.values())
    shape_keys = [k for k in cache.keys if k[1:3] == tuple(w.shape)]
    if ({k[0] for k in shape_keys} != {8, 4096}
            or len(shape_keys) != 2 or cache.trace_count != len(cache.keys)):
        raise AssertionError(f"signatures: {cache.trace_count} for "
                             f"{sorted(cache.keys)}")
    dispatched = sum(cache.dispatches.values()) - dispatches0
    if bmu_ops.launches - launches0 != dispatched:
        raise AssertionError(f"service: {bmu_ops.launches - launches0} bmu "
                             f"launches for {dispatched} dispatches")
    print(f"serving (2): through MapService, each request twice: 10,000 "
          f"queries ({ties['4096']} near-tie index differences from the "
          f"plain version, max|dq2| {err['4096']:.3g}); 64 one-sample "
          f"requests ({ties['1']}, {err['1']:.3g}); 7 of 2..8 samples "
          f"({ties['8']}, {err['8']:.3g}); repeats bitwise; signatures "
          f"{sorted(k[0] for k in shape_keys)}; {dispatched} dispatches, "
          f"as many bmu launches")

    # (3) the gateway: 8 threads x 250 batch-1 requests
    n_req = GATEWAY_CLIENTS * GATEWAY_REQUESTS
    queries = xte[:n_req].cpu().numpy()
    answers = [None] * n_req
    lat = LatencyHistogram()
    with MapGateway(max_delay=0.002, device=device) as gw:
        gw.attach("map", svc)

        def client(k):
            for i in range(k, n_req, GATEWAY_CLIENTS):
                t0 = time.perf_counter()
                answers[i] = gw.transform("map", queries[i:i + 1])
                lat.record(time.perf_counter() - t0)

        t0 = time.perf_counter()
        _client_threads(GATEWAY_CLIENTS, client)
        gw_s = time.perf_counter() - t0
        g = gw.stats
    got = torch.as_tensor(np.concatenate(answers), device=device)
    gw_ties, _ = _held_to_ref(w, xte[:n_req], got, None, "gateway")
    q = lat.quantiles()
    print(f"serving (3): gateway, {GATEWAY_CLIENTS} threads x "
          f"{GATEWAY_REQUESTS} batch-1 requests: {n_req / gw_s:.1f} "
          f"requests/s, {g.dispatches} dispatches of mean "
          f"{g.mean_dispatch_size():.2f} samples (max {g.max_dispatch}); "
          f"latency ms p50 {q['p50'] * 1e3:.3f} p95 {q['p95'] * 1e3:.3f} "
          f"p99 {q['p99'] * 1e3:.3f}; every answer the plain version's "
          f"({gw_ties} near-tie differences)")

    # (4) a 2-replica fleet from a store, v2 published and rolled mid-run
    store = MapStore(str(work / "store"))
    store.save(tm, "mnist")
    fleet = MapFleet.from_store(store.root, "mnist", replicas=2,
                                device=device, max_outstanding=64,
                                shed_deadline=30.0)
    v2 = tm.state_._replace(w=torch.flip(tm.state_.w, [0]).contiguous())
    labels2 = torch.flip(tm.unit_labels_, [0])
    n_batches = FLEET_CLIENTS * FLEET_REQUESTS
    xf = xte[:n_batches * FLEET_BATCH]
    want = [_labels_of_ref(v.w, lab, xf)
            for v, lab in ((tm.state_, tm.unit_labels_), (v2, labels2))]

    def plain_on(i, p, versions=(0, 1)):
        rows = slice(FLEET_BATCH * i, FLEET_BATCH * (i + 1))
        return any(bool(((p == want[v][0][rows]) | want[v][1][rows]).all())
                   for v in versions)

    failures, done, preds = [], [0], [None] * n_batches

    def fleet_client(k):
        for i in range(k, n_batches, FLEET_CLIENTS):
            try:
                preds[i] = fleet.predict(
                    xf[FLEET_BATCH * i:FLEET_BATCH * (i + 1)])
            except BaseException as e:  # noqa: BLE001 — counted
                failures.append(e)
                continue
            done[0] += 1

    def publish(k):
        if k == 0:
            deadline = time.perf_counter() + 60
            while (done[0] < n_batches // 4
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            store.save_state("mnist", cfg=tm.cfg, state=v2,
                             unit_labels=labels2)
            fleet.reload()
        else:
            fleet_client(k - 1)

    t0 = time.perf_counter()
    _client_threads(FLEET_CLIENTS + 1, publish)
    fleet_s = time.perf_counter() - t0
    f = fleet.stats
    failures += [("torn or wrong predict", i) for i, p in enumerate(preds)
                 if p is not None and not plain_on(i, p)]
    if failures or f.sheds or fleet.version != 2 or f.reloads != 1:
        raise AssertionError(f"fleet: {failures[:3]}, sheds {f.sheds}, "
                             f"version {fleet.version}")
    if not plain_on(0, fleet.predict(xf[:FLEET_BATCH]), versions=(1,)):
        raise AssertionError("fleet: v2 not served after the reload")
    print(f"serving (4): fleet of 2 replicas, {FLEET_CLIENTS} threads x "
          f"{FLEET_REQUESTS} requests of {FLEET_BATCH}: {f.completed} "
          f"completed, 0 failed, 0 shed, rolled v1 -> v{fleet.version} "
          f"mid-run, every prediction the plain version's on v1 or v2; "
          f"{f.completed / fleet_s:.1f} requests/s; latency ms "
          f"{f.latency.summary()}")

    # (5) online updates on the kernel backend
    upd = MapService(tm.cfg, tm.state_, update_backend="kernel", seed=SEED,
                     device=device)
    upd.transform(xte[:8])
    traces = cache.trace_count
    mirror = TopoMap.from_state(tm.state_, tm.cfg, backend="kernel",
                                seed=SEED, device=device)
    for k in range(UPDATE_STEPS):
        batch = xte[16 * k:16 * (k + 1)]
        aux = upd.update(batch)
        mirror.partial_fit(batch)
        st, _ = upd.snapshot()
        same = (torch.equal(st.w.view(torch.int32),
                            mirror.state_.w.view(torch.int32))
                and torch.equal(st.c, mirror.state_.c)
                and st.i == mirror.state_.i
                and all(torch.equal(getattr(aux, a),
                                    getattr(mirror.fit_aux_, a))
                        for a in ("gmu", "cascade_size", "waves")))
        if not same:
            raise AssertionError(f"update {k}: not bitwise partial_fit")
    served, q2, _ = upd.serve_bmu(xte)
    if not torch.equal(served, mirror.transform(xte)):
        raise AssertionError("update: the new weights are not served")
    _held_to_ref(upd.snapshot()[0].w, xte, served, q2, "update")
    if cache.trace_count != traces:
        raise AssertionError("update: a new signature")
    print(f"serving (5): {UPDATE_STEPS} kernel-backend updates of B = 16 "
          f"bitwise TopoMap.partial_fit (w, c, i, gmu, sizes, waves); the "
          f"new weights served (held to the plain version), no new "
          f"signature")

    # (6) the CLI, in-process
    t0 = time.perf_counter()
    serve_map.main(["--artifact", path, "--random", "4096", "--batch", "1",
                    "--concurrency", "8", "--gateway"])
    print(f"serving (6): serve_map --gateway in {time.perf_counter() - t0:.2f}"
          f" s")
    launches = _launch_counts()
    print(f"serving launches {launches}")
    if not (launches.get("bmu@4096") and launches.get("bmu@8")):
        raise AssertionError(f"serving: a bucket was not dispatched: "
                             f"{launches}")
    print(f"serving phase: {time.perf_counter() - t_phase:.2f} s")
    shutil.rmtree(work, ignore_errors=True)

    # (7) kernel rows: the engine's dispatch at each bucket
    rows = []
    (n, d), engine = w.shape, svc.engine
    for label, b, bucket in (("bmu (serving, bucket 8)", 8, "8"),
                             ("bmu (serving, bucket 4096)", 4096, "4096")):
        s = xte[:b].contiguous()
        plan = bmu_ops.plan(n, b, d, sm_count(w.device))
        print(f"{label}: plan {plan.kernel}_kernel, grid {plan.grid} "
              f"({plan.blocks} blocks, {plan.splits} splits of the units)")
        t = time_both({
            "plain": lambda: bmu_ref.bmu_ref(w, s),
            "engine": lambda: engine.bmu(w, s),
            "library": lambda: torch.cdist(s, w).min(dim=1),
        }, 40 if b > 8 else 500, label)
        bound, by = _bmu_bound(n, b, d, f32_peak, bw)
        rows.append({
            "name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/bmu/bmu.cu",
            "replaces": "src/repro/kernels/bmu/bmu.py:26",
            "launches": launches[f"bmu@{bucket}"],
            "max_abs_err": err[bucket],
            "ms": t["engine"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": t["library"]})
    s1 = xte[:1].contiguous()
    fns = {"engine": lambda: engine.bmu(w, s1),
           "wrapper": lambda: bmu_ops.bmu(w, s1),
           "plain": lambda: bmu_ref.bmu_ref(w, s1),
           "library": lambda: torch.cdist(s1, w).min(dim=1)}
    queued = time_in_turns(fns, 100, queue_ahead=True)
    b2b = time_in_turns(fns, 500)
    print("bmu (batch-1 request): " + ", ".join(
        f"{k} {queued[k]:.5f} ms queued ahead ({b2b[k]:.5f} back to back)"
        for k in fns))
    bound, by = _bmu_bound(n, 1, d, f32_peak, bw)
    rows.append({
        "name": "bmu (batch-1 request, BmuEngine.bmu)", "route": "cuda",
        "source": "src/repro_torch/kernels/bmu/bmu.cu",
        "replaces": "src/repro/kernels/bmu/bmu.py:26",
        "launches": launches["bmu@8"], "max_abs_err": err["1"],
        "ms": queued["engine"], "plain_ms": queued["plain"],
        "bound_ms": bound, "bound_by": by, "library_ms": queued["library"],
        "b2b_ms": b2b["engine"], "wrapper_ms": queued["wrapper"],
        "wrapper_b2b_ms": b2b["wrapper"]})
    xq = xte.contiguous()
    t = time_both({"one B=10000 launch": lambda: bmu_ops.bmu(w, xq),
                   "engine": lambda: engine.bmu(w, xq)}, 20,
                  "10,000-sample query")
    print(f"10,000-sample query: {1e4 / t['one B=10000 launch']:.1f} "
          f"samples/ms as one B = 10,000 launch, {1e4 / t['engine']:.1f} "
          f"through the engine, 4,096 + 4,096 + 1,808 (queued)")
    return rows

#: events of the async fast-path phases A and B: the kernel path's 500
#: steps x 16 samples, one sample an event
ASYNC_EVENTS = 8000
#: events of phase C (the engine against the fused fast path, per event)
ASYNC_PAIRED = 200
#: events of phase D (constant latency, the relay race)
ASYNC_CONSTANT = 1000
#: events of phase D's profiled window
ASYNC_PROFILED = 10


def _async_cfg():
    from repro_torch.core import afm
    # batch 1: the async backend's per-sample events; i_max stays 600 N, so
    # the schedules are those of the full run, cut to its first events
    return afm.AFMConfig(side=30, dim=784, batch=1)


def _report_identities(rep, events, waves, what):
    """The fast path's accounting: every sample consumed, one round a
    sample and one a wave, every broadcast delivered, nothing dropped."""
    if not (rep.samples == events and rep.rounds == events + waves
            and rep.sent == rep.deliveries and rep.dropped == 0
            and rep.stranded == 0):
        raise AssertionError(f"{what}: report identities fail: {rep}")


def async_fast_path(device, xtr, ytr, xte, yte, kernel):
    """Phases A and B: ``TopoMap(backend="async")`` at zero latency with
    exact search, ``kernel`` 'fused' (one ``fused_step`` launch an event,
    the search in the kernel) or 'staged' (a ``bmu`` launch at B = 1, the
    plain merge and one ``drive_cascade`` launch an event), for
    ``ASYNC_EVENTS`` events; ``cascade_wave`` once a wave past the 16-wave
    block. The report's identities, QE falling and test accuracy >= 0.9.
    Returns the map, its training launches and its events/s."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP
    cfg = _async_cfg()
    opts = {"kernel": kernel, "search": "exact"}
    qe0 = TopoMap.from_state(afm.init(GeneratorDraws(SEED, device), cfg, xtr),
                             cfg, backend="async", device=device
                             ).quantization_error(xte)
    TopoMap(cfg, backend="async", backend_options=opts,
            device=device).fit(xtr, num_steps=3)
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="async", backend_options=opts, device=device,
                 seed=SEED).fit(xtr, num_steps=ASYNC_EVENTS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    tm.label(xtr, ytr)
    qe = tm.quantization_error(xte)
    acc = float((tm.predict(xte) == yte).float().mean())
    rep, aux = tm.backend.last_report, tm.fit_aux_
    waves = int(aux.waves.sum())
    what = f"async kernel={kernel!r}"
    _report_identities(rep, ASYNC_EVENTS, waves, what)
    tail = int((aux.waves - DEFAULT_WAVE_CAP).clamp(min=0).sum())
    want = ({"fused_step": ASYNC_EVENTS} if kernel == "fused" else
            {"bmu": ASYNC_EVENTS, "drive_cascade": ASYNC_EVENTS})
    want["cascade_wave"] = tail
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launched {launches}, needs {want}")
    if not bool(torch.isfinite(tm.state_.w).all()):
        raise AssertionError(f"{what}: non-finite weights")
    if not qe < qe0:
        raise AssertionError(f"{what}: QE did not fall: {qe0} -> {qe}")
    if acc < ACCURACY_FLOOR:
        raise AssertionError(f"{what}: accuracy {acc} below {ACCURACY_FLOOR}")
    print(f"{what}, exact search, zero latency: {ASYNC_EVENTS} events at "
          f"30x30x784 (B = 1); {waves} waves, {rep.deliveries} deliveries, "
          f"{rep.rounds} rounds; launches {launches} (as required: {want})")
    print(f"{what}: QE initial {qe0:.4f} -> trained {qe:.4f}; accuracy "
          f"{acc:.4f}; fit events/s {ASYNC_EVENTS / fit_s:.1f} "
          f"({fit_s:.3f} s, init included)")
    return tm, launches, ASYNC_EVENTS / fit_s


#: events of phase A2 (the fused fast path with the relay race's GMU)
ASYNC_GIVEN = 200


def async_fused_given(device, xtr):
    """Phase A2: the fused fast path with ``search='heuristic'``: the relay
    race outside the kernel, its GMU given to one ``fused_step`` launch an
    event, ``ASYNC_GIVEN`` events. Returns the launches of the run."""
    from repro_torch.api import TopoMap
    from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP
    cfg = _async_cfg()
    opts = {"kernel": "fused", "search": "heuristic"}
    _reset_launch_counts()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="async", backend_options=opts, device=device,
                 seed=SEED).fit(xtr, num_steps=ASYNC_GIVEN)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    aux = tm.fit_aux_
    waves = int(aux.waves.sum())
    _report_identities(tm.backend.last_report, ASYNC_GIVEN, waves,
                       "async fused, relay race")
    tail = int((aux.waves - DEFAULT_WAVE_CAP).clamp(min=0).sum())
    if (launches["fused_step"] != ASYNC_GIVEN or launches["bmu"]
            or launches["cascade_wave"] != tail):
        raise AssertionError(f"async fused, relay race: launched {launches}")
    if not bool(torch.isfinite(tm.state_.w).all()):
        raise AssertionError("async fused, relay race: non-finite weights")
    print(f"async kernel='fused', relay race (GMU given to the kernel): "
          f"{ASYNC_GIVEN} events, {waves} waves; launches {launches}; "
          f"{ASYNC_GIVEN / fit_s:.1f} events/s ({fit_s:.3f} s, init "
          f"included)")
    return launches


def _ints_equal(a, b, what):
    """Two ``run_events`` results: integer state, aux and report bitwise
    (the clocks too: float32 times from the same operations)."""
    (sa, xa, ra), (sb, xb, rb) = a, b
    pairs = [("c", sa.c, sb.c), ("gmu", xa.gmu, xb.gmu),
             ("cascade_size", xa.cascade_size, xb.cascade_size),
             ("waves", xa.waves, xb.waves)]
    pairs += [(f, getattr(ra, f), getattr(rb, f)) for f in ra._fields]
    for name, x, y in pairs:
        same = torch.equal(x, y) if torch.is_tensor(x) else x == y
        if not same:
            raise AssertionError(f"{what}: {name} differs")


def async_engine_vs_fused(device, xtr):
    """Phase C: the discrete-event engine (``engine='event'``) at zero
    latency with exact search (a ``bmu`` launch a sample round) against the
    fused fast path (A's runner), ``ASYNC_PAIRED`` events from the same
    ``GeneratorDraws`` seed and state: the whole runs' integer state and
    report bitwise; then event by event from the fused run's state (state
    re-injected), integers bitwise and w within 8 (1 + waves) ulps of
    max |w|, the fused step's bound against the plain merge."""
    from repro_torch.core import afm
    from repro_torch.core import events
    from repro_torch.draws import GeneratorDraws
    cfg = _async_cfg()
    state = afm.init(GeneratorDraws(SEED, device), cfg, xtr)
    idx = GeneratorDraws(SEED + 3, device).randint(0, xtr.shape[0],
                                                   (ASYNC_PAIRED,))
    samples = xtr[idx].contiguous()
    fused, engine = (events.EventConfig(kernel="fused"),
                     events.EventConfig(engine="event"))

    def run(st, s, draws, ecfg):
        return events.run_events(st, s, draws, cfg, ecfg,
                                 search=events.search_exact)

    a = run(state, samples, GeneratorDraws(SEED, device), fused)
    b = run(state, samples, GeneratorDraws(SEED, device), engine)
    _ints_equal(a, b, "engine vs fused, whole run")
    eps = torch.finfo(torch.float32).eps
    worst = 0.0
    da, db = GeneratorDraws(SEED, device), GeneratorDraws(SEED, device)
    st = state
    for k in range(ASYNC_PAIRED):
        ea = run(st, samples[k:k + 1], da, fused)
        eb = run(st, samples[k:k + 1], db, engine)
        _ints_equal(ea, eb, f"engine vs fused, event {k}")
        waves = int(ea[1].waves[0])
        dw = float((ea[0].w - eb[0].w).abs().max())
        if dw > 8 * (1 + waves) * eps * float(ea[0].w.abs().max()):
            raise AssertionError(f"engine vs fused, event {k}: |dw| {dw}")
        worst = max(worst, dw)
        st = ea[0]
    rep = a[2]
    if rep.deliveries == 0:
        raise AssertionError("engine vs fused: no cascade ran")
    print(f"engine vs fused fast path, {ASYNC_PAIRED} events from one "
          f"GeneratorDraws seed: {rep.rounds} rounds, {rep.deliveries} "
          f"deliveries; integers and report bitwise over the whole run and "
          f"per event, max|dw| per event {worst:.3g}; whole-run max|dw| "
          f"{float((a[0].w - b[0].w).abs().max()):.3g}")


def _profile_counts(fn):
    """Kernel launches and host syncs of ``fn()`` from a ``torch.profiler``
    trace, with its wall seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {e.key: e.count for e in prof.key_averages()}
    launches = (counts.get("cudaLaunchKernel", 0)
                + counts.get("cudaLaunchCooperativeKernel", 0))
    return launches, counts.get("cudaStreamSynchronize", 0), wall


def async_constant_latency(device, xtr, xte):
    """Phase D, the paper's model: ``latency='constant'``, ``delay=1.0``,
    the relay race (``search='heuristic'``), ``ASYNC_CONSTANT`` events
    through the sample-scan engine. Message conservation with nothing
    stranded, QE falling; rounds, rounds/s and events/s, then launches and
    host syncs a round over a profiled window of ``ASYNC_PROFILED``
    events."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    cfg = _async_cfg()
    opts = {"latency": "constant", "delay": 1.0, "search": "heuristic"}
    qe0 = TopoMap.from_state(afm.init(GeneratorDraws(SEED, device), cfg, xtr),
                             cfg, backend="async", device=device
                             ).quantization_error(xte)
    TopoMap(cfg, backend="async", backend_options=opts,
            device=device).fit(xtr, num_steps=3)
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="async", backend_options=opts, device=device,
                 seed=SEED).fit(xtr, num_steps=ASYNC_CONSTANT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    qe = tm.quantization_error(xte)
    rep = tm.backend.last_report
    if not (rep.sent == rep.deliveries + rep.dropped_overflow + rep.stranded
            and rep.stranded == 0 and rep.samples == ASYNC_CONSTANT):
        raise AssertionError(f"constant latency: accounting fails: {rep}")
    if rep.deliveries == 0:
        raise AssertionError("constant latency: no broadcast delivered")
    if not bool(torch.isfinite(tm.state_.w).all()):
        raise AssertionError("constant latency: non-finite weights")
    if not qe < qe0:
        raise AssertionError(f"constant latency: QE did not fall: {qe0} -> "
                             f"{qe}")
    print(f"async constant latency (delay 1.0), relay race: {ASYNC_CONSTANT} "
          f"events, {rep.rounds} rounds, {rep.deliveries} deliveries, "
          f"{rep.dropped_overflow} dropped, sent {rep.sent}; QE initial "
          f"{qe0:.4f} -> trained {qe:.4f}; our kernels' launches {launches}")
    print(f"async constant latency: {rep.rounds / fit_s:.1f} rounds/s, "
          f"{rep.events / fit_s:.1f} events/s (samples and deliveries), "
          f"{ASYNC_CONSTANT / fit_s:.1f} samples/s ({fit_s:.3f} s, init "
          f"included)")
    backend, state = tm.backend, tm.state_
    draws = GeneratorDraws(SEED + 5, device)
    n_launch, n_sync, wall = _profile_counts(
        lambda: backend.run(state, xtr, draws, ASYNC_PROFILED))
    rounds = backend.last_report.rounds
    print(f"async constant latency, profiled {ASYNC_PROFILED} events, "
          f"{rounds} rounds: {n_launch / rounds:.1f} kernel launches and "
          f"{n_sync / rounds:.2f} host syncs a round (the relay race's "
          f"included), {wall * 1e3 / rounds:.3f} ms a round under the "
          f"profiler")
    return rep.rounds / fit_s


def async_card_vs_cpu(device):
    """Phase E: a small constant-latency run (8x8, D 16, 64 events, exact
    search, a hot p = 0.8) on the card and on the CPU from the same host
    draws: integers, report and clocks bitwise, w within 64 ulps of
    max |w|, q2 within 1e-4 of its largest."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import afm
    from repro_torch.core import events
    cfg = afm.AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    data = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    base = state_to_numpy(afm.init(HostDraws(1, "cpu"), cfg, data))
    outs = [events.run_events(
        state_from_numpy(base, dev), data.to(dev), HostDraws(2, dev), cfg,
        events.EventConfig(latency="constant", delay=1.0),
        search=events.search_exact, p_fn=lambda i, c: 0.8)
        for dev in (device, torch.device("cpu"))]
    card = tuple(outs[0])
    card = (card[0]._replace(w=card[0].w.cpu(), c=card[0].c.cpu()),
            type(card[1])(*(x.cpu() for x in card[1])),
            card[2]._replace(clock=card[2].clock.cpu(),
                             nevents=card[2].nevents.cpu()))
    cpu = outs[1]
    _ints_equal(card, cpu, "card vs CPU")
    eps = torch.finfo(torch.float32).eps
    dw = float((card[0].w - cpu[0].w).abs().max())
    dq2 = float((card[1].q2 - cpu[1].q2).abs().max())
    if dw > 64 * eps * float(cpu[0].w.abs().max()) or dq2 > 1e-4 * float(
            cpu[1].q2.abs().max()):
        raise AssertionError(f"card vs CPU: |dw| {dw}, |dq2| {dq2}")
    if cpu[2].deliveries == 0:
        raise AssertionError("card vs CPU: no cascade ran")
    print(f"async card vs CPU, 8x8 D 16, 64 events at constant latency: "
          f"{cpu[2].rounds} rounds, {cpu[2].deliveries} deliveries; integers,"
          f" report and clocks bitwise, max|dw| {dw:.3g}, max|dq2| {dq2:.3g}")


def check_b1_kernels(device, tms):
    """The async path's new B = 1 shape of ``drive_cascade``: fed from a
    one-sample merge of the staged async map's state, bitwise its plain
    version."""
    from repro_torch.core import afm
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    cfg, state = tms.cfg, tms.state_
    side = cfg.side
    gen = torch.Generator().manual_seed(SEED + 13)
    s = torch.rand(1, cfg.dim, generator=gen).to(device)
    gmu, _ = bmu_ops.bmu(state.w, s)
    merged, counts = afm.adapt_merge(state.w, s, gmu, cfg)
    c = torch.full((side, side), cfg.theta - 1, dtype=torch.int32,
                   device=device)
    args = (merged, c, counts.to(torch.int32).reshape(side, side),
            (torch.rand(8, side, side, generator=gen) < 0.9).to(device),
            (torch.rand(16, 4, side, side, generator=gen) < 0.9).to(device))
    out = cas_ops.drive_cascade(*args, l_c=0.3, theta=cfg.theta, budget=16)
    ref = cas_ref.drive_cascade_ref(*args, l_c=0.3, theta=cfg.theta,
                                    budget=16)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        same = (torch.equal(a.view(torch.int32), r.view(torch.int32))
                if a.is_floating_point() else torch.equal(a, r))
        if not same:
            raise AssertionError("drive_cascade from a one-sample merge: "
                                 "not bitwise")
    print(f"drive_cascade from a one-sample merge (30x30x784): "
          f"{int(out[3][0])} firings in {int(out[3][1])} waves; bitwise "
          f"equal to the plain version")


def async_rows(device, tmf, tms, xtr, fused_launches, staged_launches,
               given_launches, worst, fused_worst):
    """Phase 7 at the async path's B = 1 shapes: ``bmu`` (the staged fast
    path's and the engine's exact search, ``cdist().min`` beside it),
    ``fused_step`` searching and with a given GMU, and ``drive_cascade``
    after a one-sample merge. Launches are those of phases A, A2 and B."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    w = tms.state_.w
    s = xtr[:1].contiguous()
    (n, d), b = w.shape, 1
    plan = bmu_ops.plan(n, b, d, sm_count(w.device))
    print(f"bmu (async search, B=1): plan {plan.kernel}_kernel, grid "
          f"{plan.grid} ({plan.blocks} blocks, {plan.splits} splits of the "
          f"units), then the merge")
    t = time_both({
        "plain": lambda: bmu_ref.bmu_ref(w, s),
        "kernel": lambda: bmu_ops.bmu(w, s),
        "library": lambda: torch.cdist(s, w).min(dim=1),
    }, 500, "bmu (async search, B=1)")
    nbytes = 4 * (n * d + b * d) + 8 * b
    flops = 2 * b * n * d + 2 * (n + b) * d
    bound = max(nbytes / bw, flops / f32_peak) * 1e3
    print(f"bmu (async search, B=1): bound {bound:.6f} ms, kernel at "
          f"{100 * bound / t['kernel']:.1f} % of it")
    rows = [{
        "name": "bmu (async search, B=1)", "route": "cuda",
        "source": "src/repro_torch/kernels/bmu/bmu.cu",
        "replaces": "src/repro/kernels/bmu/bmu.py:26",
        "launches": staged_launches["bmu"], "max_abs_err": worst["bmu"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > flops / f32_peak
        else "operations",
        "library_ms": t["library"]}]
    rows.append(fused_row(device, tmf, xtr, fused_launches, fused_worst))
    rows.append(fused_row(device, tmf, xtr, given_launches, fused_worst,
                          given=True))
    rows.append(drive_cascade_row(device, tms, xtr, staged_launches, worst,
                                  b=1))
    return rows


#: events of phase F (the faulty engine, constant latency 1.0, exact)
FAULT_EVENTS = 2000
#: phase F's plans: none, 10 % broadcast loss, a quarter of the units dead
#: for the middle half of the run
FAULT_PLANS = {
    "no plan": None,
    "p_loss 0.1": {"seed": 11, "p_loss": 0.1},
    "dropout 0.25 [500, 1500)": {"seed": 11, "dropout_frac": 0.25,
                                 "dropout_start": 500, "dropout_len": 1000},
}
#: events of phase F's whole-run dropout window (dead weights frozen)
FAULT_FROZEN_EVENTS = 500
#: events of phase F's profiled windows (launches and host syncs a round)
FAULT_PROFILED = 50
#: ``benchmarks/fault_bench.py``'s DEGRADATION_BUDGET, copied: the QE at 10 %
#: broadcast loss over the fault-free QE that the JAX benchmark allows
DEGRADATION_BUDGET = 1.5


def _conserved(rep):
    return rep.sent == (rep.deliveries + rep.dropped_overflow
                        + rep.dropped_fault + rep.stranded)


def async_faults(device, xtr, xte):
    """Phase F: ``TopoMap(backend="async", backend_options={"faults": ...})``
    at 30x30x784, B = 1, seed 0, ``engine='event'``, constant latency 1.0,
    exact search (one ``bmu`` launch a sample round), ``FAULT_EVENTS``
    events under each of ``FAULT_PLANS``: message conservation, fault
    drops under the faulty plans, dead samples under dropout, QE finite;
    events/s, rounds/s and the QE ratio at 10 % loss. Then a whole-run
    dropout window through ``run_events``: the dead units keep their
    initial weights bitwise; then launches and host syncs a round over a
    profiled window of ``FAULT_PROFILED`` events from the trained state,
    with no plan, loss 0.1 and the whole-run window. Returns the ``bmu``
    launches of the three timed runs."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.core import events
    from repro_torch.draws import GeneratorDraws
    from repro_torch.faults import FaultPlan
    cfg = _async_cfg()
    qe, bmu_launches = {}, 0
    for label, plan in FAULT_PLANS.items():
        opts = {"engine": "event", "latency": "constant", "delay": 1.0,
                "search": "exact", "faults": plan}
        _reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tm = TopoMap(cfg, backend="async", backend_options=opts,
                     device=device, seed=SEED).fit(xtr,
                                                   num_steps=FAULT_EVENTS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launch_counts()
        rep = tm.backend.last_report
        what = f"faults, {label}"
        if not (_conserved(rep) and rep.stranded == 0
                and rep.samples == FAULT_EVENTS):
            raise AssertionError(f"{what}: accounting fails: {rep}")
        if launches["bmu"] != FAULT_EVENTS:
            raise AssertionError(f"{what}: {launches['bmu']} bmu launches "
                                 f"for {FAULT_EVENTS} sample rounds")
        if plan is not None and rep.dropped_fault == 0:
            raise AssertionError(f"{what}: no message dropped by the fault")
        if plan and plan.get("dropout_frac") and rep.samples_dead == 0:
            raise AssertionError(f"{what}: no sample met a dead unit")
        if rep.deliveries == 0:
            raise AssertionError(f"{what}: no broadcast delivered")
        qe[label] = tm.quantization_error(xte)
        if not np.isfinite(qe[label]):
            raise AssertionError(f"{what}: QE {qe[label]}")
        bmu_launches += launches["bmu"]
        print(f"{what}: {FAULT_EVENTS} events at 30x30x784, constant "
              f"latency 1.0, exact search: {FAULT_EVENTS / fit_s:.1f} "
              f"events/s, {rep.rounds / fit_s:.1f} rounds/s ({fit_s:.3f} s, "
              f"init included); {rep.rounds} rounds, sent {rep.sent}, "
              f"delivered {rep.deliveries}, dropped_fault "
              f"{rep.dropped_fault}, dropped_overflow {rep.dropped_overflow},"
              f" samples_dead {rep.samples_dead}; QE {qe[label]:.4f}; "
              f"launches {launches}")
    ratio = qe["p_loss 0.1"] / qe["no plan"]
    print(f"faults: QE at p_loss 0.1 / QE with no plan = {ratio:.4f} "
          f"(fault_bench's DEGRADATION_BUDGET {DEGRADATION_BUDGET})")

    plan = FaultPlan(seed=11, dropout_frac=0.25, dropout_len=1e9)
    state = afm.init(GeneratorDraws(SEED, device), cfg, xtr)
    w0 = state.w.clone()
    idx = GeneratorDraws(SEED + 3, device).randint(0, xtr.shape[0],
                                                   (FAULT_FROZEN_EVENTS,))
    out, _, rep = events.run_events(
        state, xtr[idx].contiguous(), GeneratorDraws(SEED, device), cfg,
        events.EventConfig(latency="constant", delay=1.0, engine="event",
                           faults=plan), search=events.search_exact)
    dead = plan.dead_units(cfg.n_units).to(device)
    if not torch.equal(out.w[dead], w0[dead]):
        raise AssertionError("whole-run dropout: a dead unit's weights moved")
    if torch.equal(out.w[~dead], w0[~dead]) or rep.samples_dead == 0:
        raise AssertionError("whole-run dropout: the live units did not "
                             "train, or no sample met a dead unit")
    if not _conserved(rep):
        raise AssertionError(f"whole-run dropout: accounting fails: {rep}")
    print(f"faults, whole-run dropout window ({int(dead.sum())} of "
          f"{cfg.n_units} units dead), {FAULT_FROZEN_EVENTS} events: dead "
          f"weights bitwise their initial ones, {rep.samples_dead} samples "
          f"met a dead unit, dropped_fault {rep.dropped_fault}")
    samples = xtr[idx[:FAULT_PROFILED]].contiguous()
    for label, prof_plan in (("no plan", None),
                             ("p_loss 0.1", FaultPlan(seed=11, p_loss=0.1)),
                             ("whole-run dropout 0.25", plan)):
        ecfg = events.EventConfig(latency="constant", delay=1.0,
                                  engine="event", faults=prof_plan)
        box = []
        n_launch, n_sync, wall = _profile_counts(
            lambda: box.append(events.run_events(
                out, samples, GeneratorDraws(SEED + 1, device), cfg, ecfg,
                search=events.search_exact)))
        rounds = box[0][2].rounds
        print(f"faults, profiled {FAULT_PROFILED} events, {label}: "
              f"{rounds} rounds, {n_launch / rounds:.2f} kernel launches "
              f"and {n_sync / rounds:.3f} host syncs a round, "
              f"{wall * 1e3 / rounds:.3f} ms a round under the profiler")
    return bmu_launches


def faults_card_vs_cpu(device):
    """Phase F, small: the faulty engine (8x8, D 16, 64 events, constant
    latency, exact search, p = 0.8) under broadcast loss 0.3 and a dropout
    window, on the card and on the CPU from the same host draws (training,
    latency and fault draws): integers, report and fault counts bitwise,
    w within 64 ulps of max |w| (phase E's bound)."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import afm
    from repro_torch.core import events
    from repro_torch.faults import FaultPlan
    cfg = afm.AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    data = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    base = state_to_numpy(afm.init(HostDraws(1, "cpu"), cfg, data))
    plan = FaultPlan(seed=11, p_loss=0.3, dropout_frac=0.25,
                     dropout_start=10.0, dropout_len=30.0)
    outs = [events.run_events(
        state_from_numpy(base, dev), data.to(dev), HostDraws(2, dev), cfg,
        events.EventConfig(latency="constant", delay=1.0, faults=plan),
        search=events.search_exact, p_fn=lambda i, c: 0.8,
        fault_draws=HostDraws(5, dev))
        for dev in (device, torch.device("cpu"))]
    card = tuple(outs[0])
    card = (card[0]._replace(w=card[0].w.cpu(), c=card[0].c.cpu()),
            type(card[1])(*(x.cpu() for x in card[1])),
            card[2]._replace(clock=card[2].clock.cpu(),
                             nevents=card[2].nevents.cpu()))
    cpu = outs[1]
    _ints_equal(card, cpu, "faults, card vs CPU")
    eps = torch.finfo(torch.float32).eps
    dw = float((card[0].w - cpu[0].w).abs().max())
    if dw > 64 * eps * float(cpu[0].w.abs().max()):
        raise AssertionError(f"faults, card vs CPU: |dw| {dw}")
    rep = cpu[2]
    if not (_conserved(rep) and rep.dropped_fault and rep.samples_dead):
        raise AssertionError(f"faults, card vs CPU: {rep}")
    print(f"faults, card vs CPU, 8x8 D 16, 64 events, p_loss 0.3 and a "
          f"dropout window: {rep.rounds} rounds, dropped_fault "
          f"{rep.dropped_fault}, samples_dead {rep.samples_dead}; integers,"
          f" report and fault counts bitwise, max|dw| {dw:.3g}")


#: phase G: events of each stream run, samples a step, samples a swap
STREAM_EVENTS = 4096
STREAM_CHUNK = 64
STREAM_SWAP = 1024


def stream_phase(device, xtr, xte):
    """Phase G: ``launch/stream_train.run_stream`` at 30x30x784 (async
    backend, zero latency, exact search, ``kernel='fused'``: one
    ``fused_step`` launch an event), ``STREAM_EVENTS`` events in chunks of
    ``STREAM_CHUNK``, a swap every ``STREAM_SWAP``, 2 client threads of
    batch 8 reading QE through a ``MapGateway`` (``bmu`` at bucket 8, or
    64 for two coalesced reads; the final QE of the 10,000 test samples at
    bucket 4,096). In memory first
    (no client error, a read at least, >= 4 swaps, QE finite); then store
    backed, uninterrupted, against a run killed by SIGTERM (its real
    handler) at half the events with a checkpoint every ``STREAM_SWAP``
    and resumed: the final artifacts' ``w`` and ``i`` bitwise. Returns
    the in-memory run's launches."""
    import tempfile
    from repro_torch.api import MapStore
    from repro_torch.core import afm
    from repro_torch.launch.stream_train import run_stream
    cfg = afm.AFMConfig(side=30, dim=784, i_max=STREAM_EVENTS)
    common = dict(backend="async",
                  backend_options={"search": "exact", "kernel": "fused"},
                  events=STREAM_EVENTS, chunk=STREAM_CHUNK,
                  swap_every=STREAM_SWAP, clients=2, client_batch=8,
                  name="stream", seed=SEED, device=device)
    _reset_launch_counts()
    rep = run_stream(cfg, xtr, xte, **common)
    launches = _launch_counts()
    if (rep.client_errors or rep.client_requests < 1 or rep.swaps < 4
            or not rep.qe_finite or rep.qe.shape != (len(xte),)):
        raise AssertionError(f"stream: errors {rep.client_errors}, "
                             f"{rep.client_requests} reads, {rep.swaps} "
                             f"swaps, QE finite {rep.qe_finite}")
    reads = launches.get("bmu@8", 0) + launches.get("bmu@64", 0)
    if launches["fused_step"] != STREAM_EVENTS or not reads:
        raise AssertionError(f"stream: launched {launches}")
    print(f"stream (in memory): {rep.events} events at 30x30x784, "
          f"{rep.events_per_sec:.1f} events/s ({rep.seconds:.3f} s), "
          f"{rep.swaps} swaps, {rep.client_requests} client reads, "
          f"{rep.gateway.dispatches} coalesced dispatches; QE "
          f"{float(rep.qe.mean()):.4f} over {len(rep.qe)} samples; "
          f"launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        full = run_stream(cfg, xtr, xte, store_root=f"{tmp}/a", **common)
        cut = run_stream(cfg, xtr, xte, store_root=f"{tmp}/b",
                         checkpoint_dir=f"{tmp}/ck",
                         checkpoint_every=STREAM_SWAP,
                         die_after=STREAM_EVENTS // 2, **common)
        logs = []
        res = run_stream(cfg, xtr, xte, store_root=f"{tmp}/b",
                         checkpoint_dir=f"{tmp}/ck", resume=True,
                         log=lambda *a: logs.append(" ".join(map(str, a))),
                         **common)
        arts = [MapStore(f"{tmp}/{r}").load_artifact("stream", device="cpu")
                for r in "ab"]
    if not (cut.interrupted and cut.events == STREAM_EVENTS // 2
            and not res.interrupted
            and any("checksum verified" in line for line in logs)):
        raise AssertionError(f"stream resume: interrupted {cut.interrupted}"
                             f" at {cut.events}; logs {logs}")
    for r in (full, cut, res):
        if r.client_errors or not r.qe_finite:
            raise AssertionError(f"stream (store): {r.client_errors}")
    if not (arts[0].state.i == arts[1].state.i == STREAM_EVENTS
            and torch.equal(arts[0].state.w, arts[1].state.w)):
        raise AssertionError("stream resume: the resumed map is not the "
                             "uninterrupted run's bitwise")
    print(f"stream (store backed): uninterrupted {full.events_per_sec:.1f} "
          f"events/s, {full.swaps} swaps, {full.client_requests} reads; "
          f"killed by SIGTERM at {cut.events} events and resumed "
          f"({res.events_per_sec:.1f} events/s): final w and i bitwise the "
          f"uninterrupted run's")
    return launches


#: phase H (the mesh placement, 2 ranks on the card over gloo): events of
#: the zero-latency run, the constant-latency run and the faulty run (run
#: twice), of the profiled window and of the 3-rank run, at 30x30x784
MESH_ZERO = 1000
MESH_CONSTANT = 500
MESH_FAULTY = 500
MESH_PROFILED = 50
MESH_THREE = 300
#: phase H's faulty plan: 10 % broadcast loss, shard 1 three times slower
MESH_FAULTS = {"seed": 11, "p_loss": 0.1, "shard_latency_mult": (1.0, 3.0)}
#: phase I (the sharded backend): steps of each mesh's fit (B = 16), of the
#: card-vs-CPU comparison, and of the 1 x 1 and 1-rank NCCL fits
SHARDED_STEPS = 200
SHARDED_PAIRED = 3
SHARDED_ONE = 20
#: seconds a set of ranks may take before its phase fails (the ranks are
#: then stopped)
RANK_TIMEOUT = 600.0


def _profiled_busy(fn):
    """``fn()`` under ``torch.profiler``: (its result, this process's device
    busy microseconds, wall seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    from torch.autograd import DeviceType
    busy = sum(getattr(e, attr) for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)
    return out, busy, wall


def _run_summary(out, seconds, launches=None):
    """A mesh run's report as host values, with a checksum of its dense
    state (every rank must hold the same)."""
    import hashlib
    st, aux, rep = out
    digest = hashlib.sha256()
    for x in (st.w, st.c, aux.gmu, aux.q2, aux.cascade_size, aux.waves,
              rep.clock, rep.nevents):
        digest.update(x.detach().cpu().numpy().tobytes())
    from repro_torch.core.placement import mesh
    return {"seconds": seconds, "rounds": rep.rounds, "samples": rep.samples,
            "deliveries": rep.deliveries, "sent": rep.sent,
            "dropped_overflow": rep.dropped_overflow,
            "dropped_fault": rep.dropped_fault, "stranded": rep.stranded,
            "rows": rep.shard_counts, "digest": digest.hexdigest(),
            "finite": bool(torch.isfinite(st.w).all()),
            "stats": dict(mesh.stats), "launches": launches}


def _mesh_rank(rank, shards, full):
    """Phase H on one of ``shards`` gloo ranks on the card: the mesh runs
    of ``run_events(placement="mesh")`` at 30x30x784 (seed 0), exact
    search (a ``bmu`` launch on the shard's band a sample round); with
    ``full`` also constant latency, the faulty run twice, a profiled
    window and a small run on the card against the CPU."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm, events
    from repro_torch.data import make_dataset
    from repro_torch.draws import GeneratorDraws
    from repro_torch.faults import FaultPlan
    from repro_torch.kernels import _build
    from repro_torch.kernels.bmu import ops as bmu_ops
    device = torch.device("cuda")
    _build.load()
    xtr, _, xte, _ = make_dataset("mnist", seed=SEED, device=device)
    cfg = _async_cfg()
    init = afm.init(GeneratorDraws(SEED, device), cfg, xtr)

    def run(n_events, faults=None, **ekw):
        idx = GeneratorDraws(SEED + 7, device).randint(0, xtr.shape[0],
                                                       (n_events,))
        ecfg = events.EventConfig(
            **ekw, faults=FaultPlan(**faults) if faults else None)
        return events.run_events(
            init, xtr[idx].contiguous(),
            GeneratorDraws(SEED + 1, device).fold_in(rank), cfg, ecfg,
            search=events.search_exact, placement="mesh", shards=shards,
            lat_seed=SEED + 2)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(5, latency="zero")                   # warm-up
    # the main path of the phase: counts set to 0 just before, read after
    _reset_launch_counts()
    out, sec = timed(lambda: run(MESH_ZERO if full else MESH_THREE,
                                 latency="zero"))
    res = {"zero": _run_summary(out, sec, _launch_counts())}
    if rank == 0:
        res["qe_zero"] = TopoMap.from_state(out[0], cfg, backend="async",
                                            device=device
                                            ).quantization_error(xte)
    if not full:
        return res
    out, sec = timed(lambda: run(MESH_CONSTANT, latency="constant",
                                 delay=1.0))
    res["constant"] = _run_summary(out, sec)
    for key in ("faulty", "faulty again"):
        out, sec = timed(lambda: run(MESH_FAULTY, faults=MESH_FAULTS,
                                     latency="constant", delay=1.0))
        res[key] = _run_summary(out, sec)
    _, busy, wall = _profiled_busy(lambda: run(MESH_PROFILED,
                                               latency="zero"))
    from repro_torch.core.placement import mesh
    res["profiled"] = {"busy_us": busy, "wall": wall,
                       "stats": dict(mesh.stats)}
    res["card_vs_cpu"] = _mesh_card_vs_cpu(rank, shards, device)
    res["latency"] = _sync_latencies(shards, device)
    return res


def _sync_latencies(shards, device, n=200):
    """Mean microseconds of one host ``all_gather`` among the ranks, and
    of one device read (a small kernel and its ``.item()``) while every
    rank reads at once; ``shards`` 0 times the read alone, without a
    group."""
    x = torch.zeros(64, dtype=torch.int64)
    y = torch.zeros(1, device=device)
    out = {}
    if shards:
        from repro_torch.sharding import ShardMesh
        mesh = ShardMesh((shards,), ("shards",))
        mesh.all_gather(x, "shards")
        t0 = time.perf_counter()
        for _ in range(n):
            mesh.all_gather(x, "shards")
        out["gather_us"] = (time.perf_counter() - t0) / n * 1e6
        mesh.all_gather(x, "shards")             # the ranks start together
    float((y + 1).item())
    t0 = time.perf_counter()
    for _ in range(n):
        float((y + 1).item())
    out["read_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def _mesh_card_vs_cpu(rank, shards, device):
    """A small mesh run (8x8, D 16, 64 events, constant latency, exact
    search, p = 0.8, a 0.3 broadcast loss) on the card and on the CPU from
    the same host draws: integers and report bitwise, w within 64 ulps of
    max |w|. Returns max |dw|."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import afm, events
    from repro_torch.faults import FaultPlan
    cfg = afm.AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    data = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    base = state_to_numpy(afm.init(HostDraws(1, "cpu"), cfg, data))
    ecfg = events.EventConfig(latency="constant", delay=1.0,
                              faults=FaultPlan(seed=11, p_loss=0.3))
    outs = [events.run_events(
        state_from_numpy(base, dev), data.to(dev),
        HostDraws(2, dev).fold_in(rank), cfg, ecfg,
        search=events.search_exact, p_fn=lambda i, c: 0.8,
        fault_draws=HostDraws(5, dev).fold_in(rank), placement="mesh",
        shards=shards) for dev in (device, torch.device("cpu"))]
    card = (outs[0][0]._replace(w=outs[0][0].w.cpu(), c=outs[0][0].c.cpu()),
            type(outs[0][1])(*(x.cpu() for x in outs[0][1])),
            outs[0][2]._replace(clock=outs[0][2].clock.cpu(),
                                nevents=outs[0][2].nevents.cpu()))
    cpu = outs[1]
    _ints_equal(card, cpu, "mesh, card vs CPU")
    eps = torch.finfo(torch.float32).eps
    dw = float((card[0].w - cpu[0].w).abs().max())
    if dw > 64 * eps * float(cpu[0].w.abs().max()):
        raise AssertionError(f"mesh, card vs CPU: |dw| {dw}")
    if cpu[2].deliveries == 0 or cpu[2].dropped_fault == 0:
        raise AssertionError(f"mesh, card vs CPU: {cpu[2]}")
    return {"dw": dw, "rounds": cpu[2].rounds,
            "deliveries": cpu[2].deliveries}


def _mesh_checks(res, shards, events, what):
    """Every rank holds the same result; per shard ``sent == delivered +
    overflow + fault + stranded``; the rows sum to the global counters;
    every sample consumed, nothing stranded."""
    first = res[0]
    if any(r["digest"] != first["digest"] for r in res):
        raise AssertionError(f"{what}: the ranks' results differ")
    rows = np.asarray(first["rows"], np.int64)
    if rows.shape != (shards, 5):
        raise AssertionError(f"{what}: shard rows {rows.shape}")
    if not (rows[:, 0] == rows[:, 1:].sum(axis=1)).all():
        raise AssertionError(f"{what}: a shard's accounting fails: {rows}")
    if not (rows[:, 0].sum() == first["sent"]
            and rows[:, 1].sum() == first["deliveries"]
            and rows[:, 3].sum() == first["dropped_fault"]):
        raise AssertionError(f"{what}: shard rows do not sum to the totals")
    if first["samples"] != events or first["stranded"] or \
            not first["finite"]:
        raise AssertionError(f"{what}: {first}")
    if first["deliveries"] == 0:
        raise AssertionError(f"{what}: no broadcast delivered")


def _per_iteration(s, what, seconds):
    it = max(s["drain_iterations"], 1)
    return (f"{what}: {s['drain_iterations']} drain iterations, "
            f"{s['collectives'] / it:.2f} collectives and "
            f"{s['host_reads'] / it:.2f} device reads an iteration (sample "
            f"rounds' included), {s['weight_gathers']} boundary-row "
            f"gathers, {s['exchange_s']:.3f} s in the exchange "
            f"({100 * s['exchange_s'] / seconds:.1f} % of the run)")


def mesh_phase(device, xtr, xte, worst):
    """Phase H: the mesh placement on the card. Two gloo ranks on the one
    card run ``_mesh_rank`` (zero latency, exact, ``MESH_ZERO`` events;
    constant latency 1.0, ``MESH_CONSTANT``; the faulty plan twice, which
    must replay bitwise; a profiled window; a small run against the CPU),
    then three ranks run ``MESH_THREE`` zero-latency events. Every rank
    must launch ``bmu`` once a sample round on its band. QE must land in
    the band of the single pool's run on the same data and draws' seed.
    Returns the kernel row of ``bmu`` at the band's shape, B = 1."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm, events
    from repro_torch.device import sm_count
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.sharding import spawn_ranks
    t_phase = time.perf_counter()
    two = spawn_ranks(_mesh_rank, 2, (2, True), dist_backend="gloo",
                      timeout=RANK_TIMEOUT)
    t_two = time.perf_counter() - t_phase
    three = spawn_ranks(_mesh_rank, 3, (3, False), dist_backend="gloo",
                        timeout=RANK_TIMEOUT)
    print(f"mesh phase: 2 ranks {t_two:.1f} s, 3 ranks "
          f"{time.perf_counter() - t_phase - t_two:.1f} s (process start, "
          f"data and kernel load included)")
    for res, shards, key, n_ev in ((two, 2, "zero", MESH_ZERO),
                                   (three, 3, "zero", MESH_THREE),
                                   (two, 2, "constant", MESH_CONSTANT),
                                   (two, 2, "faulty", MESH_FAULTY)):
        _mesh_checks([r[key] for r in res], shards, n_ev,
                     f"mesh {shards} ranks, {key}")
    for res, shards, n_ev in ((two, 2, MESH_ZERO), (three, 3, MESH_THREE)):
        for rank, r in enumerate(res):
            got = r["zero"]["launches"]["bmu"]
            if got != n_ev:
                raise AssertionError(
                    f"mesh {shards} ranks: rank {rank} launched bmu {got} "
                    f"times for {n_ev} sample rounds")
    faulty, again = two[0]["faulty"], two[0]["faulty again"]
    if faulty["digest"] != again["digest"] or faulty["rows"] != again["rows"]:
        raise AssertionError("mesh, faulty run: one seed did not replay "
                             "bitwise")
    if faulty["dropped_fault"] == 0:
        raise AssertionError("mesh, faulty run: no message lost")
    # the single pool on the same data, samples and seeds, for QE's band
    cfg = _async_cfg()
    init = afm.init(GeneratorDraws(SEED, device), cfg, xtr)
    idx = GeneratorDraws(SEED + 7, device).randint(0, xtr.shape[0],
                                                   (MESH_ZERO,))
    single, _, _ = events.run_events(
        init, xtr[idx].contiguous(), GeneratorDraws(SEED + 1, device), cfg,
        events.EventConfig(latency="zero"), search=events.search_exact)
    qe = {k: TopoMap.from_state(s, cfg, backend="async", device=device
                                ).quantization_error(xte)
          for k, s in (("init", init), ("single", single))}
    qe["mesh"] = two[0]["qe_zero"]
    if not (qe["single"] < 1.5 * qe["init"] and np.isfinite(qe["mesh"])
            and qe["mesh"] < 1.3 * qe["single"]):
        raise AssertionError(f"mesh: QE out of the single pool's band: {qe}")
    print(f"mesh QE after {MESH_ZERO} zero-latency events: initial "
          f"{qe['init']:.4f}, single pool {qe['single']:.4f}, 2-shard mesh "
          f"{qe['mesh']:.4f} (3-shard ran {MESH_THREE} events)")
    for res, shards, key, n_ev in ((two, 2, "zero", MESH_ZERO),
                                   (three, 3, "zero", MESH_THREE),
                                   (two, 2, "constant", MESH_CONSTANT),
                                   (two, 2, "faulty", MESH_FAULTY)):
        r = res[0][key]
        sec = r["seconds"]
        print(f"mesh {shards} ranks, {key}: {n_ev} events at 30x30x784, "
              f"exact search: {n_ev / sec:.1f} events/s, "
              f"{r['rounds'] / sec:.1f} rounds/s ({sec:.3f} s); "
              f"{r['rounds']} rounds, sent {r['sent']}, delivered "
              f"{r['deliveries']}, dropped_fault {r['dropped_fault']}, "
              f"dropped_overflow {r['dropped_overflow']}; shard rows "
              f"{r['rows']}")
        print(_per_iteration(r["stats"], f"mesh {shards} ranks, {key}", sec))
    prof = [r["profiled"] for r in two]
    wall = max(p["wall"] for p in prof)
    busy = sum(p["busy_us"] for p in prof)
    print(f"mesh 2 ranks, profiled {MESH_PROFILED} zero-latency events: wall "
          f"{wall * 1e3 / MESH_PROFILED:.3f} ms/event, both ranks' device "
          f"busy {busy / 1e3 / MESH_PROFILED:.4f} ms/event, idle share "
          f"{100 * (1 - busy / 1e6 / wall):.1f} %")
    lat = [r["latency"] for r in two]
    alone = _sync_latencies(0, device)["read_us"]
    print(f"mesh 2 ranks: a host all_gather of the ranks "
          f"{lat[0]['gather_us']:.1f} us; a device read (a small kernel and "
          f"its .item()) {lat[0]['read_us']:.1f} / {lat[1]['read_us']:.1f} "
          f"us on ranks 0 / 1 reading at once, {alone:.1f} us from this "
          f"process alone")
    cvc = two[0]["card_vs_cpu"]
    print(f"mesh card vs CPU, 2 ranks, 8x8 D 16, 64 events, constant "
          f"latency, loss 0.3: {cvc['rounds']} rounds, {cvc['deliveries']} "
          f"deliveries; integers and report bitwise, max|dw| "
          f"{cvc['dw']:.3g}")
    # the kernel at the band's shape: 450 units of 784, one sample
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    w = single.w[:cfg.n_units // 2].contiguous()
    s = xtr[:1].contiguous()
    idx_k, q2_k = bmu_ops.bmu(w, s)
    idx_r, q2_r = bmu_ref.bmu_ref(w, s)
    torch.cuda.synchronize()
    err = float((q2_k - q2_r).abs().max())
    if not (torch.equal(idx_k.long(), idx_r.long())
            and err <= float(bmu_ref.tie_bound(w, s).max())):
        raise AssertionError(f"bmu at the band's shape: {idx_k} {idx_r} "
                             f"|dq2| {err}")
    (n, d), b = w.shape, 1
    plan = bmu_ops.plan(n, b, d, sm_count(w.device))
    label = "bmu (mesh shard search, B=1, N=450)"
    print(f"{label}: plan {plan.kernel}_kernel, grid {plan.grid} "
          f"({plan.blocks} blocks, {plan.splits} splits of the units), then "
          f"the merge")
    t = time_both({
        "plain": lambda: bmu_ref.bmu_ref(w, s),
        "kernel": lambda: bmu_ops.bmu(w, s),
        "library": lambda: torch.cdist(s, w).min(dim=1),
    }, 500, label)
    nbytes = 4 * (n * d + b * d) + 8 * b
    flops = 2 * b * n * d + 2 * (n + b) * d
    bound = max(nbytes / bw, flops / f32_peak) * 1e3
    print(f"{label}: bound {bound:.6f} ms, kernel at "
          f"{100 * bound / t['kernel']:.1f} % of it")
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return {"name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/bmu/bmu.cu",
            "replaces": "src/repro/kernels/bmu/bmu.py:26",
            "launches": two[0]["zero"]["launches"]["bmu"],
            "max_abs_err": max(worst["bmu"], err),
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": "bytes" if nbytes / bw > flops / f32_peak
            else "operations",
            "library_ms": t["library"]}


def _sharded_cfg():
    from repro_torch.core import afm
    return afm.AFMConfig(side=30, dim=784, batch=16)


def _sharded_rank(rank, shape):
    """Phase I on one rank of a ``shape`` (data, model) mesh, gloo on the
    card: ``TopoMap(backend="sharded")`` for ``SHARDED_STEPS`` steps at
    30x30x784, B = 16, seed 0; then ``SHARDED_PAIRED`` sharded steps on the
    card against the same steps on the CPU from one state (host draws)."""
    from repro_torch.api import TopoMap
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import afm, distributed
    from repro_torch.data import make_dataset
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels import _build
    from repro_torch.sharding import ShardMesh
    device = torch.device("cuda")
    _build.load()
    xtr, _, xte, _ = make_dataset("mnist", seed=SEED, device=device)
    cfg = _sharded_cfg()
    mesh = ShardMesh(shape, ("data", "model"))
    res = {}
    if rank == 0:
        res["qe0"] = TopoMap.from_state(
            afm.init(GeneratorDraws(SEED, device), cfg, xtr), cfg,
            device=device).quantization_error(xte)
    TopoMap(cfg, backend="sharded", backend_options={"mesh": mesh},
            device=device).fit(xtr, num_steps=2)      # warm-up
    calls0 = mesh.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="sharded", backend_options={"mesh": mesh},
                 device=device, seed=SEED).fit(xtr, num_steps=SHARDED_STEPS)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["collectives"] = mesh.calls - calls0
    res["waves"] = int(tm.fit_aux_.waves.sum())
    res["size"] = int(tm.fit_aux_.cascade_size.sum())
    res["finite"] = bool(torch.isfinite(tm.state_.w).all())
    res["c_max"] = int(tm.state_.c.max())
    res["w"] = tm.state_.w.cpu().numpy()
    if rank == 0:
        res["qe"] = tm.quantization_error(xte)
    # the card against the CPU, one step at a time from the CPU's state
    step = distributed.make_sharded_train_step(cfg, mesh)
    didx = distributed.data_index(mesh)
    me = mesh.axis_index("model")
    b = cfg.batch // shape[0]
    dense = state_to_numpy(tm.state_)
    dense["i"] = np.int32(tm.state_.i)
    worst, sizes = 0.0, []
    for k in range(SHARDED_PAIRED):
        batch = xtr[k * cfg.batch:(k + 1) * cfg.batch]
        outs = []
        for dev in (device, torch.device("cpu")):
            src = HostDraws(100 + k, dev)
            st = distributed.shard_state_for_mesh(
                state_from_numpy(dense, dev), cfg, mesh)
            new, aux = step(st, batch[didx * b:(didx + 1) * b].to(dev),
                            src.fold_in(didx).fold_in(me),
                            src.fold_in(distributed.CASCADE_FOLD).fold_in(me))
            outs.append((distributed.gather_state(new, cfg, mesh), aux))
        (gc, ac), (gp, ap) = outs
        if not (torch.equal(gc.c.cpu(), gp.c) and int(ac.cascade_size) ==
                int(ap.cascade_size) and int(ac.waves) == int(ap.waves)):
            raise AssertionError(f"sharded {shape}, card vs CPU, step {k}: "
                                 f"counters, size or waves differ")
        dw = float((gc.w.cpu() - gp.w).abs().max())
        if dw > 64 * torch.finfo(torch.float32).eps * float(gp.w.abs().max()):
            raise AssertionError(f"sharded {shape}, card vs CPU: |dw| {dw}")
        worst = max(worst, dw)
        sizes.append((int(ap.cascade_size), int(ap.waves)))
        dense = state_to_numpy(gp)
        dense["i"] = np.int32(gp.i)
    res["paired"] = {"dw": worst, "sizes": sizes}
    return res


def _nccl_rank(rank, steps):
    """A 1-rank NCCL group: ``TopoMap(backend="sharded")`` on a 1 x 1 mesh
    over it, so that the NCCL path of every collective runs."""
    from repro_torch.api import TopoMap
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.sharding import ShardMesh, rank_device
    device = rank_device("nccl", rank)
    _build.load()
    xtr, _, _, _ = make_dataset("mnist", seed=SEED, device=device)
    mesh = ShardMesh((1, 1), ("data", "model"))
    tm = TopoMap(_sharded_cfg(), backend="sharded",
                 backend_options={"mesh": mesh}, device=device,
                 seed=SEED).fit(xtr, num_steps=steps)
    x = torch.tensor([-0.0, float("nan"), 1e-45], device=device)
    same = torch.equal(mesh.all_gather(x, "model")[0].view(torch.int32),
                       x.view(torch.int32))
    return {"w": tm.state_.w.cpu().numpy(), "calls": mesh.calls,
            "transport": mesh.dist_backend, "gather_bitwise": same}


def sharded_phase(device, xtr, xte):
    """Phase I: the sharded backend on the card. ``TopoMap(backend=
    "sharded")`` on (data 1, model 2) and (data 2, model 2) meshes of gloo
    ranks on the one card, ``SHARDED_STEPS`` steps at B = 16: QE falls, no
    NaN, every counter below theta, every rank's state alike, and
    ``SHARDED_PAIRED`` steps on the card against the CPU. Then a 1 x 1 mesh
    with no process group in this process, and the same fit on a 1 x 1 mesh
    over a 1-rank NCCL group, which must give it bitwise."""
    from repro_torch.api import TopoMap
    from repro_torch.sharding import spawn_ranks
    t_phase = time.perf_counter()
    cfg = _sharded_cfg()
    for shape in ((1, 2), (2, 2)):
        t0 = time.perf_counter()
        res = spawn_ranks(_sharded_rank, shape[0] * shape[1], (shape,),
                          dist_backend="gloo", timeout=RANK_TIMEOUT)
        what = f"sharded {shape[0]}x{shape[1]}"
        first = res[0]
        if not all(np.array_equal(r["w"], first["w"]) for r in res):
            raise AssertionError(f"{what}: the ranks' dense states differ")
        if not (first["finite"] and first["c_max"] < cfg.theta
                and first["qe"] < first["qe0"] and first["waves"] > 0):
            raise AssertionError(f"{what}: {first['qe0']} -> {first['qe']}, "
                                 f"finite {first['finite']}, c max "
                                 f"{first['c_max']}, waves {first['waves']}")
        sec = first["seconds"]
        print(f"{what}: {SHARDED_STEPS} steps at 30x30x784, B=16: "
              f"{SHARDED_STEPS / sec:.2f} steps/s, "
              f"{SHARDED_STEPS * cfg.batch / sec:.1f} samples/s ({sec:.3f} "
              f"s); {first['waves']} waves, {first['size']} firings; "
              f"{first['collectives'] / SHARDED_STEPS:.1f} collectives a "
              f"step on rank 0; QE {first['qe0']:.4f} -> {first['qe']:.4f}; "
              f"card vs CPU, {SHARDED_PAIRED} steps (firings, waves) "
              f"{first['paired']['sizes']}: counters bitwise, max|dw| "
              f"{first['paired']['dw']:.3g}; phase "
              f"{time.perf_counter() - t0:.1f} s with process start")
    one = TopoMap(cfg, backend="sharded", device=device, seed=SEED)
    one.fit(xtr, num_steps=SHARDED_ONE)
    nccl = spawn_ranks(_nccl_rank, 1, (SHARDED_ONE,), dist_backend="nccl",
                       timeout=RANK_TIMEOUT)[0]
    if not (nccl["transport"] == "nccl" and nccl["calls"] > 0
            and nccl["gather_bitwise"]
            and np.array_equal(nccl["w"], one.state_.w.cpu().numpy())):
        raise AssertionError(f"sharded 1x1 over a 1-rank NCCL group: "
                             f"transport {nccl['transport']}, "
                             f"{nccl['calls']} collectives, not bitwise the "
                             f"run without a group")
    print(f"sharded 1x1, {SHARDED_ONE} steps: no process group (QE "
          f"{one.quantization_error(xte):.4f}) and over a 1-rank NCCL group "
          f"({nccl['calls']} NCCL/gloo collectives) bitwise equal")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")


#: phase J (the train-and-serve loop on the mesh, 2 gloo ranks on the card):
#: events of the in-memory and store-backed runs (the latter killed at
#: half), of the exponential-latency runs (killed at half), samples a
#: step, samples a publication
STREAM_MESH_EVENTS = 1024
STREAM_MESH_EXPO = 256
STREAM_MESH_CHUNK = 64
STREAM_MESH_SWAP = 256


def _stream_mesh_rank(rank, root):
    """Phase J on one of 2 gloo ranks on the card: ``run_stream`` with
    ``placement="mesh", shards=2`` at 30x30x784 (seed 0, exact search, a
    ``bmu`` launch on the shard's 450-unit band a sample round), rank 0
    serving 2 client threads of batch 8. In memory at zero latency (the
    phase's main path, its launches counted); then store backed,
    uninterrupted against killed by SIGTERM (its real handler, on every
    rank) at half the events and resumed; then the same at exponential
    latency (delay 0.5). Every run's report and a checksum of this rank's
    dense state; on rank 0 the initial QE and the artifacts compared."""
    import hashlib
    from repro_torch.api import MapStore, TopoMap
    from repro_torch.core import afm
    from repro_torch.data import make_dataset
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels import _build
    from repro_torch.launch.stream_train import run_stream
    device = torch.device("cuda")
    _build.load()
    xtr, _, xte, _ = make_dataset("mnist", seed=SEED, device=device)

    def summary(rep):
        digest = hashlib.sha256()
        for x in (rep.state.w, rep.state.c):
            digest.update(x.detach().cpu().numpy().tobytes())
        return {"events": rep.events, "swaps": rep.swaps,
                "seconds": rep.seconds, "interrupted": rep.interrupted,
                "reads": rep.client_requests,
                "errors": [repr(e) for e in rep.client_errors],
                "dispatches": rep.gateway.dispatches,
                "qe_shape": rep.qe.shape,
                "qe_finite": rep.qe_finite,
                "qe": float(rep.qe.mean()) if rep.qe.size else None,
                "i": rep.state.i, "digest": digest.hexdigest()}

    def opts(**kw):
        return {"placement": "mesh", "shards": 2, "search": "exact", **kw}

    cfg = afm.AFMConfig(side=30, dim=784, i_max=STREAM_MESH_EVENTS)
    common = dict(backend="async", chunk=STREAM_MESH_CHUNK,
                  swap_every=STREAM_MESH_SWAP, clients=2, client_batch=8,
                  name="stream", seed=SEED, device=device)
    res = {}
    if rank == 0:
        init = afm.init(GeneratorDraws.for_step(SEED, 0, device), cfg,
                        xtr[:STREAM_MESH_CHUNK])
        res["qe0"] = TopoMap.from_state(init, cfg, backend="async",
                                        device=device).quantization_error(xte)
    # the main path of the phase: counts set to 0 just before, read after
    _reset_launch_counts()
    mem = run_stream(cfg, xtr, xte, backend_options=opts(),
                     events=STREAM_MESH_EVENTS, **common)
    res["launches"] = _launch_counts()
    res["memory"] = summary(mem)
    for key, n_ev, ekw in (("zero", STREAM_MESH_EVENTS, {}),
                           ("exponential", STREAM_MESH_EXPO,
                            {"latency": "exponential", "delay": 0.5})):
        kcfg = afm.AFMConfig(side=30, dim=784, i_max=n_ev)
        run = dict(common, backend_options=opts(**ekw), events=n_ev)
        a, b, ck = (f"{root}/{key}-{x}" for x in ("a", "b", "ck"))
        full = run_stream(kcfg, xtr, xte, store_root=a, **run)
        cut = run_stream(kcfg, xtr, xte, store_root=b, checkpoint_dir=ck,
                         checkpoint_every=STREAM_MESH_SWAP,
                         die_after=n_ev // 2, **run)
        logs = []
        back = run_stream(kcfg, xtr, xte, store_root=b, checkpoint_dir=ck,
                          resume=True, log=logs.append, **run)
        res[key] = {"full": summary(full), "cut": summary(cut),
                    "back": summary(back),
                    "verified": any("checksum verified" in x for x in logs)}
        if rank == 0:
            arts = [MapStore(r).load_artifact("stream", device="cpu")
                    for r in (a, b)]
            res[key]["same_artifact"] = (
                arts[0].state.i == arts[1].state.i == n_ev
                and torch.equal(arts[0].state.w, arts[1].state.w)
                and torch.equal(arts[0].state.c, arts[1].state.c))
    return res


def stream_mesh_phase(rows):
    """Phase J: the train-and-serve loop on the mesh, 2 gloo ranks on the
    one card (``_stream_mesh_rank``). Every rank's dense state alike after
    every run; rank 0's reads (at least one, no error) and QE (finite,
    below the initial QE); every rank launched ``bmu`` once a sample round
    on its band in the main path, rank 0 also for the gateway's reads;
    the killed-and-resumed runs bitwise the uninterrupted ones, at zero
    and at exponential latency. Returns the phase's kernel rows."""
    import tempfile
    from repro_torch.sharding import spawn_ranks
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn_ranks(_stream_mesh_rank, 2, (tmp,), dist_backend="gloo",
                          timeout=RANK_TIMEOUT)
    first = res[0]
    runs = [("memory", lambda r: r["memory"])] + [
        (f"{k} {x}", lambda r, k=k, x=x: r[k][x])
        for k in ("zero", "exponential") for x in ("full", "cut", "back")]
    for what, get in runs:
        a, b = (get(r) for r in res)
        if a["digest"] != b["digest"] or (a["events"], a["swaps"],
                                          a["seconds"]) != (
                b["events"], b["swaps"], b["seconds"]):
            raise AssertionError(f"stream mesh, {what}: the ranks differ: "
                                 f"{a} / {b}")
        if b["reads"] or b["qe_shape"] != (0,) or a["errors"]:
            raise AssertionError(f"stream mesh, {what}: rank 1 served or "
                                 f"rank 0's clients failed: {a} / {b}")
    mem = first["memory"]
    if not (mem["reads"] >= 1 and mem["qe_finite"]
            and mem["qe"] < first["qe0"] and mem["swaps"] == 4
            and mem["events"] == STREAM_MESH_EVENTS):
        raise AssertionError(f"stream mesh, in memory: {mem}, initial QE "
                             f"{first['qe0']}")
    search = []
    for rank, r in enumerate(res):
        n = r["launches"]
        reads = sum(v for k, v in n.items() if k.startswith("bmu@"))
        search.append(n["bmu"] - reads)
        if n["bmu"] - reads != STREAM_MESH_EVENTS or (rank == 0) != (
                reads > 0):
            raise AssertionError(f"stream mesh, rank {rank}: launched {n} "
                                 f"for {STREAM_MESH_EVENTS} sample rounds")
    for key, n_ev in (("zero", STREAM_MESH_EVENTS),
                      ("exponential", STREAM_MESH_EXPO)):
        r = first[key]
        if not (r["verified"] and r["same_artifact"]
                and r["cut"]["interrupted"] and r["cut"]["events"] == n_ev // 2
                and r["back"]["digest"] == r["full"]["digest"]
                and r["full"]["qe_finite"] and r["back"]["qe_finite"]):
            raise AssertionError(f"stream mesh, {key}: the resumed run is "
                                 f"not the uninterrupted one: {r}")
    n = first["launches"]
    buckets = {k: v for k, v in n.items() if k.startswith("bmu@")}
    print(f"stream mesh (in memory, 2 ranks): {mem['events']} events at "
          f"30x30x784, exact search, zero latency: "
          f"{mem['events'] / mem['seconds']:.1f} events/s "
          f"({mem['seconds']:.3f} s), {mem['swaps']} swaps, {mem['reads']} "
          f"client reads, {mem['dispatches']} coalesced dispatches; QE "
          f"{first['qe0']:.4f} -> {mem['qe']:.4f}; bmu launches on rank 0 "
          f"{n['bmu']} ({search[0]} shard searches, reads {buckets}), on "
          f"rank 1 {res[1]['launches']['bmu']} ({search[1]} shard searches)")
    for key, n_ev in (("zero", STREAM_MESH_EVENTS),
                      ("exponential", STREAM_MESH_EXPO)):
        r = first[key]
        rest = r["back"]["events"] - r["cut"]["events"]
        print(f"stream mesh (store backed, {key} latency): {n_ev} events, "
              f"uninterrupted {n_ev / r['full']['seconds']:.1f} events/s, "
              f"{r['full']['reads']} reads; killed by SIGTERM at "
              f"{r['cut']['events']} and resumed ({rest} events at "
              f"{rest / r['back']['seconds']:.1f} events/s): final artifact "
              f"bitwise the uninterrupted run's")
    print(f"stream mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return [
        _row_as(rows, "bmu (mesh shard search, B=1, N=450)",
                "bmu (mesh stream shard search, B=1, N=450)", search[0]),
        _row_as(rows, "bmu (training search, B=16)",
                "bmu (mesh stream reads on rank 0, bucket 64: 9..16 "
                "coalesced samples)", n.get("bmu@64", 0))]


def _row_as(rows, prefix, name, launches):
    """A kernel row measured above at the same shape, under this phase's
    name and launches."""
    row = next(r for r in rows if r["name"].startswith(prefix))
    return {**row, "name": name, "launches": launches}


#: phase K: the SOM's samples, at B = 16 (500 steps, the AFM main path's
#: budget) and at B = 1 (8,000 steps, the faithful online SOM): the paper's
#: 600 N samples cut in depth only. They are also the SOM's ``i_max``, so
#: its schedules (lr 0.5 -> 0.01, sigma 15 -> 1) run their course, as
#: ``som.train``'s default step count is ``i_max // B``. Then the steps
#: held to the plain step, and the profiled window.
SOM_SAMPLES, SOM_PAIRED, SOM_PROFILED = 8000, 50, 50
#: the QE of the test samples must fall by more than this share, as
#: ``tests/test_afm.py`` asks of JAX's SOM
SOM_QE_DROP = 0.3


def _som_paired(device, xtr, cfg, steps):
    """``steps`` SOM steps from the seed's initial state on the same index
    draws as the timed run's first steps: each step's ``bmu`` kernel BMUs
    against ``bmu_ref``'s on the same card (within the tie bound), and the
    kernel step's weights bitwise the plain step's (``som.update`` on
    ``bmu_ref``'s BMUs) wherever the BMUs agree; the next step starts from
    the kernel step's state. Returns (max |dq2|, steps with a tie flip)."""
    from repro_torch.core import som
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.bmu import ref as bmu_ref
    draws = GeneratorDraws(SEED, device)
    state = som.init(draws, cfg, xtr, device=device)
    worst, flips = 0.0, 0
    for k in range(steps):
        s = xtr[draws.randint(0, xtr.shape[0], (cfg.batch,))]
        err, idx = check_bmu(state.w, s, "exact", f"(SOM step {k}, "
                             f"B={cfg.batch})", quiet=True)
        worst = max(worst, err)
        idx_r, _ = bmu_ref.bmu_ref(state.w, s)
        new = som.train_step(state, s, cfg)
        if torch.equal(idx, idx_r):
            plain = som.update(state, s, idx_r, cfg)
            if not torch.equal(new.w.view(torch.int32),
                               plain.w.view(torch.int32)):
                raise AssertionError(f"SOM step {k}, B={cfg.batch}: the "
                                     f"kernel step's weights differ from "
                                     f"the plain step's on the same BMUs")
        else:
            flips += 1
        state = new
    return worst, flips


def _som_run(device, xtr, cfg, steps):
    """The timed SOM run from the seed: ``som.init`` then ``som.train``
    for ``steps`` steps under ``set_sync_debug_mode("error")`` (any host
    sync raises), with the launch counts of the run alone. Returns (state,
    initial state, launches, samples/s)."""
    from repro_torch.core import som
    from repro_torch.draws import GeneratorDraws
    draws = GeneratorDraws(SEED, device)
    state0 = som.init(draws, cfg, xtr, device=device)
    som.train(state0, xtr, GeneratorDraws(SEED + 1, device), cfg,
              num_steps=3, device=device)       # warm the path
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = som.train(state0, xtr, draws, cfg, num_steps=steps,
                          device=device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    others = {k: v for k, v in launches.items() if v and k != "bmu"}
    if launches["bmu"] != steps or others:
        raise AssertionError(f"SOM run, B={cfg.batch}: launched {launches} "
                             f"for {steps} steps: bmu must run once a step, "
                             f"nothing else")
    return state, state0, launches, steps * cfg.batch / seconds


def som_phase(device, xtr, ytr, xte, yte, afm_acc, rows):
    """Phase K (a, b): the SOM baseline (``repro_torch.core.som``) at
    30x30x784 on the mnist stand-in, seed 0, 8,000 samples (``i_max``):
    500 steps at B = 16 and 8,000 at B = 1, each one ``bmu`` launch a step
    and no host sync (the run
    under ``set_sync_debug_mode("error")``); 50 steps of each held to the
    plain step on the card; the QE of the 10,000 test samples before and
    after (it must fall by more than ``SOM_QE_DROP``); the accuracy beside
    the AFM main path's. Returns the phase's kernel rows."""
    from repro_torch.core import classifier, som
    from repro_torch.draws import GeneratorDraws
    t_phase = time.perf_counter()
    out = []
    for batch, prefix in ((16, "bmu (training search, B=16)"),
                          (1, "bmu (async search, B=1)")):
        cfg = som.SOMConfig(side=30, dim=784, batch=batch,
                            i_max=SOM_SAMPLES)
        steps = cfg.total_samples // batch
        state, state0, launches, rate = _som_run(device, xtr, cfg, steps)
        worst, flips = _som_paired(device, xtr, cfg, SOM_PAIRED)
        qe0 = float(som.quantization_error(state0, xte))
        qe = float(som.quantization_error(state, xte))
        if not (np.isfinite(qe) and qe < (1 - SOM_QE_DROP) * qe0):
            raise AssertionError(f"SOM, B={batch}: QE {qe0} -> {qe} did not "
                                 f"fall by more than {SOM_QE_DROP:.0%}")
        labels = classifier.label_units(state.w, xtr, ytr)
        acc = float((som.predict(state, labels, xte) == yte).float().mean())
        n_launch, syncs, wall = _profile_counts(lambda: som.train(
            state, xtr, GeneratorDraws(SEED + 3, device), cfg,
            num_steps=SOM_PROFILED, device=device))
        print(f"SOM (B={batch}): {steps} steps at 30x30x784 on "
              f"{tuple(xtr.shape)}: {rate:.1f} samples/s "
              f"({steps * batch / rate:.3f} s); bmu launches "
              f"{launches['bmu']} ({launches['bmu'] / steps:.2f} a step), "
              f"host syncs a step 0 (set_sync_debug_mode('error') over the "
              f"run); profiled {SOM_PROFILED} steps: "
              f"{n_launch / SOM_PROFILED:.2f} kernel launches and "
              f"{syncs / SOM_PROFILED:.2f} host syncs a step, "
              f"{wall / SOM_PROFILED * 1e3:.4f} ms a step")
        print(f"SOM (B={batch}): QE of the test samples {qe0:.4f} -> "
              f"{qe:.4f} ({100 * (1 - qe / qe0):.1f} % lower); accuracy "
              f"{acc:.4f} (the AFM main path's, staged, B=16, "
              f"{STEPS} steps: {afm_acc:.4f}); {SOM_PAIRED} steps held to "
              f"the plain step on the card: max|dq2| {worst:.3g}, weights "
              f"bitwise on the same BMUs, {flips} step(s) with a BMU tie "
              f"flip")
        out.append({**_row_as(rows, prefix,
                              f"bmu (SOM train step, B={batch})",
                              launches["bmu"]), "max_abs_err": worst})
    print(f"SOM phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _example_main(name, argv):
    """Run an example's ``main(argv)`` in this process; returns what it
    printed (also echoed)."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return text


def examples_phase():
    """Phase K (c): both port examples on the card at their default sizes,
    their tables printed and parsed."""
    import re
    t0 = time.perf_counter()
    quick = _example_main("quickstart_torch", [])
    found = re.search(r"acc=([0-9.]+) precision=([0-9.]+) recall=([0-9.]+)",
                      quick)
    if "device=cuda" not in quick or found is None or not (
            float(found.group(1)) > 0.5):
        raise AssertionError(f"quickstart_torch on the card: {quick!r}")
    t1 = time.perf_counter()
    table = _example_main("classify_datasets_torch", [])
    rows = [line.split() for line in table.strip().splitlines()[1:]]
    if [r[0] for r in rows] != ["satimage", "letters"] or not all(
            len(r) == 5 and all(0.0 < float(x) <= 1.0 for x in r[1:])
            for r in rows):
        raise AssertionError(f"classify_datasets_torch on the card: "
                             f"{table!r}")
    print(f"examples on the card: quickstart_torch {t1 - t0:.1f} s, "
          f"classify_datasets_torch {time.perf_counter() - t1:.1f} s")


def lint_phase():
    """Phase K (d): ``python -m repro_torch.launch.lint --no-ruff`` over
    the tree exits 0; prints its count of baselined findings."""
    import os
    import re
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--no-ruff"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    found = re.search(r"clean \(([0-9]+) baselined finding", out.stdout)
    if out.returncode != 0 or found is None:
        raise AssertionError(f"lint: exit {out.returncode}: {out.stdout}"
                             f"{out.stderr}")
    print(f"lint (python -m repro_torch.launch.lint --no-ruff): exit 0, "
          f"{found.group(1)} baselined findings")


LM_ARCH = "llama3.2-1b"
#: tolerances of the swa kernel against its plain version on the same card:
#: f32 within 2e-4 relative and absolute (the sums run in another order);
#: bf16 within one bf16 ulp of the output plus 1e-3 (both round an f32
#: result to bf16 once)
SWA_F32_TOL = 2e-4
BF16_ULP = 2.0 ** -7
#: card vs CPU logits of the f32 smoke model: within 2e-4 (1 + max|logit|)
#: (matrix products sum in another order on the card)
LOGIT_TOL = 2e-4
#: (label, B, H, Hkv, hd, W, first pos; rows step by 21 positions):
#: llama3.2-1b's long_500k decode shape at pos 0, 5, 8191 and 70,000, its
#: serve shape (pos 128-191), the shapes of tests/test_kernels.py, rep 3
#: and rep 1 over ragged caches, and hd 32 (the MoE configs' smoke widths)
#: on one split and on several
SWA_CASES = [("long_500k", 1, 32, 8, 64, 8192, p)
             for p in (0, 5, 8191, 70_000)] + [
    ("serve", 4, 32, 8, 64, 192, 128),
    ("ragged", 2, 8, 2, 64, 512, 100), ("ragged", 1, 4, 1, 128, 1024, 70_000),
    ("ragged", 3, 16, 8, 64, 256, 255), ("ragged", 2, 4, 4, 128, 128, 4),
    ("ragged", 2, 6, 2, 128, 96, 60), ("ragged", 2, 3, 3, 64, 100, 120),
    ("ragged", 2, 4, 2, 32, 40, 20), ("ragged", 1, 8, 2, 32, 1024, 700)]


def swa_inputs(gen, b, h, hkv, hd, w, pos0, dtype, device):
    """Random q, k, v (drawn on the CPU) and positions pos0 + 21 i."""
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for shape in ((b, h, hd), (b, w, hkv, hd), (b, w, hkv, hd)))
    pos = (pos0 + 21 * torch.arange(b, dtype=torch.int32)).to(device)
    return q, k, v, pos


def swa_error(out, ref, what):
    """Max |kernel - plain|; raises beyond the stated tolerance."""
    f32 = out.dtype == torch.float32
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"swa_decode {what}: non-finite output")
    err = (out - ref).abs()
    bound = (SWA_F32_TOL * (1 + ref.abs()) if f32
             else BF16_ULP * ref.abs() + 1e-3)
    if not bool((err <= bound).all()):
        raise AssertionError(f"swa_decode {what}: off by {float(err.max())}")
    return float(err.max())


def check_swa_kernel(device):
    """Phase 8: the decode-attention kernel against its plain version on the
    card, same inputs, f32 and bf16. Returns the worst bf16 error per
    shape label."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    gen = torch.Generator().manual_seed(SEED + 13)
    worst = {}
    for label, b, h, hkv, hd, w, pos0 in SWA_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pos = swa_inputs(gen, b, h, hkv, hd, w, pos0, dtype,
                                      device)
            out = swa_ops.swa_decode(q, k, v, pos)
            ref = swa_ref.swa_decode_ref(q, k, v, pos, window=w)
            if not torch.equal(out, swa_ops.swa_decode(q, k, v, pos)):
                raise AssertionError(f"swa_decode {label}: two calls differ")
            torch.cuda.synchronize()
            what = (f"{label} B={b} H={h} Hkv={hkv} hd={hd} W={w} "
                    f"pos={pos.tolist()} {dtype}")
            err = swa_error(out, ref, what)
            if dtype == torch.bfloat16:
                worst[label] = max(worst.get(label, 0.0), err)
            print(f"swa_decode {what}: max|d| {err:.3g}")
    return worst


def swa_per_step(cfg) -> int:
    """``swa_decode`` calls of one decode step under ``cfg``'s plan: one an
    attention layer (all but the SSD and RG-LRU layers; the audio encoder's
    run in the prefill alone), and one more a decoder layer with
    cross-attention."""
    from repro_torch.models import transformer
    stacks, tail = transformer._layer_plan(cfg)
    return sum(count * (1 + cross)
               for name, kind, count, cross in stacks + tail
               if kind not in ("ssm", "rglru")
               and name != transformer.ENCODER)


def teacher_forced_logits(model, cfg, prompt, tokens, cache_len, extra=None):
    """Logits of prefill (``extra`` joining the prompt in its batch) and then
    decode steps fed ``tokens`` (another run's choices), (B, new, V)."""
    from repro_torch.models import transformer
    b, s = prompt.shape
    last, cache = transformer.prefill(model, {"tokens": prompt,
                                              **(extra or {})}, cfg,
                                      cache_len=cache_len)
    out = [last]
    pos = torch.full((b,), s, dtype=torch.int32, device=prompt.device)
    for i in range(tokens.shape[1] - 1):
        logits, cache = transformer.decode_step(model, tokens[:, i:i + 1],
                                                pos, cache, cfg)
        out.append(logits)
        pos = pos + 1
    return torch.stack(out, dim=1)


def decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, new, cache_len,
                       what, extra=None):
    """Greedy generation of ``new`` tokens on the card (decode attention on
    the kernel, ``swa_per_step`` launches a step) and on the CPU (plain
    version) from the same weights, prompt and ``extra`` (the audio
    family's frames, on the CPU): the card's logits teacher-forced on the
    CPU's tokens within LOGIT_TOL; free-running tokens equal, except where
    the CPU's top two logits lie within it."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.serving import serve_step
    device = next(gpu_model.parameters()).device
    extra_g = {k: v.to(device) for k, v in (extra or {}).items()}
    toks_c, logits_c = serve_step.generate(cpu_model, cfg, prompt, new,
                                           cache_len, extra_batch=extra,
                                           return_logits=True)
    before = swa_ops.launches
    toks_g = serve_step.generate(gpu_model, cfg, prompt.to(device), new,
                                 cache_len, extra_batch=extra_g).cpu()
    if swa_ops.launches - before != swa_per_step(cfg) * (new - 1):
        raise AssertionError(f"{what}: swa_decode launched "
                             f"{swa_ops.launches - before} times")
    forced = teacher_forced_logits(gpu_model, cfg, prompt.to(device),
                                   toks_c.to(device), cache_len,
                                   extra_g).cpu()
    tol = LOGIT_TOL * (1 + float(logits_c.abs().max()))
    err = float((forced - logits_c).abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: card logits off by {err} > {tol}")
    ties = 0
    for row in range(toks_c.shape[0]):
        differ = (toks_g[row] != toks_c[row]).nonzero()
        if len(differ):
            top2 = logits_c[row, int(differ[0])].topk(2).values
            if float(top2[0] - top2[1]) > tol:
                raise AssertionError(f"{what}: tokens differ away from a "
                                     f"tie, row {row}")
            ties += 1
    print(f"{what}, prompt {prompt.shape[1]}, cache {cache_len}, {new} "
          f"tokens: teacher-forced logits max|d| {err:.3g} <= {tol:.3g}; "
          f"free-running tokens equal"
          f"{f' up to {ties} near ties' if ties else ''}")


def check_decode_card_vs_cpu(device):
    """Phase 9: ``decode_card_vs_cpu`` at the f32 smoke width: a linear
    cache, and a window-16 ring that the prompt has wrapped."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import transformer
    base = configs.get_smoke(LM_ARCH)
    cpu_model = transformer.init_params(base, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    for window, prompt_len, cache_len in ((0, 24, 40), (16, 40, 16)):
        cfg = dataclasses.replace(base, window=window)
        prompt = prompts_for(cfg, 2, prompt_len, SEED, "cpu")
        decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, cache_len,
                           f"decode card vs CPU, smoke width, window "
                           f"{window}")


def _serve_run(serve, model, cfg, prompts, new, cache_len, what,
               extra=None):
    """One timed ``serve.run`` with the launch counts reset just before."""
    _reset_launch_counts()
    torch.cuda.synchronize()
    out = serve.run(model, cfg, prompts, max_new=new, cache_len=cache_len,
                    extra_batch=extra, return_logits=True)
    counts = _launch_counts()
    expect = swa_per_step(cfg) * (new - 1)
    if counts["swa_decode"] != expect:
        raise AssertionError(f"{what}: swa_decode launched "
                             f"{counts['swa_decode']} times, not {expect}")
    tokens, logits = out["tokens"], out["logits"]
    if tokens.shape != (prompts.shape[0], new) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{what}: tokens out of shape or range")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: non-finite logits")
    print(f"{what}: prefill {out['prefill_ms']:.3f} ms, decode "
          f"{out['decode_ms_per_step']:.4f} ms/step, decode "
          f"{out['decode_tok_s']:.1f} tok/s, all new tokens "
          f"{out['tok_s']:.1f} tok/s; launches {counts}")
    return {**out, "launches": counts}


def serve_full_width(device, worst):
    """Phase 10: llama3.2-1b at full width, bf16, seeded weights, through
    ``launch/serve.py``'s ``run``: B 4 x 128 + 64 tokens on a linear cache,
    then B 1 at long_500k (8,704-token chunked prefill, 64 tokens on the
    8,192-slot ring). Each run is warmed up first. The kernel is checked
    against its plain version on the layer-0 cache of the long prefill,
    whose K/V of every layer it returns for the timing of phase 11."""
    from repro_torch import configs
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get(LM_ARCH)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {n / 1e9:.4f} B parameters, {nbytes / 1e9:.3f} GB, "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s")
    runs = {}
    prompts = serve.prompts_for(cfg, 4, 128, SEED, device)
    serve.run(model, cfg, prompts, max_new=4, cache_len=192)      # warm-up
    runs["serve"] = _serve_run(serve, model, cfg, prompts, 64, 192,
                               "serve B=4 x 128 + 64, linear cache 192")

    long_cfg = dataclasses.replace(configs.for_shape(cfg, "long_500k"),
                                   attention_impl="chunked")
    w = configs.cache_len_for(long_cfg, "long_500k")
    prompt = serve.prompts_for(cfg, 1, w + 512, SEED + 1, device)
    # warm-up: the prefill alone and one decode step; its layer-0 cache, in
    # which the ring has wrapped, checks the kernel on real K/V
    last, cache = transformer.prefill(model, {"tokens": prompt}, long_cfg,
                                      cache_len=w)
    k_all, v_all = cache["blocks"]["k"], cache["blocks"]["v"]
    k0, v0 = k_all[0], v_all[0]
    pos = torch.full((1,), w + 511, dtype=torch.int32, device=device)
    gen = torch.Generator().manual_seed(SEED + 17)
    q = torch.randn(1, cfg.num_heads, cfg.hd, generator=gen).to(device,
                                                                cfg.dtype)
    err = swa_error(swa_ops.swa_decode(q, k0, v0, pos),
                    swa_ref.swa_decode_ref(q, k0, v0, pos, window=w),
                    f"layer-0 cache after the long prefill {cfg.dtype}")
    worst["long_500k"] = max(worst.get("long_500k", 0.0), err)
    print(f"swa_decode on the layer-0 cache after the {w + 512}-token "
          f"prefill (ring of {w}, pos {w + 511}): max|d| {err:.3g}")
    long_inputs = [(q, k_all[i].clone(), v_all[i].clone(), pos)
                   for i in range(cfg.num_layers)]
    transformer.decode_step(model, last.argmax(-1)[:, None], pos + 1, cache,
                            long_cfg)
    del cache, last, k_all, v_all, k0, v0
    runs["long"] = _serve_run(serve, model, long_cfg, prompt, 64, w,
                              f"long_500k B=1 x {w + 512} + 64, ring {w}")
    del model
    torch.cuda.empty_cache()
    return runs, long_inputs


def swa_rows(device, runs, worst, long_inputs):
    """Phase 11: the kernel's time at both serve shapes beside its plain
    version, ``scaled_dot_product_attention`` (boolean ring mask, GQA) and
    its bound (bytes: the valid K/V rows, q and the output, once each).
    Each is timed queued ahead of the card (device time, not the rate of
    the Python wrapper). At the long_500k shape the calls cycle through the
    16 layers' caches of the long prefill (269 MB), so K/V come from device
    memory and not from L2, as in a decode step; the serve shape's caches
    are random."""
    gen = torch.Generator().manual_seed(SEED + 19)
    serve_inputs = [swa_inputs(gen, 4, 32, 8, 64, 192, 128, torch.bfloat16,
                               device)]
    return [swa_row(device, shape, inputs, run["launches"]["swa_decode"],
                    worst[shape])
            for shape, run, inputs in (("serve", runs["serve"], serve_inputs),
                                       ("long_500k", runs["long"],
                                        long_inputs))]


def swa_row(device, shape, inputs, launches, max_err, masked=True):
    """The kernel table's row of ``swa_decode`` at one decode shape:
    ``inputs`` a list of (q, k, v, pos) cycled through by the timed calls;
    ``launches`` from the shape's serve run. The library call is SDPA with
    the ring's boolean mask, or with none when not ``masked`` (a
    cross-attention, where every slot is valid)."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    q, k, v, pos = inputs[0]
    (b, h, hd), (w, hkv) = q.shape, k.shape[1:3]
    label = (f"{shape} B={b}, H={h}, Hkv={hkv}, hd={hd}, W={w}, pos "
             f"{int(pos.min())}-{int(pos.max())}")
    plan = swa_ops.plan(b, hkv, w, sm_count(q.device))
    print(f"swa_decode {label}: plan grid ({plan.splits}, {hkv}, {b}), "
          f"{plan.splits} split(s) of {plan.slots} slots"
          f"{', combined by the last block of each' if plan.splits > 1 else ''}"
          f"; {'tensor cores' if q.dtype == torch.bfloat16 else 'SIMT'}")
    posl = pos.long()[:, None]
    j = torch.arange(w, device=device)[None, :]
    valid = torch.remainder(posl - j, w) < torch.clamp(posl + 1, max=w)
    mask = valid[:, None, None, :] if masked else None
    if not masked and not bool(valid.all()):
        raise AssertionError(f"swa_decode {label}: an unmasked row with "
                             f"invalid slots")

    def library(q, k, v, pos):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    def plain(q, k, v, pos):
        return swa_ref.swa_decode_ref(q, k, v, pos, window=w)

    def cycling(fn):
        turn = itertools.cycle(inputs)
        return lambda: fn(*next(turn))

    lib_err = float((library(q, k, v, pos).float()
                     - swa_ops.swa_decode(q, k, v, pos).float())
                    .abs().max())
    t = time_both({"plain": cycling(plain),
                   "kernel": cycling(swa_ops.swa_decode),
                   "library": cycling(library)}, 32,
                  f"swa_decode {shape}")
    n_valid = int(valid.sum())
    nbytes = (2 * n_valid * hkv * hd + 2 * b * h * hd) * q.element_size()
    flops = 4 * n_valid * h * hd
    bound = max(nbytes / bw, flops / f32_peak) * 1e3
    print(f"swa_decode {label}: kernel {t['kernel']:.5f} ms, plain "
          f"{t['plain']:.5f} ms, sdpa {t['library']:.5f} ms (max|d| from "
          f"the kernel {lib_err:.3g}), bound {bound:.5f} ms "
          f"({nbytes / 1e6:.3f} MB), {len(inputs)} caches in turn")
    return {
        "name": f"swa_decode ({label})", "route": "cuda",
        "source": "src/repro_torch/kernels/swa/swa.cu",
        "replaces": "src/repro/kernels/swa/swa.py:28",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > flops / f32_peak
        else "operations",
        "library_ms": t["library"]}


#: phase L: LM training with the AFM probe. The full-width run is
#: llama3.2-1b at its published geometry (configs.get), bf16, B 4 x S 1,024
#: (the JAX package's train_4k shape, batch 256 x seq 4,096, cut in depth),
#: 30 steps, an 8x8 probe map on the 2,048-d pooled hidden states; then 10
#: steps of the optimised config (chunked attention, chunked CE)
TRAIN_ARCH = "llama3.2-1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_OPT_STEPS = 4, 1024, 30, 10
#: the full-width runs' learning rate: AdamWConfig's default, not the
#: launcher's 1e-3, under which this 1.2 B-parameter model's loss spikes
#: (to 12.79 at step 9 in one run) and its first and last five steps'
#: means land within the batches' noise of each other (PERF.md)
TRAIN_LR = 3e-4
TRAIN_PROBE_SIDE = 8
#: steps of the smoke-width card-vs-CPU check (probe side 6), and its batch
TRAIN_PAIRED, TRAIN_PAIRED_B, TRAIN_PAIRED_S = 3, 4, 64
#: steps of the profiled window after the full-width run, and probe
#: updates of the probe's own window
TRAIN_PROFILED, PROBE_PROFILED = 2, 30
#: card vs CPU: loss, ce, lr and grad_norm within this share (the CPU
#: tests' tolerance against JAX)
TRAIN_TOL = 1e-5
#: dense bf16 tensor-core peaks (NVIDIA data sheets, at the full power
#: limit)
BF16_PEAKS = {"SXM": 989e12, "PCIe": 756e12}


def _probe_draw_lists(seed, side, waves=64):
    """One step's cascade draws as numbers, laid out for both stage sets:
    the plain stages' (the drive, one ``(4, side, side)`` a wave) and the
    kernel stages' (the drive, the first 16 waves as one block, one a later
    wave), the same numbers on both devices. ``waves`` outlasts any
    cascade here (a replay that ran out would raise)."""
    from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP as cap
    gen = torch.Generator().manual_seed(seed)
    drive = torch.rand(8, side, side, generator=gen).numpy()
    per_wave = [torch.rand(4, side, side, generator=gen).numpy()
                for _ in range(waves)]
    return [drive, *per_wave], [drive, np.stack(per_wave[:cap]),
                                *per_wave[cap:]]


def _train_state_to(state, device):
    """A copy of a train state on ``device``: weights (trainable), f32
    moments, step, probe map (if any)."""
    from repro_torch.core import probe
    from repro_torch.training import adamw
    model = copy.deepcopy(state.params).to(device)
    opt = adamw.AdamWState(
        {k: v.to(device) for k, v in state.opt.mu.items()},
        {k: v.to(device) for k, v in state.opt.nu.items()},
        state.opt.step.to(device))
    if state.probe is None:
        return type(state)(model, opt, state.step.to(device))
    a = state.probe.afm
    return type(state)(model, opt, state.step.to(device), probe.ProbeState(
        a._replace(w=a.w.to(device), c=a.c.to(device), far=a.far.to(device),
                   near=a.near.to(device))))


def _pooled(state, batch, cfg):
    """The probe's vectors for ``batch``: the step's hidden states,
    mean-pooled, computed outside the step (no grad)."""
    from repro_torch.core import probe
    from repro_torch.training import train_step
    with torch.no_grad():
        hidden = train_step.lm_loss(state.params, batch, cfg,
                                    return_hidden=True)[3]
    return probe.pool_hidden(hidden.float())


def train_card_vs_cpu(device):
    """Phase L (a): ``TRAIN_PAIRED`` smoke-width train steps (f32) with a
    side-6 probe, each from the CPU run's state copied to the card, on the
    same token batch and one list of draw numbers (the plain stages' layout
    on the CPU, the kernel stages' on the card): loss, ce, lr and grad_norm
    within ``TRAIN_TOL``; the probe's GMUs within the tie bound, and where
    they agree its counters and cascade size bitwise and its weights
    within the vectors' difference. Returns the steps' cascade sizes."""
    from repro_torch import configs
    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import ReplayDraws
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.training import AdamWConfig, train_step
    cfg = configs.get_smoke(TRAIN_ARCH)
    pcfg = probe.ProbeConfig(side=6, dim=cfg.d_model, i_max=400, c_m=1.0)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_PAIRED),
        pcfg)
    state = train_step.init_train_state(cfg, pcfg, seed=SEED, device="cpu")
    a = state.probe.afm                     # counters one below threshold
    state = state._replace(probe=probe.ProbeState(
        a._replace(c=torch.full_like(a.c, pcfg.theta - 1))))
    data = tokens.batches(torch.Generator().manual_seed(SEED + 1),
                          cfg.vocab_size, TRAIN_PAIRED_B, TRAIN_PAIRED_S,
                          TRAIN_PAIRED, device="cpu")
    sizes = []
    for k, batch in enumerate(data):
        card = _train_state_to(state, device)
        gbatch = {n: v.to(device) for n, v in batch.items()}
        cpu_draws, card_draws = _probe_draw_lists(SEED + 40 + k, pcfg.side)
        vecs, gvecs = _pooled(state, batch, cfg), _pooled(card, gbatch, cfg)
        w0 = state.probe.afm.w
        gmu = bmu_ref.bmu_ref(w0, vecs)[0]
        ggmu = bmu_ops.bmu(card.probe.afm.w, gvecs)[0].cpu()
        state, m = step(state, batch, ReplayDraws(cpu_draws))
        card, mg = step(card, gbatch, ReplayDraws(card_draws, device=device))
        errs = {}
        for key in ("loss", "ce", "lr", "grad_norm"):
            want, got = float(m[key]), float(mg[key])
            errs[key] = abs(got - want) / abs(want)
            if not errs[key] <= TRAIN_TOL:
                raise AssertionError(f"train step {k} card vs CPU: {key} "
                                     f"{got} against {want}")
        vec_err = float((gvecs.cpu() - vecs).abs().max())
        differ = ggmu != gmu
        if bool(differ.any()):
            gap = bmu_ref.top2_gap(w0, vecs)[differ]
            bound = bmu_ref.tie_bound(w0, vecs)[differ] + 4 * vec_err
            if not bool((gap <= bound).all()):
                raise AssertionError(f"train step {k} card vs CPU: the "
                                     f"probe's GMUs differ away from ties")
            print(f"train step {k} card vs CPU: probe GMUs differ at a near "
                  f"tie; state not compared")
            continue
        size = int(m["probe_cascade"])
        dw = float((card.probe.afm.w.cpu() - state.probe.afm.w).abs().max())
        bound = vec_err + 64 * torch.finfo(torch.float32).eps * float(
            state.probe.afm.w.abs().max())
        if (int(mg["probe_cascade"]) != size
                or not torch.equal(card.probe.afm.c.cpu(), state.probe.afm.c)
                or not dw <= bound):
            raise AssertionError(f"train step {k} card vs CPU: the probe's "
                                 f"state differs (cascade {size} / "
                                 f"{int(mg['probe_cascade'])}, |dw| {dw})")
        sizes.append(size)
        print(f"train step {k} card vs CPU, smoke width (f32, B "
              f"{TRAIN_PAIRED_B} x S {TRAIN_PAIRED_S}), probe side 6: "
              + ", ".join(f"{key} rel {e:.3g}" for key, e in errs.items())
              + f" (<= {TRAIN_TOL}); probe GMUs equal, cascade {size} and "
              f"counters bitwise, max|dw| {dw:.3g} <= {bound:.3g}")
    if not any(sizes):
        raise AssertionError("train steps card vs CPU: no probe cascade "
                             "fired, so the cascade was not compared")
    return sizes


def probe_kernel_checks(device, arch=TRAIN_ARCH):
    """Phase L (b): the probe's kernels at its full-width shape (side 8,
    D = 2,048, B = 4): ``bmu`` at N = 64 under the tie-bound contract and
    bitwise on a second call; ``drive_cascade`` at side 8 bitwise against
    its plain version on the integers and on w, budgets 16, 3 and 0, from a
    p = 0.9 drive; then the probe's kernel stages against the plain stages
    on the same card and draw numbers from counters one below threshold
    (GMUs within the tie bound; where they agree counters, size and waves
    bitwise, w within 8 ulp an adaptation; one ``bmu`` call and one
    ``drive_cascade`` launch a step). Returns the worst errors and the
    timing inputs."""
    from repro_torch.core import afm, probe
    from repro_torch.draws import GeneratorDraws, ReplayDraws
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    from repro_torch import configs
    side, d, b = TRAIN_PROBE_SIDE, configs.get(arch).d_model, TRAIN_B
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    w = 0.1 * torch.randn(side * side, d, generator=gen, device=device)
    s = 0.5 * torch.randn(b, d, generator=gen, device=device)
    err, _ = check_bmu(w, s, "exact", f"(probe search) B={b} N={side * side}"
                       f" D={d}")
    if not all(torch.equal(x, y) for x, y in zip(bmu_ops.bmu(w, s),
                                                 bmu_ops.bmu(w, s))):
        raise AssertionError("bmu (probe search): two calls differ")
    args = drive_inputs(torch.Generator().manual_seed(SEED + 29), side, d,
                        cas_ops.DEFAULT_WAVE_CAP, device)
    drive_waves = 0
    for budget in (cas_ops.DEFAULT_WAVE_CAP, 3, 0):
        kw = dict(l_c=0.3, theta=4, budget=budget)
        out = cas_ops.drive_cascade(*args, **kw)
        ref = cas_ref.drive_cascade_ref(*args, **kw)
        again = cas_ops.drive_cascade(*args, **kw)
        torch.cuda.synchronize()
        for x, r, y in zip(out, ref, again):
            same = (torch.equal(x.view(torch.int32), r.view(torch.int32))
                    if x.is_floating_point() else torch.equal(x, r))
            if not (same and torch.equal(x, y)):
                raise AssertionError(f"drive_cascade (probe) side {side} "
                                     f"D={d} budget {budget}: not bitwise")
        size, waves = out[3].tolist()
        if budget and not waves:
            raise AssertionError(f"drive_cascade (probe) side {side}: no "
                                 f"wave")
        if budget == cas_ops.DEFAULT_WAVE_CAP:
            drive_waves = waves
        print(f"drive_cascade (probe) side {side} D={d} budget {budget}: "
              f"{size} firings in {waves} waves; bitwise equal to the plain "
              f"version, and two calls bitwise equal")
    pcfg = probe.ProbeConfig(side=side, dim=d, i_max=120, c_m=1.0)
    cfg = pcfg.afm_config()
    compared = 0
    for seed in range(3):
        st = probe.init(GeneratorDraws(SEED + seed, device), pcfg,
                        device=device).afm
        st = st._replace(c=torch.full_like(st.c, pcfg.theta - 1), i=8)
        vecs = 0.5 * torch.randn(b, d, generator=torch.Generator(
            device=device).manual_seed(SEED + 100 + seed), device=device)
        plain, kernel = _probe_draw_lists(SEED + 50 + seed, side)
        before = bmu_ops.launches, cas_ops.drive_launches
        new_k, aux_k = probe.update(probe.ProbeState(st), vecs,
                                    ReplayDraws(kernel, device=device), pcfg)
        if (bmu_ops.launches - before[0],
                cas_ops.drive_launches - before[1]) != (1, 1):
            raise AssertionError("probe step: not one bmu call and one "
                                 "drive_cascade launch")
        new_p, aux_p = afm.train_step_batch(
            st, vecs, ReplayDraws(plain, device=device), cfg,
            stages=afm.EXACT_STAGES)
        if not torch.equal(aux_k.gmu, aux_p.gmu):
            check_bmu(st.w, vecs, "exact", "(probe stage)", quiet=True)
            continue
        waves = int(aux_p.waves)
        dw = float((new_k.afm.w - new_p.w).abs().max())
        bound = (8 * (1 + waves) * torch.finfo(torch.float32).eps
                 * float(new_p.w.abs().max()))
        if ((int(aux_k.cascade_size), int(aux_k.waves))
                != (int(aux_p.cascade_size), waves)
                or not torch.equal(new_k.afm.c, new_p.c) or not dw <= bound):
            raise AssertionError(f"probe stages seed {seed}: the kernel "
                                 f"stages differ from the plain stages")
        compared += waves > 0
        print(f"probe stages (side {side}, D={d}, B={b}) seed {seed}: "
              f"kernel stages against the plain stages on the card: GMUs "
              f"equal, {int(aux_p.cascade_size)} firings in {waves} waves "
              f"and counters bitwise, max|dw| {dw:.3g} <= {bound:.3g}")
    if not compared:
        raise AssertionError("probe stages: no cascade compared")
    return {"bmu": err, "drive_waves": drive_waves, "w": w, "s": s,
            "drive_args": args}


def _active_block_params(cfg):
    """The block parameters one token's forward multiplies by: all of a
    dense layer's (a GELU MLP has two matrices, SwiGLU three; the audio
    decoder's cross-attention is counted apart, by ``_train_flops``); of an
    MoE layer the attention, the router, the shared experts and k of the E
    routed experts (the active parameters)."""
    d = cfg.d_model
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    if cfg.arch_type != "moe":
        mlp = (2 if cfg.mlp_kind == "gelu" else 3) * d * cfg.d_ff
        return cfg.num_layers * (attn + mlp)
    nd = cfg.first_dense_layers
    fe = cfg.moe_d_ff or cfg.d_ff
    moe = attn + d * cfg.num_experts + 3 * d * fe * (
        cfg.experts_per_token + cfg.num_shared_experts)
    return (nd * (attn + 3 * d * (cfg.first_dense_d_ff or cfg.d_ff))
            + (cfg.num_layers - nd) * moe)


def _train_flops(cfg, b, s):
    """(bf16 product FLOPs, f32 attention product FLOPs, model FLOPs) of
    one train step: the block and head matrices 2 T N forward, 4 T N
    backward and the blocks' 2 T N again under remat, N the active
    parameters (``_active_block_params``); the attention's QK and PV over
    the whole S x S square, 4 B H S^2 hd a layer forward, as many again
    under remat and twice in backward. The audio family adds its encoder
    over B x encoder_seq frames (its blocks' matrices, its Se x Se
    attention) and each decoder layer's cross-attention (Q and O on the T
    tokens, K and V on the B Se frames, QK and PV over the S x Se
    rectangle). Model FLOPs: forward and backward once, no remat."""
    t = b * s
    d, hd, h = cfg.d_model, cfg.hd, cfg.num_heads
    blocks = _active_block_params(cfg)
    head = cfg.vocab_size * d
    attn_fwd = 4 * b * h * s * s * hd * cfg.num_layers
    mats_fwd = 0                   # the encoder's and cross-attention's
    if cfg.is_encoder_decoder:
        se, le = cfg.encoder_seq, cfg.encoder_layers or cfg.num_layers
        enc = _active_block_params(dataclasses.replace(cfg, num_layers=le))
        mats_fwd = (2 * b * se * (enc + cfg.num_layers * 2 * d * cfg.kv_dim)
                    + 2 * t * cfg.num_layers * 2 * d * cfg.q_dim)
        attn_fwd += 4 * b * h * hd * (se * se * le + s * se * cfg.num_layers)
    remat = 1 if cfg.remat else 0
    bf16 = (6 * t * (blocks + head) + remat * 2 * t * blocks
            + (3 + remat) * mats_fwd)
    attn = (3 + remat) * attn_fwd
    return bf16, attn, 6 * t * (blocks + head) + 3 * (mats_fwd + attn_fwd)


def train_full_width(device):
    """Phase L (c): llama3.2-1b at full width, bf16, through
    ``launch/train.py``'s ``run``: B 4 x S 1,024, 30 steps with the probe
    (side 8), the kernel counts set to 0 just before and read just after.
    Each loss finite, the mean of the last 5 below the first 5's, exactly
    one ``bmu`` call and one ``drive_cascade`` launch a step. Then a
    profiled window of full steps (launches, host syncs, device busy) and
    of the probe's update alone (its device time and host syncs). Returns
    the run's figures."""
    from repro_torch import configs
    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import GeneratorDraws
    from repro_torch.launch import train
    from repro_torch.training import AdamWConfig, train_step
    cfg = configs.get(TRAIN_ARCH)
    name = torch.cuda.get_device_name(0)
    peak = BF16_PEAKS["PCIe" if "PCIe" in name else "SXM"]
    f32_peak, _ = peaks_for(name)
    # the batch pipeline apart from the step: one batch at the run's shape
    gen = torch.Generator().manual_seed(SEED)
    table, weights = tokens.make_markov(gen, cfg.vocab_size)
    t0 = time.perf_counter()
    for _ in range(5):
        tokens.sample_batch(gen, table, weights, TRAIN_B, TRAIN_S)
    batch_ms = (time.perf_counter() - t0) / 5 * 1e3
    last, times = {}, []

    def on_step(i, state, metrics, ms):
        times.append(ms)
        last["state"] = state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = train.run(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                       lr=TRAIN_LR, probe=True, probe_side=TRAIN_PROBE_SIDE,
                       seed=SEED, device=device, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"full-width training: losses {losses}")
    first, final = np.mean(losses[:5]), np.mean(losses[-5:])
    if not final < first:
        raise AssertionError(f"full-width training: loss {first} -> {final}"
                             f" did not fall")
    if (counts["bmu"], counts["drive_cascade"]) != (TRAIN_STEPS,
                                                     TRAIN_STEPS):
        raise AssertionError(f"full-width training: launched {counts} in "
                             f"{TRAIN_STEPS} steps; bmu and drive_cascade "
                             f"must run once a step")
    step_ms = float(np.median(times[4:]))
    bf16, attn, model = _train_flops(cfg, TRAIN_B, TRAIN_S)
    floor_ms = (bf16 / peak + attn / f32_peak) * 1e3
    print(f"full-width training ({cfg.name}, bf16, B {TRAIN_B} x S "
          f"{TRAIN_S}, {TRAIN_STEPS} steps, probe {TRAIN_PROBE_SIDE}x"
          f"{TRAIN_PROBE_SIDE}x{cfg.d_model}): {seconds:.2f} s with init; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
          f"{first:.4f}, of the last 5 {final:.4f}: improved)")
    print(f"full-width training: {step_ms:.3f} ms a step (CUDA events, "
          f"median of steps 5-{TRAIN_STEPS}; min {min(times[4:]):.3f}, max "
          f"{max(times[4:]):.3f}), {TRAIN_B * TRAIN_S / step_ms * 1e3:.1f} "
          f"tokens/s; peak memory {peak_mem / 1e9:.3f} GB "
          f"(max_memory_allocated); launches {counts}")
    print(f"full-width training: {bf16 / 1e12:.2f} TFLOP of bf16 products "
          f"and {attn / 1e12:.2f} TFLOP of f32 attention products a step "
          f"(remat included); model FLOPs {model / 1e12:.2f} T a step, "
          f"{100 * model / (step_ms * 1e-3) / peak:.1f} % of the dense bf16 "
          f"peak ({peak / 1e12:.0f} TFLOP/s); floor {floor_ms:.1f} ms "
          f"(bf16 at {peak / 1e12:.0f}, f32 at {f32_peak / 1e12:.0f} "
          f"TFLOP/s); a batch made on the host in {batch_ms:.2f} ms")
    # the profiled window: full steps from the run's last state
    state = last["state"]
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 20, 5))
    pcfg = probe.ProbeConfig(side=TRAIN_PROBE_SIDE, dim=cfg.d_model,
                             i_max=TRAIN_STEPS * TRAIN_B)
    step = train_step.make_train_step(cfg, opt_cfg, pcfg)
    batch = next(tokens.batches(torch.Generator().manual_seed(SEED + 5),
                                cfg.vocab_size, TRAIN_B, TRAIN_S, 1,
                                device=device))
    torch.cuda.synchronize()

    def steps():
        st = state
        for i in range(TRAIN_PROFILED):
            st, _ = step(st, batch, GeneratorDraws.for_step(SEED, 5000 + i,
                                                            device))
        return st

    n_launch, syncs, wall = _profile_counts(steps)
    _, busy, _ = _profiled_busy(steps)
    print(f"full-width training, {TRAIN_PROFILED} profiled steps: "
          f"{n_launch / TRAIN_PROFILED:.1f} kernel launches and "
          f"{syncs / TRAIN_PROFILED:.2f} host syncs (cudaStreamSynchronize) a"
          f" step (the probe's cascade tail decision is 1), device busy "
          f"{busy / 1e3 / TRAIN_PROFILED:.3f} ms a step, wall "
          f"{wall * 1e3 / TRAIN_PROFILED:.3f} ms a step under the profiler")
    # the probe's update alone, on the run's pooled hidden states
    vecs = _pooled(state, batch, cfg).contiguous()
    pstate = state.probe

    def updates():
        st = pstate
        for i in range(PROBE_PROFILED):
            st, _ = probe.update(st, vecs, GeneratorDraws.for_step(
                SEED, 9000 + i, device), pcfg)
        return st

    updates()
    p_launch, p_syncs, p_wall = _profile_counts(updates)
    _, p_busy, _ = _profiled_busy(updates)
    p_ms = p_busy / 1e3 / PROBE_PROFILED
    print(f"probe update ({TRAIN_PROBE_SIDE}x{TRAIN_PROBE_SIDE}x"
          f"{cfg.d_model}, B={TRAIN_B}; bmu + merge + drive_cascade): device "
          f"busy {p_ms:.4f} ms an update ({100 * p_ms / step_ms:.3f} % of a "
          f"step), {p_launch / PROBE_PROFILED:.1f} kernel launches and "
          f"{p_syncs / PROBE_PROFILED:.2f} host syncs an update, wall "
          f"{p_wall * 1e3 / PROBE_PROFILED:.3f} ms an update under the "
          f"profiler")
    del state, last, pstate
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms}


def train_optimized(device):
    """Phase L (d): ``TRAIN_OPT_STEPS`` steps of ``configs.get_optimized``
    (chunked attention, chunked CE) at the same B and S, with the probe:
    every loss finite; ms a step."""
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = configs.get_optimized(TRAIN_ARCH)
    times = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = train.run(cfg, steps=TRAIN_OPT_STEPS, batch=TRAIN_B,
                       seq=TRAIN_S, lr=TRAIN_LR, probe=True,
                       probe_side=TRAIN_PROBE_SIDE,
                       seed=SEED, device=device,
                       on_step=lambda i, st, m, ms: times.append(ms))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"optimised config: losses {losses}")
    print(f"optimised config ({cfg.attention_impl} attention, chunked_ce "
          f"{cfg.chunked_ce}, ce_chunk {cfg.ce_chunk}): "
          f"{float(np.median(times[2:])):.3f} ms a step (median of steps 3-"
          f"{TRAIN_OPT_STEPS}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, losses finite")
    torch.cuda.empty_cache()


def train_examples_phase():
    """Phase L (e): both training examples on the card at their default
    sizes (the e2e example's checkpoint to a temporary directory)."""
    import re
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        e2e = _example_main("lm_train_e2e_torch",
                            ["--checkpoint", f"{tmp}/lm.msgpack"])
    found = re.search(r"loss: ([0-9.]+) -> ([0-9.]+)", e2e)
    if found is None or not float(found.group(2)) < float(found.group(1)):
        raise AssertionError(f"lm_train_e2e_torch on the card: {e2e!r}")
    t1 = time.perf_counter()
    atlas = _example_main("activation_atlas_torch", [])
    rows = atlas.split("(low = coherent region):")[-1].strip("\n")
    if "device=cuda" not in atlas or len(rows.splitlines()) != 6:
        raise AssertionError(f"activation_atlas_torch on the card: "
                             f"{atlas!r}")
    print(f"training examples on the card: lm_train_e2e_torch "
          f"{t1 - t0:.1f} s, activation_atlas_torch "
          f"{time.perf_counter() - t1:.1f} s")


def probe_kernel_rows(device, checks, counts):
    """Phase L, the kernel table's rows at the probe's shapes: ``bmu`` (B 4,
    N 64, D 2,048) beside its plain version and ``cdist().min``, and
    ``drive_cascade`` (side 8, D 2,048, the p = 0.9 call's waves) beside
    its plain version; launches from the full-width run."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    f32_peak, bw = peaks_for(torch.cuda.get_device_name(0))
    w, s = checks["w"], checks["s"]
    (n, d), b = w.shape, s.shape[0]
    plan = bmu_ops.plan(n, b, d, sm_count(w.device))
    print(f"bmu (probe search): plan {plan.kernel}_kernel, grid {plan.grid} "
          f"({plan.splits} splits of the units), then the merge")
    t = time_both({"plain": lambda: bmu_ref.bmu_ref(w, s),
                   "kernel": lambda: bmu_ops.bmu(w, s),
                   "library": lambda: torch.cdist(s, w).min(dim=1)}, 200,
                  "bmu (probe search)")
    bound, by = _bmu_bound(n, b, d, f32_peak, bw)
    rows = [{
        "name": f"bmu (probe search, B={b}, N={n}, D={d})", "route": "cuda",
        "source": "src/repro_torch/kernels/bmu/bmu.cu",
        "replaces": "src/repro/kernels/bmu/bmu.py:26",
        "launches": counts["bmu"], "max_abs_err": checks["bmu"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": by, "library_ms": t["library"]}]
    args = checks["drive_args"]
    waves = checks["drive_waves"]
    side = args[1].shape[0]
    kw = dict(l_c=0.3, theta=4, budget=cas_ops.DEFAULT_WAVE_CAP)
    plan = cas_ops._cascade_plan(device.index or 0, n, d)
    print(f"drive_cascade (probe): plan {plan.blocks} blocks of "
          f"{plan.threads} threads, {plan.ds} features a block, {plan.smem}"
          f" bytes of shared memory each, the draws of {plan.staged_waves} "
          f"waves staged")
    t = time_both({
        "plain": lambda: cas_ref.drive_cascade_ref(*args, **kw),
        "kernel": lambda: cas_ops.drive_cascade(*args, **kw),
    }, 200, "drive_cascade (probe)")
    nbytes = 2 * 4 * n * d + n * (4 + 4 + 8 + 4 * waves) + n * (4 + 1 + 4) + 8
    ops = 6 * n * d * waves
    bound = max(nbytes / bw, ops / f32_peak) * 1e3
    print(f"drive_cascade (probe): bound {bound:.6f} ms ({nbytes / 1e6:.3f} "
          f"MB, {ops / 1e6:.2f} M operations), kernel at "
          f"{100 * bound / t['kernel']:.1f} % of it")
    rows.append({
        "name": f"drive_cascade (probe, side {side}, D={d}, {waves} waves)",
        "route": "cuda", "source": "src/repro_torch/kernels/cascade/cascade.cu",
        "replaces": "src/repro/kernels/cascade/cascade.py:38",
        "launches": counts["drive_cascade"], "max_abs_err": 0.0,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > ops / f32_peak
        else "operations",
        "library_ms": None})
    return rows


def training_phase(device):
    """Phase L: LM training with the AFM probe (``train_card_vs_cpu``,
    ``probe_kernel_checks``, ``train_full_width``, ``train_optimized``,
    ``train_examples_phase``). Returns the phase's kernel rows."""
    t_phase = time.perf_counter()
    train_card_vs_cpu(device)
    checks = probe_kernel_checks(device)
    run = train_full_width(device)
    rows = probe_kernel_rows(device, checks, run["counts"])
    train_optimized(device)
    train_examples_phase()
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


#: phase M: the MoE family. Card against the CPU at smoke width (f32) for
#: both MoE configs and each path; one granite-moe-1b-a400m MoE layer at
#: full width on MOE_LAYER_T tokens; serving at full width, bf16 (B, prompt,
#: new tokens, linear cache slots); then granite trained at full width with
#: the probe (B 4 x S 1,024, an 8x8 probe on its 1,024-d hidden states, lr
#: TRAIN_LR): MOE_TRAIN_STEPS steps of the faithful config, of
#: moe_impl="ragged" and of get_optimized (ep without a mesh)
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")
MOE_SERVE = {"granite-moe-1b-a400m": (4, 128, 64, 192),
             "deepseek-moe-16b": (4, 128, 32, 160)}
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_STEPS = {"faithful": 20, "ragged": 10, "optimized": 5}
#: the ragged run against the faithful run (the same seed, batches and
#: draws; the paths differ in where bf16 rounds) at the steps whose
#: updates so far had the same learning rates (the launcher's schedule
#: depends on the run's length: the warmup's steps): each loss within this
#: share
MOE_TRACK_TOL = 0.01


def _launcher_lrs(steps):
    """The learning rate of each update of a ``launch/train.run`` of
    ``steps`` steps at TRAIN_LR (its AdamWConfig)."""
    from repro_torch.training import AdamWConfig, adamw
    cfg = AdamWConfig(lr=TRAIN_LR, total_steps=steps,
                      warmup_steps=max(steps // 20, 5))
    return [float(adamw.lr_schedule(cfg, torch.tensor(i)))
            for i in range(1, steps + 1)]
MOE_LAYER_T = 4096
#: card against the CPU at smoke width, f32: forward logits within MOE_TOL
#: (1 + max|logit|); aux, loss, ce, moe_aux and grad_norm within MOE_TOL
#: relative (the matrix products sum in another order on the card)
MOE_TOL = 1e-5
#: capacity factors of the ep check on 2 ranks: the default, which drops
#: nothing at MOE_LAYER_T tokens, and one that drops about half
MOE_EP_FACTORS = (2.0, 0.5)
#: seconds the ep ranks may take (process start and kernel loads included)
MOE_RANK_TIMEOUT = 240


def _moe_bf16_bound(cfg, y):
    """Two bf16 MoE paths against each other: each output sums k gated
    expert rows, and the paths round each row to bf16 in other places, so
    they agree within k bf16 roundings (2^-8 relative) of the largest
    output."""
    return cfg.experts_per_token * 2.0 ** -8 * float(y.float().abs().max())


def _rel_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def moe_card_vs_cpu(device):
    """Phase M (a): both MoE configs at smoke width (f32) on the card and on
    the CPU from the same weights, for each of ``dense``, ``ragged`` and
    single-process ``ep``: ``forward_train`` logits within MOE_TOL (1 +
    max|logit|) and aux within MOE_TOL; prefill and 16 greedy decode steps
    (``decode_card_vs_cpu``); one train step from the CPU's state on one
    batch: loss, ce, moe_aux and grad_norm within MOE_TOL relative."""
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import mlp, transformer
    from repro_torch.training import AdamWConfig, train_step
    for arch in MOE_ARCHS:
        base = configs.get_smoke(arch)
        cpu_model = transformer.init_params(base, seed=SEED, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to(device)
        prompt = prompts_for(base, 2, 24, SEED, "cpu")
        batch = next(tokens.batches(torch.Generator().manual_seed(SEED + 3),
                                    base.vocab_size, 4, 64, 1, device="cpu"))
        for impl in mlp.MOE_IMPLS:
            cfg = dataclasses.replace(base, moe_impl=impl)
            what = f"{arch} smoke ({impl}) card vs CPU"
            lc, ac = transformer.forward_train(cpu_model, {"tokens": prompt},
                                               cfg)
            lg, ag = transformer.forward_train(
                gpu_model, {"tokens": prompt.to(device)}, cfg)
            err = float((lg.cpu() - lc).abs().max())
            tol = MOE_TOL * (1 + float(lc.abs().max()))
            if not (err <= tol and _rel_err(ag, ac) <= MOE_TOL):
                raise AssertionError(f"{what}: logits off by {err} > {tol} "
                                     f"or aux {float(ag)} against {float(ac)}")
            print(f"{what}: forward logits max|d| {err:.3g} <= {tol:.3g}, "
                  f"aux {float(ac):.6f} rel {_rel_err(ag, ac):.3g}")
            decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, 40,
                               f"{what}, decode")
            step = train_step.make_train_step(
                cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
            state = train_step.init_train_state(cfg, seed=SEED, device="cpu")
            card = _train_state_to(state, device)
            _, m = step(state, batch)
            _, mg = step(card, {k: v.to(device) for k, v in batch.items()})
            errs = {key: _rel_err(mg[key], m[key])
                    for key in ("loss", "ce", "moe_aux", "grad_norm")}
            if not all(e <= MOE_TOL for e in errs.values()):
                raise AssertionError(f"{what}: train step {errs}")
            print(f"{what}, one train step (B 4 x S 64): " + ", ".join(
                f"{key} rel {e:.3g}" for key, e in errs.items())
                + f" (<= {MOE_TOL}); moe_aux {float(m['moe_aux']):.6f}")


def _moe_layer_inputs(cfg, device, t):
    """One seeded full-width MoE layer and ``t`` bf16 tokens on the card (the same on every process: the draws come from a seeded
    generator on the card)."""
    from repro_torch.models import mlp
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    p = mlp.MoE(cfg, device)
    p.reset_parameters(gen, cfg)
    x = torch.randn(t, cfg.d_model, generator=gen,
                    device=device).to(cfg.dtype)
    return p, x


def _moe_ep_rank(rank, factors, device, t):
    """One rank of phase M (b)'s ep check: ``moe`` with ``moe_impl="ep"``
    over a 2-rank ``model`` axis, this rank's half of the experts, at each
    capacity factor; (y as f32 numpy, exact from bf16; aux; collectives):
    numpy and floats, which cross the process boundary by value."""
    from repro_torch import configs
    from repro_torch.models import mlp
    from repro_torch.sharding import ShardMesh
    device = torch.device(device)
    mesh = ShardMesh((2,), ("model",))
    out = []
    for f in factors:
        cfg = dataclasses.replace(configs.get(MOE_TRAIN_ARCH), moe_impl="ep",
                                  moe_capacity_factor=f)
        p, x = _moe_layer_inputs(cfg, device, t)
        y, aux = mlp.moe(p, x[None], cfg, mesh=mesh)
        out.append((y[0].float().cpu().numpy(), float(aux), mesh.calls))
    return out


def moe_layer_checks(device):
    """Phase M (b): one granite-moe-1b-a400m MoE layer at full width, bf16,
    MOE_LAYER_T tokens on the card: the ragged path against the dense path
    within ``_moe_bf16_bound``; the grouped product (``grouped_mm``) against
    its per-expert loop within one bf16 ulp plus 1e-3; ``moe`` with
    ``moe_impl="ep"`` on 2 gloo ranks on the card (a ``model`` axis, 16
    experts a rank): at the default capacity (nothing dropped) against the
    dense path, at factor 0.5 against ``moe_ep_path`` on one process
    owning every expert (the same assignments dropped), both ranks equal."""
    from repro_torch import configs
    from repro_torch.models import mlp
    from repro_torch.sharding import spawn_ranks
    cfg = configs.get(MOE_TRAIN_ARCH)
    p, x = _moe_layer_inputs(cfg, device, MOE_LAYER_T)
    gates, top_i, top_p, aux = mlp._routing(p, x, cfg)
    dense = mlp.moe_dense_path(p, x, gates, cfg.dtype)
    ragged = mlp.moe_ragged_path(p, x, top_i, top_p, cfg, cfg.dtype)
    bound = _moe_bf16_bound(cfg, dense)
    err = float((ragged.float() - dense.float()).abs().max())
    if not (bool(torch.isfinite(dense.float()).all()) and err <= bound):
        raise AssertionError(f"MoE layer: ragged off the dense path by {err}"
                             f" > {bound}")
    print(f"MoE layer ({cfg.name}, T {MOE_LAYER_T}, bf16): ragged against "
          f"dense max|d| {err:.4g} <= {bound:.4g} (max|y| "
          f"{float(dense.float().abs().max()):.4g}, mean|d| "
          f"{float((ragged.float() - dense.float()).abs().mean()):.3g}); aux "
          f"{float(aux):.5f}")
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    offs = mlp.group_offsets(flat_e[order], cfg.num_experts)
    xs = x[torch.div(order, cfg.experts_per_token, rounding_mode="floor")]
    for name in ("wg", "wu"):
        got = mlp.grouped_mm(xs, getattr(p, name), offs).float()
        want = mlp.grouped_mm_ref(xs, getattr(p, name), offs).float()
        gerr = (got - want).abs()
        if not bool((gerr <= BF16_ULP * want.abs() + 1e-3).all()):
            raise AssertionError(f"grouped_mm ({name}): off its per-expert "
                                 f"loop by {float(gerr.max())}")
        print(f"grouped_mm ({name}, {xs.shape[0]} rows in {cfg.num_experts} "
              f"groups, sizes {int(offs[0])}..): max|d| from the per-expert "
              f"loop {float(gerr.max()):.3g}")
    t0 = time.perf_counter()
    ranks = spawn_ranks(_moe_ep_rank, 2, (MOE_EP_FACTORS, str(device),
                                              MOE_LAYER_T),
                        dist_backend="gloo", timeout=MOE_RANK_TIMEOUT)
    counts = torch.bincount(flat_e, minlength=cfg.num_experts)
    for i, f in enumerate(MOE_EP_FACTORS):
        y0, aux0, calls = ranks[0][i]
        y0, y1 = torch.from_numpy(y0), torch.from_numpy(ranks[1][i][0])
        cap = max(8, int(f * MOE_LAYER_T * cfg.experts_per_token
                         / cfg.num_experts))
        dropped = int(torch.clamp(counts - cap, min=0).sum())
        if f == MOE_EP_FACTORS[0]:
            want, against = dense, "the dense path"
            if dropped:
                raise AssertionError(f"ep at factor {f} dropped {dropped}")
        else:
            want = mlp.moe_ep_path({n: getattr(p, n) for n in ("wg", "wu",
                                                                "wd")},
                                   x, top_i, top_p, cfg, cfg.dtype,
                                   capacity_factor=f)
            against = "moe_ep_path on one process"
            if not dropped:
                raise AssertionError(f"ep at factor {f} dropped nothing")
        err = float((y0 - want.float().cpu()).abs().max())
        if not (torch.equal(y0, y1) and err <= bound
                and _rel_err(aux0, aux) <= MOE_TOL):
            raise AssertionError(f"ep on 2 ranks, factor {f}: off {against} "
                                 f"by {err} > {bound}, or ranks differ, or "
                                 f"aux {float(aux0)} against {float(aux)}")
        print(f"moe ep on 2 gloo ranks (capacity factor {f}, cap {cap}, "
              f"{dropped} of {flat_e.numel()} assignments dropped): against "
              f"{against} max|d| {err:.4g} <= {bound:.4g}, both ranks "
              f"bitwise equal, aux rel {_rel_err(aux0, aux):.3g}, {calls} "
              f"collectives")
    print(f"moe ep ranks: {time.perf_counter() - t0:.1f} s (process start "
          f"included)")


def moe_serve(device, arch):
    """Phase M (c, d): ``arch`` at full width, bf16, seeded weights, through
    ``launch/serve.py``'s ``run`` (MOE_SERVE's B, prompt, new tokens and
    linear cache) with ``moe_impl`` ``dense`` (JAX's default) and
    ``ragged``, each warmed up first: prefill ms, decode ms/step, tok/s,
    peak memory, ``swa_decode`` launches (one a layer a decode step). Then
    the kernel against its plain version at the decode shape (f32 and
    bf16), and its row of the kernel table."""
    from repro_torch import configs
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get(arch)
    b, prompt_len, new, cache_len = MOE_SERVE[arch]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {n / 1e9:.4f} B parameters, {nbytes / 1e9:.3f} GB, "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s")
    prompts = serve.prompts_for(cfg, b, prompt_len, SEED, device)
    runs = {}
    for impl in ("dense", "ragged"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        serve.run(model, c, prompts, max_new=4, cache_len=cache_len)
        torch.cuda.reset_peak_memory_stats()
        runs[impl] = _serve_run(serve, model, c, prompts, new, cache_len,
                                f"{cfg.name} ({impl}) serve B={b} x "
                                f"{prompt_len} + {new}, linear cache "
                                f"{cache_len}")
        runs[impl]["peak"] = torch.cuda.max_memory_allocated()
        print(f"{cfg.name} ({impl}): peak memory "
              f"{runs[impl]['peak'] / 1e9:.3f} GB (max_memory_allocated)")
    same = float((runs["dense"]["tokens"] == runs["ragged"]["tokens"])
                 .float().mean())
    print(f"{cfg.name}: dense and ragged choose the same token at "
          f"{100 * same:.1f} % of the {b} x {new} places (bf16 rounds in "
          f"other places on the two paths)")
    del model, prompts
    for run in runs.values():
        run.pop("logits", None)
    torch.cuda.empty_cache()
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    gen = torch.Generator().manual_seed(SEED + 67)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, pos = swa_inputs(gen, b, h, hkv, hd, cache_len,
                                  cache_len - 64, dtype, device)
        out = swa_ops.swa_decode(q, k, v, pos)
        ref = swa_ref.swa_decode_ref(q, k, v, pos, window=cache_len)
        torch.cuda.synchronize()
        e = swa_error(out, ref, f"{cfg.name} decode shape {dtype}")
        if dtype == torch.bfloat16:
            worst = e
        print(f"swa_decode at {cfg.name}'s decode shape (B={b}, H={h}, "
              f"Hkv={hkv}, hd={hd}, W={cache_len}) {dtype}: max|d| {e:.3g}")
    inputs = [swa_inputs(gen, b, h, hkv, hd, cache_len, cache_len - 64,
                         torch.bfloat16, device)]
    row = swa_row(device, cfg.name, inputs,
                  runs["dense"]["launches"]["swa_decode"], worst)
    return runs, row


def moe_train(device):
    """Phase M (e): granite-moe-1b-a400m at full width, bf16, through
    ``launch/train.py``'s ``run`` with the probe (B 4 x S 1,024, an 8x8
    probe on the 1,024-d pooled hidden states, lr TRAIN_LR): the faithful
    config (``moe_impl="dense"``), ``ragged`` and ``get_optimized`` (``ep``
    without a mesh: routing and the dense path; chunked attention and CE),
    MOE_TRAIN_STEPS steps each, the kernel counts set to 0 just before each
    run and read just after. Every loss and moe_aux finite; the faithful
    run's loss falling (the mean of the last three steps below the first
    three's); the ragged run's losses within MOE_TRACK_TOL of the faithful
    run's at the steps whose updates had the same learning rates; one ``bmu`` call and one ``drive_cascade``
    launch a step. ms a step, tokens/s, peak memory and
    model FLOPs on the active parameters beside the bf16 peak. Returns the
    faithful run's kernel counts."""
    from repro_torch import configs
    from repro_torch.launch import train
    base = configs.get(MOE_TRAIN_ARCH)
    name = torch.cuda.get_device_name(0)
    peak = BF16_PEAKS["PCIe" if "PCIe" in name else "SXM"]
    _, _, model_flops = _train_flops(base, TRAIN_B, TRAIN_S)
    out = {}
    for label, cfg in (("faithful", base),
                       ("ragged", dataclasses.replace(base,
                                                      moe_impl="ragged")),
                       ("optimized", configs.get_optimized(MOE_TRAIN_ARCH))):
        steps = MOE_TRAIN_STEPS[label]
        times, auxes = [], []

        def on_step(i, state, metrics, ms):
            times.append(ms)
            auxes.append(float(metrics["moe_aux"]))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = train.run(cfg, steps=steps, batch=TRAIN_B, seq=TRAIN_S,
                           lr=TRAIN_LR, probe=True,
                           probe_side=TRAIN_PROBE_SIDE, seed=SEED,
                           device=device, on_step=on_step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        what = f"{cfg.name} training ({label}: moe_impl {cfg.moe_impl})"
        if (len(losses) != steps or not all(np.isfinite(losses))
                or not all(np.isfinite(auxes))):
            raise AssertionError(f"{what}: losses {losses}, aux {auxes}")
        first, final = np.mean(losses[:3]), np.mean(losses[-3:])
        if label == "faithful" and not final < first:
            raise AssertionError(f"{what}: loss {first} -> {final} did not "
                                 f"fall")
        if label == "ragged":
            ref = out["faithful"]["losses"]
            same = next((i for i, (a, b) in enumerate(zip(
                _launcher_lrs(steps), _launcher_lrs(len(ref)))) if a != b),
                steps)
            want = np.array(ref[:same + 1])
            off = np.abs(np.array(losses[:same + 1]) - want) / want
            if not (same > 0 and bool((off <= MOE_TRACK_TOL).all())):
                raise AssertionError(f"{what}: losses {losses} off the "
                                     f"faithful run's {ref}")
            print(f"{what}: losses of steps 0-{same} (the updates before "
                  f"them at the faithful run's learning rates) within "
                  f"{float(off.max()):.3g} of the faithful run's (<= "
                  f"{MOE_TRACK_TOL})")
        if (counts["bmu"], counts["drive_cascade"]) != (steps, steps):
            raise AssertionError(f"{what}: launched {counts} in {steps} "
                                 f"steps; bmu and drive_cascade must run "
                                 f"once a step")
        layers = cfg.num_layers if cfg.attention_impl == "naive" else 0
        if (counts["flash_fwd"], counts["flash_bwd"]) != (
                2 * layers * steps, layers * steps):
            raise AssertionError(f"{what}: launched {counts} in {steps} "
                                 f"steps; the naive path runs the flash "
                                 f"forward twice a layer (remat) and its "
                                 f"backward once, the chunked path never")
        step_ms = float(np.median(times[2:]))
        print(f"{what}, bf16, B {TRAIN_B} x S {TRAIN_S}, {steps} steps, "
              f"probe {TRAIN_PROBE_SIDE}x{TRAIN_PROBE_SIDE}x{cfg.d_model}: "
              f"{seconds:.2f} s with init; losses "
              f"{' '.join(f'{x:.4f}' for x in losses)} (mean of the first 3 "
              f"{first:.4f}, of the last 3 {final:.4f}); moe_aux "
              f"{' '.join(f'{x:.2f}' for x in auxes)}")
        print(f"{what}: {step_ms:.3f} ms a step (CUDA events, median of "
              f"steps 3-{steps}; min {min(times[2:]):.3f}, max "
              f"{max(times[2:]):.3f}), {TRAIN_B * TRAIN_S / step_ms * 1e3:.1f}"
              f" tokens/s; peak memory {peak_mem / 1e9:.3f} GB; model FLOPs "
              f"on the active parameters {model_flops / 1e12:.2f} T a step, "
              f"{100 * model_flops / (step_ms * 1e-3) / peak:.2f} % of the "
              f"dense bf16 peak ({peak / 1e12:.0f} TFLOP/s); launches "
              f"{counts}")
        out[label] = {"counts": counts, "step_ms": step_ms,
                      "losses": losses}
    torch.cuda.empty_cache()
    return out


#: phase M (f): the flash-attention kernels at the benchmark cells' shapes
#: (label, B, S, H, Hkv, hd, with the backward): granite-moe-1b-a400m's
#: training rows (B 32 x S 1,024, GQA 16/8, hd 64) and deepseek-moe-16b's
#: prefill (B 1, MHA 16, hd 128) at the ladder's median and longest rungs
FLASH_CASES = [("granite train", 32, 1024, 16, 8, 64, True),
               ("deepseek prefill median", 1, 1500, 16, 16, 128, False),
               ("deepseek prefill longest", 1, 3968, 16, 16, 128, False)]
#: the kernels against their plain version, in ``flash_ref.err_units`` (a
#: bf16 ulp of the value or of its row's RMS): both sum the same f32
#: products in other orders (dQ's f32 atomics in no fixed order) and round
#: once, so a value may land on the other side of a bf16 rounding boundary
#: (1 unit); a P rounded to its other bf16 neighbour moves a value by ~2^-9
#: of one term of thousands. A dropped key tile moves a late row by ~10.
FLASH_UNITS = 2.0
#: lse against the plain version's, absolute: some f32 ulps of values
#: below 16 (exp2 and log2 approximations, other sum orders)
FLASH_LSE_TOL = 1e-5


def flash_flops(b, s, h, hd):
    """(forward, backward) FLOPs of one causal call of the flash kernels,
    their products over the S (S + 1) / 2 (query, key) pairs a head: 4 hd a
    pair forward (QK^T, PV), 10 hd backward (QK^T again, dV, dP, dK, dQ;
    the products of dS's low part not counted)."""
    pairs = b * h * s * (s + 1) / 2
    return 4 * hd * pairs, 10 * hd * pairs


def flash_check(label, q, k, v, d_out=None):
    """The forward kernel (and with ``d_out`` the backward, fed the plain
    forward's out and lse) against the plain version (``kernels/flash/
    ref.py``) on the same inputs: out, dq, dk and dv within FLASH_UNITS,
    lse within FLASH_LSE_TOL. Returns {name: (error in units or, for lse,
    absolute; largest absolute error)}; raises past a bound."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    out, lse = flash_ops._forward(q, k, v)
    want, want_lse = flash_ref.flash_forward_ref(q, k, v)
    pairs = [("out", out, want)]
    if d_out is not None:
        grads = flash_ops._backward(q, k, v, want, want_lse, d_out)
        plain = flash_ref.flash_backward_ref(q, k, v, want, want_lse, d_out)
        pairs += list(zip(("dq", "dk", "dv"), grads, plain))
    torch.cuda.synchronize()
    lse_err = float((lse - want_lse).abs().max())
    errs = {"lse": (lse_err, lse_err)}
    for name, got, ref in pairs:
        errs[name] = (flash_ref.err_units(got, ref),
                      float((got.float() - ref.float()).abs().max()))
    print(f"flash {label}: against the plain version "
          + ", ".join(f"{name} {units:.3f} units ({err:.3g})"
                      for name, (units, err) in errs.items() if name != "lse")
          + f", lse {lse_err:.3g}")
    bad = {name: e for name, (e, _) in errs.items()
           if e > (FLASH_LSE_TOL if name == "lse" else FLASH_UNITS)}
    if bad:
        raise AssertionError(f"flash {label}: {bad} past the bounds "
                             f"({FLASH_UNITS} units, lse {FLASH_LSE_TOL})")
    return errs


def flash_rows(device, train_counts, serve_counts):
    """Phase M (f): each case's forward (and at granite's shape the forward
    with the backward) held to the plain version by ``flash_check``, then
    timed queued ahead in turns with the plain version and with
    ``scaled_dot_product_attention`` (causal, GQA; the library yardstick,
    which the port never calls). Bound: max(bytes / 3.35 TB/s, causal
    FLOPs / 989 TFLOP/s), the FLOPs ``flash_flops``, the bytes q, k, v and
    out (and dO, dq, dk, dv) once each. ``train_counts`` and
    ``serve_counts``: the launches of granite's faithful training run and
    of deepseek's ragged serve run. Returns the kernel table's rows."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    _, bw = peaks_for(torch.cuda.get_device_name(0))
    peak = BF16_PEAKS["PCIe" if "PCIe" in torch.cuda.get_device_name(0)
                      else "SXM"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for label, b, s, h, hkv, hd, backward in FLASH_CASES:
        gen = torch.Generator(device=device).manual_seed(SEED + s)
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        d_out = torch.randn((b, s, h, hd), generator=gen,
                            device=device).to(torch.bfloat16)
        shape = f"B={b}, S={s}, H={h}, Hkv={hkv}, hd={hd}"
        rows_a_block = flash_ops.plan(b, h, s, hd, sm_count(device))
        print(f"flash {label} ({shape}): {rows_a_block} query rows a "
              f"forward block")
        errs = flash_check(label, q, k, v, d_out if backward else None)
        worst = max(err for name, (_, err) in errs.items() if name != "lse")
        units = max(u for name, (u, _) in errs.items() if name != "lse")
        torch.cuda.empty_cache()
        fwd_flops, bwd_flops = flash_flops(b, s, h, hd)
        qkv_bytes = 2 * (2 * b * s * h * hd + 2 * b * s * hkv * hd)
        directions = [("forward", fwd_flops, qkv_bytes + 4 * b * h * s)]
        if backward:
            directions.append(("forward and backward", fwd_flops + bwd_flops,
                               2 * qkv_bytes + 2 * (b * s * h * hd)
                               + 8 * b * h * s))
        for what, flops, nbytes in directions:
            if what == "forward":
                fns = {
                    "plain": lambda: flash_ref.flash_forward_ref(q, k, v),
                    "kernel": lambda: flash_ops._forward(q, k, v),
                    "library": lambda: sdpa(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True,
                        enable_gqa=True)}
            else:
                def plain_both():
                    o, l = flash_ref.flash_forward_ref(q, k, v)
                    return flash_ref.flash_backward_ref(q, k, v, o, l, d_out)

                def kernel_both():
                    o, l = flash_ops._forward(q, k, v)
                    return flash_ops._backward(q, k, v, o, l, d_out)

                leaves = [x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v)]
                do_t = d_out.transpose(1, 2)

                def library_both():
                    o = sdpa(*leaves, is_causal=True, enable_gqa=True)
                    return torch.autograd.grad(o, leaves, do_t)

                fns = {"plain": plain_both, "kernel": kernel_both,
                       "library": library_both}
            t = time_both(fns, 3 if s > 2048 or backward else 10,
                          f"flash {what} {label}")
            bound = max(nbytes / bw, flops / peak) * 1e3
            print(f"flash {what} {label} ({shape}): kernel "
                  f"{t['kernel']:.5f} ms ({flops / t['kernel'] / 1e9:.1f} "
                  f"TFLOP/s, {100 * bound / t['kernel']:.1f} % of the "
                  f"bound), plain {t['plain']:.5f} ms, sdpa "
                  f"{t['library']:.5f} ms, bound {bound:.5f} ms "
                  f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)")
            launches = (serve_counts["flash_fwd"] if not backward
                        else train_counts["flash_fwd"] if what == "forward"
                        else train_counts["flash_bwd"])
            rows.append({
                "name": f"flash {what} ({label}: {shape})",
                "route": "cuda",
                "source": "src/repro_torch/kernels/flash/flash.cu",
                "replaces": None, "launches": launches,
                "max_abs_err": worst, "max_err_units": units,
                "ms": t["kernel"],
                "plain_ms": t["plain"], "bound_ms": bound,
                "bound_by": ("bytes" if nbytes / bw > flops / peak
                             else "operations"),
                "library_ms": t["library"]})
        del q, k, v, d_out
        torch.cuda.empty_cache()
    return rows


#: phase M (g): latent attention's 192/128 forward at the MLA cell's
#: shortest and longest rungs (B 1, 16 heads, YaRN's softmax scale); the
#: plain version and SDPA are timed at the shortest alone (at 60,416 keys
#: the plain version's tile loop takes seconds a call)
MLA_FLASH_LENGTHS = (17408, 60416)
MLA_FLASH_SCALE = 192 ** -0.5 * (1 + 0.0707 * math.log(40)) ** 2


def mla_prefill_launches(device, s=MLA_FLASH_LENGTHS[0]):
    """Phase M (g), first: DeepSeek-V2-Lite whole (27 layers at its
    published widths, bf16 random weights, the ragged MoE) prefills one
    ``s``-token prompt through ``transformer.prefill``. ``launches_mla`` is
    zeroed just before and read after: one launch a layer, and no plain
    attention on the card. The latent cache holds ``ckv`` and ``kpe``
    alone, 576 bf16 values a token a layer. The first layer's call of
    ``flash_forward_mla``, the wrapper the model calls, is held on the q,
    k, v and scale the prefill gave it to ``ref.flash_forward_ref``
    (FLASH_UNITS). Returns the launches counted."""
    import gc
    from repro_torch import configs
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.models import attention, transformer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.get("deepseek-v2-lite"),
                              moe_impl="ragged")
    model = transformer.init_params(cfg, seed=SEED, device=device)
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(SEED + s))
    toks = toks.to(device)
    calls = []
    wrapper = flash_ops.flash_forward_mla

    def spy(q, k, v, scale):
        out = wrapper(q, k, v, scale)
        calls.append((q, k, v, scale, out) if not calls else None)
        return out

    flash_ops.flash_forward_mla = spy
    try:
        flash_ops.launches_mla = 0
        plain, latent = attention.plain_cuda_calls, attention.latent_bytes
        with torch.no_grad():
            logits, cache = transformer.prefill(model, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        launches = flash_ops.launches_mla
        plain = attention.plain_cuda_calls - plain
        latent = attention.latent_bytes - latent
    finally:
        flash_ops.flash_forward_mla = wrapper
    peak = torch.cuda.max_memory_allocated()
    layers = {k: set(e) for k, e in cache.items()}
    finite = bool(torch.isfinite(logits).all())
    q, k, v, scale, out = calls[0]
    want, _ = flash_ref.flash_forward_ref(q, k, v, scale=scale)
    units = flash_ref.err_units(out, want)
    shapes = [tuple(t.shape) for t in (q, k, v, out)]
    print(f"deepseek-v2-lite prefill ({cfg.num_layers} layers, S={s}): "
          f"{launches} launches of the 192/128 forward, {len(calls)} calls "
          f"of flash_forward_mla, {plain} plain attention calls on the "
          f"card, latent cache {latent} bytes {layers}, peak "
          f"{peak / 1e9:.2f} GB; layer 0's call q, k, v, out {shapes} at "
          f"scale {scale:.6f}: {units:.3f} units from the plain version")
    want_latent = cfg.num_layers * s * (cfg.kv_lora_rank
                                        + cfg.qk_rope_head_dim) * 2
    if (launches != cfg.num_layers or len(calls) != cfg.num_layers
            or plain or latent != want_latent or not finite
            or set().union(*layers.values()) != {"ckv", "kpe"}
            or units > FLASH_UNITS):
        raise AssertionError(f"deepseek-v2-lite prefill: launches "
                             f"{launches}, calls {len(calls)}, plain {plain}, "
                             f"latent {latent} of {want_latent}, finite "
                             f"{finite}, caches {layers}, {units} units")
    del model, cache, logits, calls, q, k, v, out, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mla_flash_rows(device):
    """Phase M (g): a DeepSeek-V2-Lite prefill (``mla_prefill_launches``)
    counts the 192/128 forward's launches a request; then at each rung the
    model's wrapper ``flash_forward_mla`` is held to its plain version in
    ``flash_ref.err_units`` (within FLASH_UNITS), the kernel's lse too
    (FLASH_LSE_TOL), and the wrapper timed queued ahead, in turns with the
    plain version and SDPA (causal, the same scale) at the shortest rung.
    Bound: its causal FLOPs (``ops.mla_flops``) at the bf16 peak; the
    bytes (q, k, v, out) lie far below. Returns the kernel table's rows."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    launches = mla_prefill_launches(device)
    peak = BF16_PEAKS["PCIe" if "PCIe" in torch.cuda.get_device_name(0)
                      else "SXM"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for s in MLA_FLASH_LENGTHS:
        gen = torch.Generator(device=device).manual_seed(SEED + s)
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for shape in ((1, s, 16, 192), (1, s, 16, 192),
                                 (1, s, 16, 128)))
        shape = f"B=1, S={s}, H=16, d_qk=192, d_v=128"
        out = flash_ops.flash_forward_mla(q, k, v, MLA_FLASH_SCALE)
        _, lse = flash_ops._forward_mla(q, k, v, MLA_FLASH_SCALE)
        want, want_lse = flash_ref.flash_forward_ref(q, k, v,
                                                     scale=MLA_FLASH_SCALE)
        torch.cuda.synchronize()
        units = flash_ref.err_units(out, want)
        worst = float((out.float() - want.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        print(f"mla flash ({shape}): against the plain version out "
              f"{units:.3f} units ({worst:.3g}), lse {lse_err:.3g}")
        if units > FLASH_UNITS or lse_err > FLASH_LSE_TOL:
            raise AssertionError(f"mla flash ({shape}): out {units} units, "
                                 f"lse {lse_err} past the bounds")
        del want, want_lse, out, lse
        torch.cuda.empty_cache()
        fns = {"kernel": lambda: flash_ops.flash_forward_mla(
            q, k, v, MLA_FLASH_SCALE)}
        if s == MLA_FLASH_LENGTHS[0]:
            fns["plain"] = lambda: flash_ref.flash_forward_ref(
                q, k, v, scale=MLA_FLASH_SCALE)
            fns["library"] = lambda: sdpa(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=MLA_FLASH_SCALE)
        t = time_both(fns, 3, f"mla flash forward S={s}")
        flops = flash_ops.mla_flops(1, s, 16, 192, 128)
        bound = flops / peak * 1e3
        print(f"mla flash forward ({shape}): kernel {t['kernel']:.5f} ms "
              f"({flops / t['kernel'] / 1e9:.1f} TFLOP/s, "
              f"{100 * bound / t['kernel']:.1f} % of the bound), bound "
              f"{bound:.5f} ms ({flops / 1e12:.3f} TFLOP)")
        rows.append({
            "name": f"flash forward (deepseek-v2-lite prefill: {shape})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash/flash.cu",
            "replaces": None, "launches": launches,
            "max_abs_err": worst, "max_err_units": units,
            "ms": t["kernel"], "plain_ms": t.get("plain"),
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": t.get("library")})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def moe_phase(device):
    """Phase M: the MoE family (``moe_card_vs_cpu``, ``moe_layer_checks``,
    the probe's kernels at D = 1,024, ``moe_serve`` of both configs,
    ``moe_train``). Returns the phase's kernel rows."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    moe_card_vs_cpu(device)
    moe_layer_checks(device)
    checks = probe_kernel_checks(device, MOE_TRAIN_ARCH)
    rows = []
    serve_runs = {}
    for arch in MOE_ARCHS[:1]:
        serve_runs[arch], row = moe_serve(device, arch)
        rows.append(row)
    trained = moe_train(device)
    rows += probe_kernel_rows(device, checks, trained["faithful"]["counts"])
    for arch in MOE_ARCHS[1:]:
        serve_runs[arch], row = moe_serve(device, arch)
        rows.append(row)
    rows += flash_rows(device, trained["faithful"]["counts"],
                       serve_runs[MOE_ARCHS[1]]["ragged"]["launches"])
    rows += mla_flash_rows(device)
    for arch, runs in serve_runs.items():
        for impl, run in runs.items():
            print(f"{arch} ({impl}): prefill {run['prefill_ms']:.3f} ms, "
                  f"decode {run['decode_ms_per_step']:.4f} ms/step, "
                  f"{run['decode_tok_s']:.1f} decode tok/s, "
                  f"{run['tok_s']:.1f} tok/s in all, peak "
                  f"{run['peak'] / 1e9:.3f} GB")
    print(f"MoE phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


#: phase N: the recurrent families, mamba2-1.3b (SSM, SSD) and
#: recurrentgemma-2b (hybrid: RG-LRU and local attention at hd 256, MQA
#: rep 10). Card against the CPU at smoke width (f32); swa_decode at
#: recurrentgemma's decode shapes (label, B, H, Hkv, hd, W, first pos;
#: rows step by 21 positions): the serve shape, the 2,048-slot ring of
#: long_500k (8 splits), a ragged rep 12 and rep 16; both served at full
#: width, bf16 (B 4, a 128-token prompt, 64 new tokens on a 192-slot
#: cache; B 1, an REC_LONG_PROMPT-token prompt, 64 new tokens); both
#: trained at full width with the 8x8 probe (B 4 x S 1,024, lr TRAIN_LR,
#: REC_TRAIN_STEPS steps)
REC_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
REC_SWA_CASES = [("recurrentgemma serve", 4, 10, 1, 256, 192, 128),
                 ("recurrentgemma long_500k", 1, 10, 1, 256, 2048, 8703),
                 ("ragged rep 12", 2, 12, 1, 256, 300, 250),
                 ("rep 16", 2, 32, 2, 256, 64, 70)]
REC_SERVE = (4, 128, 64, 192)
#: 34 chunks of mamba2's 256; past recurrentgemma's 2,048-slot ring
REC_LONG_PROMPT = 8704
REC_TRAIN_STEPS = 20
#: card against the CPU at smoke width, f32: forward logits within REC_TOL
#: (1 + max|logit|); loss, ce and grad_norm of a train step within
#: TRAIN_TOL relative (the matrix products and scans sum in another order
#: on the card)
REC_TOL = 1e-4


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size()
               for entry in cache.values() for t in entry.values())


def recurrent_card_vs_cpu(device):
    """Phase N (a): both recurrent configs at smoke width (f32) on the card
    and on the CPU from the same weights: ``forward_train`` logits within
    REC_TOL (1 + max|logit|); prefill and 16 greedy decode steps
    (``decode_card_vs_cpu``; recurrentgemma also an 80-token prompt on its
    64-slot ring, past its window); one train step from the CPU's state on
    one batch: loss, ce and grad_norm within TRAIN_TOL relative."""
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import transformer
    from repro_torch.training import AdamWConfig, train_step
    for arch in REC_ARCHS:
        cfg = configs.get_smoke(arch)
        what = f"{arch} smoke card vs CPU"
        cpu_model = transformer.init_params(cfg, seed=SEED, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to(device)
        prompt = prompts_for(cfg, 2, 32, SEED, "cpu")
        lc, _ = transformer.forward_train(cpu_model, {"tokens": prompt}, cfg)
        lg, _ = transformer.forward_train(gpu_model,
                                          {"tokens": prompt.to(device)}, cfg)
        err = float((lg.cpu() - lc).abs().max())
        tol = REC_TOL * (1 + float(lc.abs().max()))
        if not err <= tol:
            raise AssertionError(f"{what}: logits off by {err} > {tol}")
        print(f"{what}: forward logits max|d| {err:.3g} <= {tol:.3g}")
        decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, 48,
                           f"{what}, decode")
        if cfg.window:
            ring = prompts_for(cfg, 2, cfg.window + 16, SEED + 2, "cpu")
            decode_card_vs_cpu(cpu_model, gpu_model, cfg, ring, 16,
                               cfg.window, f"{what}, decode past the "
                               f"{cfg.window}-slot window on the ring")
        batch = next(tokens.batches(torch.Generator().manual_seed(SEED + 3),
                                    cfg.vocab_size, 4, 64, 1, device="cpu"))
        step = train_step.make_train_step(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
        state = train_step.init_train_state(cfg, seed=SEED, device="cpu")
        card = _train_state_to(state, device)
        _, m = step(state, batch)
        _, mg = step(card, {k: v.to(device) for k, v in batch.items()})
        errs = {key: _rel_err(mg[key], m[key])
                for key in ("loss", "ce", "grad_norm")}
        if not all(e <= TRAIN_TOL for e in errs.values()):
            raise AssertionError(f"{what}: train step {errs}")
        print(f"{what}, one train step (B 4 x S 64): " + ", ".join(
            f"{key} rel {e:.3g}" for key, e in errs.items())
            + f" (<= {TRAIN_TOL})")


def swa_case_checks(device, cases, seed):
    """``swa_decode`` at ``cases`` (label, B, H, Hkv, hd, W, first pos)
    against its plain version on the card, f32 and bf16, two calls bitwise
    equal. Returns the worst bf16 error per label."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    gen = torch.Generator().manual_seed(seed)
    worst = {}
    for label, b, h, hkv, hd, w, pos0 in cases:
        plan = swa_ops.plan(b, hkv, w, sm_count(device))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pos = swa_inputs(gen, b, h, hkv, hd, w, pos0, dtype,
                                      device)
            out = swa_ops.swa_decode(q, k, v, pos)
            ref = swa_ref.swa_decode_ref(q, k, v, pos, window=w)
            if not torch.equal(out, swa_ops.swa_decode(q, k, v, pos)):
                raise AssertionError(f"swa_decode {label}: two calls differ")
            torch.cuda.synchronize()
            what = (f"{label} B={b} H={h} Hkv={hkv} hd={hd} W={w} "
                    f"pos={pos.tolist()} {dtype}")
            err = swa_error(out, ref, what)
            if dtype == torch.bfloat16:
                worst[label] = max(worst.get(label, 0.0), err)
            print(f"swa_decode {what}: {plan.splits} split(s) of "
                  f"{plan.slots}, max|d| {err:.3g}")
    return worst


def recurrent_swa_checks(device):
    """Phase N (b): ``swa_case_checks`` at REC_SWA_CASES."""
    return swa_case_checks(device, REC_SWA_CASES, SEED + 71)


def recurrent_serve(device, arch, worst):
    """Phase N (c, d): ``arch`` at full width, bf16, seeded weights, through
    ``launch/serve.py``'s ``run``, each run warmed up first: B 4 x 128 + 64
    on a 192-slot cache, then B 1 x REC_LONG_PROMPT + 64 (mamba2: 34
    chunks of 256; recurrentgemma: its long_500k ring of 2,048 slots, the
    prefill's attention chunked). Prefill ms, decode ms/step, tok/s, peak
    memory, the decode cache's bytes (beside a zero cache's: the prompt's
    length does not change them),
    ``swa_decode`` launches (one an attention layer a step: 8 for
    recurrentgemma, none for mamba2); for recurrentgemma the kernel held
    to its plain version on the layer-0 cache after the long prefill.
    Returns the runs and the long run's attention caches (for timing)."""
    from repro_torch import configs
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get(arch)
    b, prompt_len, new, cache_len = REC_SERVE
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {n / 1e9:.4f} B parameters, {nbytes / 1e9:.3f} GB, "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s; "
          f"{swa_per_step(cfg)} of {cfg.num_layers} layers decode on "
          f"swa_decode")
    runs = {}
    prompts = serve.prompts_for(cfg, b, prompt_len, SEED, device)
    serve.run(model, cfg, prompts, max_new=4, cache_len=cache_len)
    torch.cuda.reset_peak_memory_stats()
    runs["serve"] = _serve_run(serve, model, cfg, prompts, new, cache_len,
                               f"{cfg.name} serve B={b} x {prompt_len} + "
                               f"{new}, cache {cache_len}")
    runs["serve"]["peak"] = torch.cuda.max_memory_allocated()

    long_cfg = dataclasses.replace(configs.for_shape(cfg, "long_500k"),
                                   attention_impl="chunked")
    w = configs.cache_len_for(long_cfg, "long_500k")
    prompt = serve.prompts_for(cfg, 1, REC_LONG_PROMPT, SEED + 1, device)
    # warm-up: the prefill alone and one decode step
    last, cache = transformer.prefill(model, {"tokens": prompt}, long_cfg,
                                      cache_len=w)
    zero = _cache_bytes(transformer.init_cache(long_cfg, 1, w))
    holds = (f"a {w}-slot ring" if swa_per_step(cfg)
             else "the recurrent states alone")
    print(f"{cfg.name} decode cache at B 1 after the {REC_LONG_PROMPT}-token "
          f"prefill: {_cache_bytes(cache) / 1e6:.3f} MB (a zero cache of the "
          f"same config: {zero / 1e6:.3f} MB; {holds})")
    long_inputs = None
    if swa_per_step(cfg):
        k_all, v_all = cache["pat2_attn"]["k"], cache["pat2_attn"]["v"]
        pos = torch.full((1,), REC_LONG_PROMPT - 1, dtype=torch.int32,
                         device=device)
        gen = torch.Generator().manual_seed(SEED + 73)
        q = torch.randn(1, cfg.num_heads, cfg.hd, generator=gen).to(
            device, cfg.dtype)
        err = swa_error(swa_ops.swa_decode(q, k_all[0], v_all[0], pos),
                        swa_ref.swa_decode_ref(q, k_all[0], v_all[0], pos,
                                               window=w),
                        f"{cfg.name} layer-0 cache after the long prefill")
        worst["recurrentgemma long_500k"] = max(
            worst.get("recurrentgemma long_500k", 0.0), err)
        print(f"swa_decode on {cfg.name}'s layer-0 cache after the "
              f"{REC_LONG_PROMPT}-token prefill (ring of {w}, pos "
              f"{REC_LONG_PROMPT - 1}): max|d| {err:.3g}")
        long_inputs = [(q, k_all[i].clone(), v_all[i].clone(), pos)
                       for i in range(k_all.shape[0])]
    transformer.decode_step(model, last.argmax(-1)[:, None],
                            torch.full((1,), REC_LONG_PROMPT,
                                       dtype=torch.int32, device=device),
                            cache, long_cfg)
    del cache, last
    torch.cuda.reset_peak_memory_stats()
    runs["long"] = _serve_run(serve, model, long_cfg, prompt, new, w,
                              f"{cfg.name} long_500k B=1 x "
                              f"{REC_LONG_PROMPT} + {new}, cache {w}")
    runs["long"]["peak"] = torch.cuda.max_memory_allocated()
    for run in runs.values():
        run.pop("logits", None)
        print(f"{cfg.name}: peak memory {run['peak'] / 1e9:.3f} GB "
              f"(max_memory_allocated)")
    del model, prompts, prompt
    torch.cuda.empty_cache()
    return runs, long_inputs


def _rec_flops(cfg, b, s):
    """Model FLOPs of one train step of a recurrent config: three times the
    forward's products (forward and backward, no remat): 2 T N for the
    matrices N of every layer and the head; SSD's chunk products (C B^T,
    the intra-chunk product, the state in and out: 2 q^2 n + 2 q^2 h p +
    4 q n h p a chunk); the local attention's QK and PV over the S x S
    square (4 B H S^2 hd a layer, S <= window)."""
    from repro_torch.models import transformer
    t, d = b * s, cfg.d_model
    mats, extra = cfg.vocab_size * d, 0
    stacks, tail = transformer._layer_plan(cfg)
    for _, kind, count, _ in stacks + tail:
        if kind == "ssm":
            di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            p, q = cfg.ssm_head_dim, cfg.ssm_chunk
            per = d * (2 * di + 2 * n + h) + di * d
            extra += count * b * (s // q) * (2 * q * q * n + 2 * q * q * h * p
                                             + 4 * q * n * h * p)
        elif kind == "rglru":
            w = cfg.rnn_width
            per = 2 * d * w + 2 * w * w + w * d + 3 * d * cfg.d_ff
        else:
            per = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + 3 * d * cfg.d_ff
            extra += count * 4 * b * cfg.num_heads * s * s * cfg.hd
        mats += count * per
    return 3 * (2 * t * mats + extra)


def train_at_full_width(device, arch, steps, flops_of, num_layers=None,
                        lr=TRAIN_LR):
    """Phase N (e), phase O (d), phase P (d): ``arch`` at full width (cut
    to ``num_layers`` when given), bf16, through ``launch/train.py``'s
    ``run`` with the probe (B 4 x S 1,024, an 8x8 probe on the pooled
    hidden states, lr ``lr``, ``steps`` steps; an audio model's batches
    carry the launcher's zero frames, a VLM's its zero patch embeddings and
    text positions3), the kernel counts set to 0 just before and read just
    after. Every loss and grad
    norm finite (mamba2's at its own chunk of 256: the reference's SSD
    gradient is NaN there), the mean of the last 5 losses below the first
    5's, one ``bmu`` call and one ``drive_cascade`` launch a step. ms a
    step, tokens/s, peak memory, model FLOPs (``flops_of(cfg, B, S)``)
    beside the bf16 peak, and the run's first batch evaluated again with
    the trained weights beside its loss at step 0. Returns the run's
    kernel counts."""
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.training import train_step
    cfg = configs.get(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    name = torch.cuda.get_device_name(0)
    peak = BF16_PEAKS["PCIe" if "PCIe" in name else "SXM"]
    times, norms, last = [], [], {}

    def on_step(i, state, metrics, ms):
        times.append(ms)
        norms.append(float(metrics["grad_norm"]))
        last["state"] = state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = train.run(cfg, steps=steps, batch=TRAIN_B, seq=TRAIN_S,
                       lr=lr, probe=True, probe_side=TRAIN_PROBE_SIDE,
                       seed=SEED, device=device, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    what = f"{cfg.name} training" + (
        f" (cut to {num_layers} of {configs.get(arch).num_layers} layers)"
        if num_layers else "")
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not all(np.isfinite(norms))):
        raise AssertionError(f"{what}: losses {losses}, grad norms {norms}")
    # the launcher's first batch (its data stream, seeded seed + 1)
    batch0 = next(tokens.batches(torch.Generator().manual_seed(SEED + 1),
                                 cfg.vocab_size, TRAIN_B, TRAIN_S, steps,
                                 device=device))
    batch0.update(transformer.stub_inputs(cfg, TRAIN_B, device,
                                          seq=TRAIN_S))
    with torch.no_grad():
        again = float(train_step.lm_loss(last.pop("state").params, batch0,
                                         cfg)[0])
    first, final = np.mean(losses[:5]), np.mean(losses[-5:])
    if not final < first:
        raise AssertionError(f"{what}: loss {first} -> {final} did not fall")
    if (counts["bmu"], counts["drive_cascade"]) != (steps, steps):
        raise AssertionError(f"{what}: launched {counts} in {steps} steps; "
                             f"bmu and drive_cascade must run once a step")
    step_ms = float(np.median(times[4:]))
    flops = flops_of(cfg, TRAIN_B, TRAIN_S)
    print(f"{what}, bf16, B {TRAIN_B} x S {TRAIN_S}, {steps} steps, lr "
          f"{lr:g}, probe "
          f"{TRAIN_PROBE_SIDE}x{TRAIN_PROBE_SIDE}x{cfg.d_model}: "
          f"{seconds:.2f} s with init; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (mean of the first 5 "
          f"{first:.4f}, of the last 5 {final:.4f}); the first batch "
          f"{losses[0]:.4f} -> {again:.4f} with the trained weights; grad "
          f"norms finite ({min(norms):.3f}-{max(norms):.3f})")
    print(f"{what}: {step_ms:.3f} ms a step (CUDA events, median of steps "
          f"5-{steps}; min {min(times[4:]):.3f}, max {max(times[4:]):.3f}), "
          f"{TRAIN_B * TRAIN_S / step_ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak_mem / 1e9:.3f} GB (max_memory_allocated); model FLOPs "
          f"{flops / 1e12:.2f} T a step, "
          f"{100 * flops / (step_ms * 1e-3) / peak:.2f} % of the dense bf16 "
          f"peak ({peak / 1e12:.0f} TFLOP/s); launches {counts}")
    torch.cuda.empty_cache()
    return counts


def recurrent_phase(device):
    """Phase N: the recurrent families (``recurrent_card_vs_cpu``,
    ``recurrent_swa_checks``, ``recurrent_serve`` and ``recurrent_train``
    of both, the probe's kernels at D 2,048 and 2,560). Returns the phase's
    kernel rows: swa_decode at recurrentgemma's two decode shapes (launches
    from its serve runs) and the probe's rows at each arch's width
    (launches from its training run)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    recurrent_card_vs_cpu(device)
    worst = recurrent_swa_checks(device)
    rows, serve_runs = [], {}
    for arch in REC_ARCHS:
        serve_runs[arch], long_inputs = recurrent_serve(device, arch, worst)
        if long_inputs is not None:
            gen = torch.Generator().manual_seed(SEED + 79)
            b, prompt_len, _, cache_len = REC_SERVE
            serve_inputs = [swa_inputs(gen, b, 10, 1, 256, cache_len,
                                       cache_len - 64, torch.bfloat16,
                                       device)]
            runs = serve_runs[arch]
            rows.append(swa_row(device, f"{arch} serve", serve_inputs,
                                runs["serve"]["launches"]["swa_decode"],
                                worst["recurrentgemma serve"]))
            rows.append(swa_row(device, f"{arch} long_500k", long_inputs,
                                runs["long"]["launches"]["swa_decode"],
                                worst["recurrentgemma long_500k"]))
            del long_inputs
            torch.cuda.empty_cache()
    for arch in REC_ARCHS:
        checks = probe_kernel_checks(device, arch)
        counts = train_at_full_width(device, arch, REC_TRAIN_STEPS,
                                     _rec_flops)
        for row in probe_kernel_rows(device, checks, counts):
            row["name"] = f"{row['name']} [{arch}]"
            rows.append(row)
        del checks
    for arch, runs in serve_runs.items():
        for key, run in runs.items():
            print(f"{arch} {key}: prefill {run['prefill_ms']:.3f} ms, decode "
                  f"{run['decode_ms_per_step']:.4f} ms/step, "
                  f"{run['decode_tok_s']:.1f} decode tok/s, "
                  f"{run['tok_s']:.1f} tok/s in all, peak "
                  f"{run['peak'] / 1e9:.3f} GB")
    print(f"recurrent phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


#: phase O: the audio family, whisper-medium (an encoder-decoder: 24
#: bidirectional encoder layers over 1,500 stub frames, 24 decoder layers
#: with cross-attention, learned positions, no RoPE). Card against the CPU
#: at smoke width (f32); swa_decode at whisper's two decode shapes (label,
#: B, H, Hkv, hd, W, first pos; rows step by 21 positions): the decoder's
#: self-attention over its 192-slot cache, and the cross-attention over the
#: 1,500 frames (pos 1,499 and past it: every slot valid, as at the path's
#: pos 1,499; 5 splits of 300 slots on 132 SMs, each ending in a partial
#: 128-slot chunk); served at full width, bf16, B 4 x 128 + 64 with zero
#: frames; trained with the 8x8 probe (B 4 x S 1,024, lr TRAIN_LR,
#: AUDIO_TRAIN_STEPS steps)
AUDIO_ARCH = "whisper-medium"
AUDIO_SWA_CASES = [("whisper self", 4, 16, 16, 64, 192, 128),
                   ("whisper cross", 4, 16, 16, 64, 1500, 1499)]
AUDIO_SERVE = (4, 128, 64, 192)
AUDIO_TRAIN_STEPS = 20


def audio_card_vs_cpu(device):
    """Phase O (a): whisper's smoke config (f32) on the card and on the CPU
    from the same weights and seeded frames (not zeros, so the encoder
    matters): ``forward_train`` logits within REC_TOL (1 + max|logit|);
    prefill and 16 greedy decode steps (``decode_card_vs_cpu``: two
    ``swa_decode`` launches a decoder layer a step) on a linear cache and
    on a 16-slot ring the prompt has wrapped; one train step from the
    CPU's state on one batch: loss, ce and grad_norm within TRAIN_TOL
    relative."""
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import transformer
    from repro_torch.training import AdamWConfig, train_step
    cfg = configs.get_smoke(AUDIO_ARCH)
    what = f"{AUDIO_ARCH} smoke card vs CPU"
    cpu_model = transformer.init_params(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    gen = torch.Generator().manual_seed(SEED + 5)

    def frames(b):
        return torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=gen)

    extra = {"frames": frames(2)}
    prompt = prompts_for(cfg, 2, 32, SEED, "cpu")
    lc, _ = transformer.forward_train(cpu_model, {"tokens": prompt, **extra},
                                      cfg)
    lg, _ = transformer.forward_train(
        gpu_model, {"tokens": prompt.to(device),
                    "frames": extra["frames"].to(device)}, cfg)
    err = float((lg.cpu() - lc).abs().max())
    tol = REC_TOL * (1 + float(lc.abs().max()))
    if not err <= tol:
        raise AssertionError(f"{what}: logits off by {err} > {tol}")
    print(f"{what}: forward logits max|d| {err:.3g} <= {tol:.3g}")
    decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, 48,
                       f"{what}, decode", extra)
    ring = prompts_for(cfg, 2, 40, SEED + 2, "cpu")
    decode_card_vs_cpu(cpu_model, gpu_model,
                       dataclasses.replace(cfg, window=16), ring, 16, 16,
                       f"{what}, decode on a 16-slot ring", extra)
    batch = next(tokens.batches(torch.Generator().manual_seed(SEED + 3),
                                cfg.vocab_size, 4, 64, 1, device="cpu"))
    batch["frames"] = frames(4)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    state = train_step.init_train_state(cfg, seed=SEED, device="cpu")
    card = _train_state_to(state, device)
    _, m = step(state, batch)
    _, mg = step(card, {k: v.to(device) for k, v in batch.items()})
    errs = {key: _rel_err(mg[key], m[key])
            for key in ("loss", "ce", "grad_norm")}
    if not all(e <= TRAIN_TOL for e in errs.values()):
        raise AssertionError(f"{what}: train step {errs}")
    print(f"{what}, one train step (B 4 x S 64): " + ", ".join(
        f"{key} rel {e:.3g}" for key, e in errs.items())
        + f" (<= {TRAIN_TOL})")


def audio_serve(device, worst):
    """Phase O (c): whisper-medium at full width, bf16, seeded weights,
    through ``launch/serve.py``'s ``run`` with the launcher's zero frames,
    warmed up first: B 4 x 128 + 64 on a 192-slot cache. Prefill ms (the
    encoder over 1,500 frames, then the decoder over the prompt), decode
    ms/step, tok/s, peak memory, ``swa_decode`` launches (two a decoder
    layer a step); then a prefill's decode cache (its bytes: the cross
    K/V and the self K/V) and the kernel held to its plain version on its
    layer-0 cross K/V at pos 1,499. Returns the run and the 24 layers'
    cross-attention inputs (for timing)."""
    from repro_torch import configs
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get(AUDIO_ARCH)
    b, prompt_len, new, cache_len = AUDIO_SERVE
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {n / 1e9:.4f} B parameters, {nbytes / 1e9:.3f} GB, "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s; "
          f"{swa_per_step(cfg)} swa_decode launches a decode step (self- "
          f"and cross-attention of {cfg.num_layers} decoder layers)")
    prompts = serve.prompts_for(cfg, b, prompt_len, SEED, device)
    extra = transformer.stub_inputs(cfg, b, device)
    serve.run(model, cfg, prompts, max_new=4, cache_len=cache_len,
              extra_batch=extra)
    torch.cuda.reset_peak_memory_stats()
    run = _serve_run(serve, model, cfg, prompts, new, cache_len,
                     f"{cfg.name} serve B={b} x {prompt_len} + {new}, "
                     f"cache {cache_len}, {cfg.encoder_seq} zero frames",
                     extra)
    run["peak"] = torch.cuda.max_memory_allocated()
    run.pop("logits", None)
    _, cache = transformer.prefill(model, {"tokens": prompts, **extra}, cfg,
                                   cache_len=cache_len)
    dec = cache["dec_blocks"]
    cross = sum(dec[k].numel() * dec[k].element_size()
                for k in ("cross_k", "cross_v"))
    print(f"{cfg.name} decode cache at B {b}: {_cache_bytes(cache) / 1e6:.3f}"
          f" MB ({cross / 1e6:.3f} MB of it the cross K/V over "
          f"{cfg.encoder_seq} frames, {cross / cfg.num_layers / 1e6:.3f} MB "
          f"a layer)")
    se = cfg.encoder_seq
    pos = torch.full((b,), se - 1, dtype=torch.int32, device=device)
    gen = torch.Generator().manual_seed(SEED + 83)
    q = torch.randn(b, cfg.num_heads, cfg.hd, generator=gen).to(device,
                                                                cfg.dtype)
    err = swa_error(swa_ops.swa_decode(q, dec["cross_k"][0],
                                       dec["cross_v"][0], pos),
                    swa_ref.swa_decode_ref(q, dec["cross_k"][0],
                                           dec["cross_v"][0], pos,
                                           window=se),
                    f"{cfg.name} layer-0 cross K/V")
    worst["whisper cross"] = max(worst.get("whisper cross", 0.0), err)
    print(f"swa_decode on {cfg.name}'s layer-0 cross K/V after a prefill "
          f"(W {se}, pos {se - 1}): max|d| {err:.3g}")
    cross_inputs = [(q, dec["cross_k"][i], dec["cross_v"][i], pos)
                    for i in range(cfg.num_layers)]
    del model, prompts, extra, cache
    torch.cuda.empty_cache()
    return run, cross_inputs


def audio_phase(device):
    """Phase O: the audio family (``audio_card_vs_cpu``, ``swa_case_checks``
    at AUDIO_SWA_CASES, ``audio_serve``, the probe's kernels at D 1,024,
    ``train_at_full_width``). Returns the phase's kernel rows: swa_decode
    at whisper's self- and cross-attention shapes (each half the serve
    run's launches: one of each a decoder layer a step) and the probe's
    rows (launches from the training run)."""
    import gc
    from repro_torch import configs
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    audio_card_vs_cpu(device)
    worst = swa_case_checks(device, AUDIO_SWA_CASES, SEED + 89)
    run, cross_inputs = audio_serve(device, worst)
    cfg = configs.get(AUDIO_ARCH)
    b, _, new, cache_len = AUDIO_SERVE
    launches = run["launches"]["swa_decode"]
    per_kind = cfg.num_layers * (new - 1)
    if launches != 2 * per_kind:
        raise AssertionError(f"{AUDIO_ARCH} serve: {launches} swa_decode "
                             f"launches, not {2 * per_kind}")
    gen = torch.Generator().manual_seed(SEED + 97)
    self_inputs = [swa_inputs(gen, b, cfg.num_heads, cfg.num_kv_heads,
                              cfg.hd, cache_len, cache_len - 64,
                              torch.bfloat16, device)]
    rows = [swa_row(device, f"{AUDIO_ARCH} self", self_inputs, per_kind,
                    worst["whisper self"]),
            swa_row(device, f"{AUDIO_ARCH} cross", cross_inputs, per_kind,
                    worst["whisper cross"], masked=False)]
    del cross_inputs, self_inputs
    torch.cuda.empty_cache()
    checks = probe_kernel_checks(device, AUDIO_ARCH)
    counts = train_at_full_width(
        device, AUDIO_ARCH, AUDIO_TRAIN_STEPS,
        lambda cfg, b, s: _train_flops(cfg, b, s)[2])
    for row in probe_kernel_rows(device, checks, counts):
        row["name"] = f"{row['name']} [{AUDIO_ARCH}]"
        rows.append(row)
    del checks
    print(f"{AUDIO_ARCH} serve: prefill {run['prefill_ms']:.3f} ms, decode "
          f"{run['decode_ms_per_step']:.4f} ms/step, "
          f"{run['decode_tok_s']:.1f} decode tok/s, {run['tok_s']:.1f} "
          f"tok/s in all, peak {run['peak'] / 1e9:.3f} GB")
    print(f"audio phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


#: phase P: the VLM family, qwen2-vl-72b (the dense family with M-RoPE over
#: (t, h, w) positions and the stub vision frontend's patch embeddings
#: spliced over the prompt's first tokens). Card against the CPU at smoke
#: width (f32); swa_decode at its decode shapes (label, B, H, Hkv, hd, W,
#: first pos; rows step by 21 positions; GQA 64/8 at hd 128: rep 8), the
#: serve shape and the long_500k ring; served at full width cut to
#: VLM_SERVE_LAYERS of its 80 layers (72.7 B parameters, ~145 GB in bf16,
#: do not fit one card; 24 layers are 23.56 B, 47.1 GB), B 4 x 128 + 64
#: with an 8 x 8 grid of patches (min(num_patches, prompt // 2), as JAX's
#: train launcher sizes them) and B 1 x 8,704 + 64 on the 8,192-slot ring
#: with all 1,024 patches as a 32 x 32 grid; trained with the 8x8 probe at
#: VLM_TRAIN_LAYERS layers (4.25 B parameters, ~51 GB with bf16 gradients
#: and f32 moments; three layers would leave too little of 80 GB for the
#: activations), B 4 x S 1,024, VLM_TRAIN_STEPS steps at VLM_TRAIN_LR
VLM_ARCH = "qwen2-vl-72b"
VLM_SWA_CASES = [("qwen2-vl serve", 4, 64, 8, 128, 192, 128),
                 ("qwen2-vl long_500k", 1, 64, 8, 128, 8192, 8703)]
VLM_SERVE = (4, 128, 64, 192)
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS = 24, 2
VLM_LONG_PROMPT = 8704
VLM_TRAIN_STEPS = 20
#: a third of TRAIN_LR: at 3e-4 this width's loss rises over the 20 steps
#: with the launcher's zero patches over half of every sequence (12.14 ->
#: 12.35 on an H100), and falls at 1e-4 (scripts/lr_sweep_torch.py,
#: PERF.md)
VLM_TRAIN_LR = 1e-4
#: the seeded patch embeddings' scale: the token embeddings' N(0, 0.02^2)
VLM_PATCH_STD = 0.02


def vlm_inputs(cfg, b, s, side, gen, device, std=1.0):
    """A VLM prompt's extra inputs: seeded non-zero patch embeddings (b,
    side^2, D) in ``cfg.dtype`` (drawn on the CPU) and the M-RoPE positions
    of a side x side grid of them followed by text
    (``rope.grid_positions3``)."""
    from repro_torch.models import rope
    vis = std * torch.randn(b, side * side, cfg.d_model, generator=gen)
    return {"vision_embeds": vis.to(device, cfg.dtype),
            "positions3": rope.grid_positions3(b, s, side, side, device)}


def vlm_card_vs_cpu(device):
    """Phase P (a): qwen2-vl-72b's smoke config (f32) on the card and on the
    CPU from the same weights: ``forward_train`` logits with seeded
    non-zero patch embeddings over its 16 patches as a 4 x 4 grid of
    positions (within REC_TOL (1 + max|logit|)); prefill and 16 greedy
    decode steps (``decode_card_vs_cpu``: one ``swa_decode`` launch a
    layer a step, the steps at text positions) with those patches, of the
    same prompt text-only, and with the patches on a 16-slot ring the
    40-token prompt has wrapped; one train step from the CPU's state on
    one batch with patches: loss, ce and grad_norm within TRAIN_TOL
    relative."""
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import transformer
    from repro_torch.training import AdamWConfig, train_step
    cfg = configs.get_smoke(VLM_ARCH)
    side = int(round(cfg.num_patches ** 0.5))
    what = f"{VLM_ARCH} smoke card vs CPU"
    cpu_model = transformer.init_params(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    gen = torch.Generator().manual_seed(SEED + 7)
    prompt = prompts_for(cfg, 2, 32, SEED, "cpu")
    extra = vlm_inputs(cfg, 2, 32, side, gen, "cpu")
    lc, _ = transformer.forward_train(cpu_model, {"tokens": prompt, **extra},
                                      cfg)
    lg, _ = transformer.forward_train(
        gpu_model, {"tokens": prompt.to(device),
                    **{k: v.to(device) for k, v in extra.items()}}, cfg)
    err = float((lg.cpu() - lc).abs().max())
    tol = REC_TOL * (1 + float(lc.abs().max()))
    if not err <= tol:
        raise AssertionError(f"{what}: logits off by {err} > {tol}")
    print(f"{what}: forward logits with {cfg.num_patches} patches over a "
          f"{side} x {side} grid, max|d| {err:.3g} <= {tol:.3g}")
    decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, 48,
                       f"{what}, decode after {cfg.num_patches} patches",
                       extra)
    decode_card_vs_cpu(cpu_model, gpu_model, cfg, prompt, 16, 48,
                       f"{what}, decode text-only")
    ring = prompts_for(cfg, 2, 40, SEED + 2, "cpu")
    decode_card_vs_cpu(cpu_model, gpu_model,
                       dataclasses.replace(cfg, window=16), ring, 16, 16,
                       f"{what}, decode after {cfg.num_patches} patches on "
                       f"a 16-slot ring", vlm_inputs(cfg, 2, 40, side, gen,
                                                     "cpu"))
    batch = next(tokens.batches(torch.Generator().manual_seed(SEED + 3),
                                cfg.vocab_size, 4, 64, 1, device="cpu"))
    batch.update(vlm_inputs(cfg, 4, 64, side, gen, "cpu"))
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    state = train_step.init_train_state(cfg, seed=SEED, device="cpu")
    card = _train_state_to(state, device)
    _, m = step(state, batch)
    _, mg = step(card, {k: v.to(device) for k, v in batch.items()})
    errs = {key: _rel_err(mg[key], m[key])
            for key in ("loss", "ce", "grad_norm")}
    if not all(e <= TRAIN_TOL for e in errs.values()):
        raise AssertionError(f"{what}: train step {errs}")
    print(f"{what}, one train step (B 4 x S 64, patches): " + ", ".join(
        f"{key} rel {e:.3g}" for key, e in errs.items())
        + f" (<= {TRAIN_TOL})")


def vlm_serve(device, worst):
    """Phase P (c): qwen2-vl-72b at full width cut to VLM_SERVE_LAYERS
    layers, bf16, seeded weights, through ``launch/serve.py``'s ``run``
    (``serve_step.generate(extra_batch=)``), each run warmed up first: B 4
    x 128 + 64 on a 192-slot cache with 64 seeded patches as an 8 x 8 grid;
    then long_500k, B 1 x VLM_LONG_PROMPT + 64 on the 8,192-slot ring (the
    prefill's attention chunked) with all 1,024 patches as a 32 x 32 grid.
    Prefill ms, decode ms/step, tok/s, ``swa_decode`` launches (one a layer
    a step), the decode cache's bytes, peak memory; the kernel held to its
    plain version on the layer-0 cache after the long prefill. Frees the
    model. Returns the runs and the long run's 24 layers' caches (for
    timing)."""
    from repro_torch import configs
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa import ref as swa_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    full = configs.get(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_SERVE_LAYERS)
    b, prompt_len, new, cache_len = VLM_SERVE
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name} cut to {cfg.num_layers} of {full.num_layers} layers: "
          f"{n / 1e9:.4f} B parameters, {nbytes / 1e9:.3f} GB, seeded init "
          f"on the card in {time.perf_counter() - t0:.2f} s; "
          f"{swa_per_step(cfg)} swa_decode launches a decode step")
    gen = torch.Generator().manual_seed(SEED + 103)
    runs = {}
    side = int(round(min(cfg.num_patches, prompt_len // 2) ** 0.5))
    prompts = serve.prompts_for(cfg, b, prompt_len, SEED, device)
    extra = vlm_inputs(cfg, b, prompt_len, side, gen, device, VLM_PATCH_STD)
    serve.run(model, cfg, prompts, max_new=4, cache_len=cache_len,
              extra_batch=extra)
    torch.cuda.reset_peak_memory_stats()
    runs["serve"] = _serve_run(serve, model, cfg, prompts, new, cache_len,
                               f"{cfg.name} serve B={b} x {prompt_len} + "
                               f"{new}, cache {cache_len}, {side * side} "
                               f"patches ({side} x {side})", extra)
    runs["serve"]["peak"] = torch.cuda.max_memory_allocated()
    _, cache = transformer.prefill(model, {"tokens": prompts, **extra}, cfg,
                                   cache_len=cache_len)
    runs["serve"]["cache_bytes"] = _cache_bytes(cache)
    del cache

    long_cfg = dataclasses.replace(configs.for_shape(cfg, "long_500k"),
                                   attention_impl="chunked")
    w = configs.cache_len_for(long_cfg, "long_500k")
    side = int(round(cfg.num_patches ** 0.5))
    prompt = serve.prompts_for(cfg, 1, VLM_LONG_PROMPT, SEED + 1, device)
    long_extra = vlm_inputs(cfg, 1, VLM_LONG_PROMPT, side, gen, device,
                            VLM_PATCH_STD)
    # warm-up: the prefill alone and one decode step; its layer-0 cache, in
    # which the ring has wrapped, checks the kernel on real K/V
    last, cache = transformer.prefill(model, {"tokens": prompt,
                                              **long_extra}, long_cfg,
                                      cache_len=w)
    runs_long_cache = _cache_bytes(cache)
    k_all, v_all = cache["blocks"]["k"], cache["blocks"]["v"]
    pos = torch.full((1,), VLM_LONG_PROMPT - 1, dtype=torch.int32,
                     device=device)
    qgen = torch.Generator().manual_seed(SEED + 107)
    q = torch.randn(1, cfg.num_heads, cfg.hd, generator=qgen).to(device,
                                                                 cfg.dtype)
    err = swa_error(swa_ops.swa_decode(q, k_all[0], v_all[0], pos),
                    swa_ref.swa_decode_ref(q, k_all[0], v_all[0], pos,
                                           window=w),
                    f"{cfg.name} layer-0 cache after the long prefill")
    worst["qwen2-vl long_500k"] = max(worst.get("qwen2-vl long_500k", 0.0),
                                      err)
    print(f"swa_decode on {cfg.name}'s layer-0 cache after the "
          f"{VLM_LONG_PROMPT}-token prefill with {side * side} patches (ring "
          f"of {w}, pos {VLM_LONG_PROMPT - 1}): max|d| {err:.3g}")
    long_inputs = [(q, k_all[i].clone(), v_all[i].clone(), pos)
                   for i in range(cfg.num_layers)]
    transformer.decode_step(model, last.argmax(-1)[:, None], pos + 1, cache,
                            long_cfg)
    del cache, last, k_all, v_all
    torch.cuda.reset_peak_memory_stats()
    runs["long"] = _serve_run(serve, model, long_cfg, prompt, new, w,
                              f"{cfg.name} long_500k B=1 x {VLM_LONG_PROMPT}"
                              f" + {new}, ring {w}, {side * side} patches "
                              f"({side} x {side})", long_extra)
    runs["long"]["peak"] = torch.cuda.max_memory_allocated()
    runs["long"]["cache_bytes"] = runs_long_cache
    for key, run in runs.items():
        run.pop("logits", None)
        print(f"{cfg.name} {key}: decode cache {run['cache_bytes'] / 1e6:.3f}"
              f" MB, peak memory {run['peak'] / 1e9:.3f} GB "
              f"(max_memory_allocated), swa_decode "
              f"{run['launches']['swa_decode'] // (new - 1)} launches a step")
    del model, prompts, prompt, extra, long_extra
    torch.cuda.empty_cache()
    return runs, long_inputs


def vlm_phase(device):
    """Phase P: the VLM family (``vlm_card_vs_cpu``, ``swa_case_checks`` at
    VLM_SWA_CASES, ``vlm_serve``, the probe's kernels at D 8,192,
    ``train_at_full_width`` at VLM_TRAIN_LAYERS layers). Returns the
    phase's kernel rows: swa_decode at qwen2-vl-72b's serve and long_500k
    shapes (launches from the serve runs) and the probe's rows (launches
    from the training run)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    vlm_card_vs_cpu(device)
    worst = swa_case_checks(device, VLM_SWA_CASES, SEED + 101)
    runs, long_inputs = vlm_serve(device, worst)
    b, _, _, cache_len = VLM_SERVE
    gen = torch.Generator().manual_seed(SEED + 109)
    _, _, h, hkv, hd, _, _ = VLM_SWA_CASES[0]
    serve_inputs = [swa_inputs(gen, b, h, hkv, hd, cache_len, cache_len - 64,
                               torch.bfloat16, device)]
    rows = [swa_row(device, f"{VLM_ARCH} serve", serve_inputs,
                    runs["serve"]["launches"]["swa_decode"],
                    worst["qwen2-vl serve"]),
            swa_row(device, f"{VLM_ARCH} long_500k", long_inputs,
                    runs["long"]["launches"]["swa_decode"],
                    worst["qwen2-vl long_500k"])]
    del long_inputs, serve_inputs
    torch.cuda.empty_cache()
    checks = probe_kernel_checks(device, VLM_ARCH)
    counts = train_at_full_width(
        device, VLM_ARCH, VLM_TRAIN_STEPS,
        lambda cfg, b, s: _train_flops(cfg, b, s)[2],
        num_layers=VLM_TRAIN_LAYERS, lr=VLM_TRAIN_LR)
    for row in probe_kernel_rows(device, checks, counts):
        row["name"] = f"{row['name']} [{VLM_ARCH}]"
        rows.append(row)
    del checks
    for key, run in runs.items():
        print(f"{VLM_ARCH} ({VLM_SERVE_LAYERS} layers) {key}: prefill "
              f"{run['prefill_ms']:.3f} ms, decode "
              f"{run['decode_ms_per_step']:.4f} ms/step, "
              f"{run['decode_tok_s']:.1f} decode tok/s, {run['tok_s']:.1f} "
              f"tok/s in all, decode cache {run['cache_bytes'] / 1e6:.3f} MB,"
              f" peak {run['peak'] / 1e9:.3f} GB")
    print(f"vlm phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


#: phase Q: the dry run (``repro_torch.launch.dryrun``), a planning tool on
#: the CPU: (a) its CLI on the production meshes in subprocesses, (b, c)
#: its 1 x 1 tallies against one real step on the card
DRYRUN_CLI = (("llama3.2-1b", "train_4k", False),
              ("llama3.2-1b", "decode_32k", False),
              ("qwen2-vl-72b", "decode_32k", True))
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "tag", "moe_impl", "remat",
               "overrides", "ok", "extrapolated", "trace_s", "memory",
               "flops_per_device", "bytes_per_device", "collectives",
               "roofline", "model_flops_total", "model_flops_per_device",
               "useful_flops_ratio", "params_total", "params_active",
               "replicated_ops", "constants")
DRYRUN_DENSE = ("llama3.2-1b",)
#: (c): the serve shape's decode, B 4 over a 192-slot cache
DRYRUN_DECODE_B, DRYRUN_DECODE_CACHE = 4, 192
#: the real step's FLOPs within this share of the dry run's
DRYRUN_FLOPS_TOL = 1e-3
#: the real step's peak above its arguments (torch.cuda.max_memory_allocated
#: less the bytes allocated before the step) over the dry run's temp bytes
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_SMALL = r"""
import json, sys
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
arch, b, s, b_dec, cache = sys.argv[1], *map(int, sys.argv[2:6])
meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
train = dryrun.measure(configs.get(arch), "train_4k", mesh, batch_shapes={
    "tokens": meta(b, s), "labels": meta(b, s)})
decode = dryrun.measure(configs.for_shape(configs.get(arch), "decode_32k"),
                        "decode_32k", mesh,
                        batch_shapes={"tokens": meta(b_dec, 1),
                                      "pos": meta(b_dec)}, cache_len=cache)
print(json.dumps({"train": train, "decode": decode}))
"""


def _dryrun_env():
    """The dry run's environment: the port on the path and no card visible
    (it runs on the CPU by design)."""
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_phase(device):
    """Phase Q: the dry run. (a) ``python -m repro_torch.launch.dryrun`` for
    each of DRYRUN_CLI in its own subprocess, all at once: every JSON has
    JAX's keys and ``ok``, the dense arch no replicated op; the roofline
    line printed. (b) llama3.2-1b without the probe at phase L's B 4 x S
    1,024 train shape: the dry run's 1 x 1 tallies (in a subprocess, its
    fake group apart from this process) against one real step on the card:
    FLOPs within DRYRUN_FLOPS_TOL of the prediction with the modelled gap
    (``flash_gap``: the dry run traces the DTensor program, whose attention
    is the naive path; the card's step runs the flash kernels), argument
    bytes (params, moments, the two steps, the batch) exactly, the real
    peak above the arguments within DRYRUN_PEAK_BAND of the predicted temp
    bytes. (c) its
    B 4 x 192 decode: argument bytes (params, cache, batch) exactly."""
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import transformer
    from repro_torch.training import AdamWConfig, train_step
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for arch, shape, pod in DRYRUN_CLI:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--outdir", out]
            procs.append(subprocess.Popen(
                argv + (["--multi-pod"] if pod else []), env=_dryrun_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        small = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_SMALL, TRAIN_ARCH, str(TRAIN_B),
             str(TRAIN_S), str(DRYRUN_DECODE_B), str(DRYRUN_DECODE_CACHE)],
            env=_dryrun_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            outs = [p.communicate(timeout=300) for p in procs + [small]]
        finally:
            for p in procs + [small]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for (arch, shape, pod), p, (stdout, stderr) in zip(
                DRYRUN_CLI + (("1x1", "tallies", False),), procs + [small],
                outs):
            if p.returncode != 0:
                raise RuntimeError(f"dry run {arch} {shape} exited "
                                   f"{p.returncode}:\n{stderr[-3000:]}")
        for arch, shape, pod in DRYRUN_CLI:
            mesh = "2x16x16" if pod else "16x16"
            res = json.loads(Path(out, f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            missing = [k for k in DRYRUN_KEYS if k not in res]
            if missing or not res["ok"]:
                raise RuntimeError(f"dry run {arch} {shape} {mesh}: missing "
                                   f"{missing}, ok {res.get('ok')}")
            if arch in DRYRUN_DENSE and res["replicated_ops"]:
                raise RuntimeError(f"dry run {arch} {shape}: replicated ops "
                                   f"{res['replicated_ops']}")
            r, mem = res["roofline"], res["memory"]
            print(f"dry run {arch} {shape} {mesh}: compute "
                  f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
                  f"collective {r['collective_s']:.4e} s (NVLink "
                  f"{r['collective_s_nvlink']:.4e} s) -> {r['bottleneck']}; "
                  f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB + "
                  f"temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB a device; "
                  f"traced in {res['trace_s']} s")
    tallies = json.loads(outs[-1][0].strip().splitlines()[-1])

    # (b) one real train step on the card beside the dry run's 1 x 1 tallies
    cfg = configs.get(TRAIN_ARCH)
    gc_collect()
    state = train_step.init_train_state(cfg, seed=SEED, device=device)
    gen = torch.Generator().manual_seed(SEED + 131)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=gen,
                         dtype=torch.int32).to(device)
    batch = {"tokens": toks, "labels": toks.clone()}
    args = _tensor_bytes(list(state.params.parameters())
                         + list(state.opt.mu.values())
                         + list(state.opt.nu.values())
                         + [state.opt.step, state.step]
                         + list(batch.values()))
    step = train_step.make_train_step(cfg, AdamWConfig(total_steps=10_000))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    calls = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    with FlopCounterMode(display=False) as fc:
        _, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    t = tallies["train"]
    naive, flash = flash_gap(cfg, TRAIN_B, TRAIN_S,
                             flash_ops.launches_fwd - calls[0],
                             flash_ops.launches_bwd - calls[1])
    flops = fc.get_total_flops() + flash
    pred = t["flops_per_device"] - naive + flash
    print(f"dry run 1x1 {TRAIN_ARCH} B {TRAIN_B} x S {TRAIN_S} train step: "
          f"FLOPs {t['flops_per_device']:.6e} predicted for the DTensor "
          f"program, less its naive attention {naive:.6e}, plus the flash "
          f"kernels' {flash:.6e} ({flash_ops.launches_fwd - calls[0]} "
          f"forward, {flash_ops.launches_bwd - calls[1]} backward calls): "
          f"{pred:.6e}; {flops:.6e} on the card; arguments "
          f"{t['memory']['argument_size_in_bytes']} predicted, {args} on the "
          f"card; temp {t['memory']['temp_size_in_bytes'] / 1e9:.3f} GB "
          f"predicted, peak above the arguments {peak / 1e9:.3f} GB on the "
          f"card (max_memory_allocated {(peak + before) / 1e9:.3f} GB); "
          f"loss {loss:.4f}")
    if not np.isfinite(loss) or abs(flops - pred) > DRYRUN_FLOPS_TOL * flops:
        raise RuntimeError(f"dry run train FLOPs {pred} against {flops} on "
                           f"the card (loss {loss})")
    if t["memory"]["argument_size_in_bytes"] != args:
        raise RuntimeError(f"dry run train arguments "
                           f"{t['memory']['argument_size_in_bytes']} bytes "
                           f"against {args} on the card")
    ratio = peak / t["memory"]["temp_size_in_bytes"]
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= ratio <= hi:
        raise RuntimeError(f"the card's peak over the dry run's temp bytes is "
                           f"{ratio:.3f}, outside [{lo}, {hi}]")
    model = state.params
    del state, metrics, step
    gc_collect()

    # (c) the decode step's arguments: params, cache, batch
    dcfg = configs.for_shape(cfg, "decode_32k")
    cache = transformer.init_cache(dcfg, DRYRUN_DECODE_B, DRYRUN_DECODE_CACHE,
                                   device=device)
    dbatch = [torch.zeros((DRYRUN_DECODE_B, 1), dtype=torch.int32,
                          device=device),
              torch.zeros((DRYRUN_DECODE_B,), dtype=torch.int32,
                          device=device)]
    dargs = _tensor_bytes(list(model.parameters())
                          + [v for c in cache.values() for v in c.values()]
                          + dbatch)
    d = tallies["decode"]["memory"]["argument_size_in_bytes"]
    print(f"dry run 1x1 {TRAIN_ARCH} B {DRYRUN_DECODE_B} x "
          f"{DRYRUN_DECODE_CACHE} decode: arguments {d} predicted, {dargs} "
          f"on the card")
    if d != dargs:
        raise RuntimeError(f"dry run decode arguments {d} bytes against "
                           f"{dargs} on the card")
    del model, cache
    gc_collect()
    print(f"dry run phase: {time.perf_counter() - t_phase:.1f} s")


def flash_gap(cfg, b, s, fwd_calls, bwd_calls):
    """The attention FLOPs a train step's flash calls stand for: (naive,
    flash). The dry run traces the DTensor program, whose attention is the
    naive path (the flash route refuses DTensors): FlopCounterMode counts
    its (B, H, S, S) products, 4 B H S^2 hd a forward (QK^T, PV) and 8 a
    backward. On one card the plain tensors take the flash kernels, whose
    ctypes launches FlopCounterMode cannot see; their causal products
    (``flash_flops``) come from the calls the launch counters saw."""
    full = b * cfg.num_heads * s * s * cfg.hd
    fwd, bwd = flash_flops(b, s, cfg.num_heads, cfg.hd)
    return ((4 * fwd_calls + 8 * bwd_calls) * full,
            fwd_calls * fwd + bwd_calls * bwd)


def gc_collect():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is "
              "false", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s) -> {_build.library_path().name}")
    print(_build.build_log.strip())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")

    worst = check_kernels(device)
    fused_worst = check_fused_kernel(device)
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = make_dataset("mnist", seed=SEED, device=device)
    print(f"data: mnist stand-in {tuple(xtr.shape)} + {tuple(xte.shape)} in "
          f"{time.perf_counter() - t0:.2f} s")
    check_step_stages(device, xtr)
    check_fused_parts(device, xtr)
    check_fused_vs_staged(device, xtr)
    tm, train_launches, launches, staged_rate, afm_acc = main_path(
        device, xtr, ytr, xte, yte, STEPS)
    tmf, _, fused_launches, fused_rate, _ = main_path(
        device, xtr, ytr, xte, yte, STEPS, kernel="fused",
        required=("fused_step", "bmu@4096"))
    print(f"fit samples/s at 30x30x784, B=16, {STEPS} steps: staged "
          f"{staged_rate:.1f}, fused {fused_rate:.1f}")
    rows = kernel_table(device, tm, xtr, xte, train_launches, launches, worst)
    rows.append(fused_row(device, tmf, xtr, fused_launches, fused_worst))
    rows += serving_path(device, tm, xte, worst)
    del tm, tmf
    tmaf, af_launches, af_rate = async_fast_path(device, xtr, ytr, xte, yte,
                                                 "fused")
    tmas, as_launches, as_rate = async_fast_path(device, xtr, ytr, xte, yte,
                                                 "staged")
    given_launches = async_fused_given(device, xtr)
    async_engine_vs_fused(device, xtr)
    rounds_rate = async_constant_latency(device, xtr, xte)
    async_card_vs_cpu(device)
    check_b1_kernels(device, tmas)
    print(f"async events/s at 30x30x784, zero latency, exact: fused "
          f"{af_rate:.1f}, staged {as_rate:.1f}; constant latency, relay "
          f"race: {rounds_rate:.1f} rounds/s")
    rows += async_rows(device, tmaf, tmas, xtr, af_launches, as_launches,
                       given_launches, worst, fused_worst)
    del tmaf, tmas
    fault_bmu = async_faults(device, xtr, xte)
    faults_card_vs_cpu(device)
    st = stream_phase(device, xtr, xte)
    rows += [
        _row_as(rows, "bmu (async search, B=1)", "bmu (faulty engine, B=1)",
                fault_bmu),
        _row_as(rows, "fused_step (B=1, ", "fused_step (stream, B=1)",
                st["fused_step"]),
        _row_as(rows, "cascade_wave (side 30)",
                "cascade_wave (stream tail waves)", st["cascade_wave"]),
        _row_as(rows, "bmu (serving, bucket 8)",
                "bmu (stream reads, bucket 8)", st.get("bmu@8", 0)),
        _row_as(rows, "bmu (training search, B=16)",
                "bmu (stream reads, bucket 64: 9..16 coalesced samples)",
                st.get("bmu@64", 0)),
        _row_as(rows, "bmu (serving, bucket 4096)",
                "bmu (stream final QE, bucket 4096)", st.get("bmu@4096", 0))]
    rows.append(mesh_phase(device, xtr, xte, worst))
    sharded_phase(device, xtr, xte)
    rows += stream_mesh_phase(rows)
    swa_worst = check_swa_kernel(device)
    check_decode_card_vs_cpu(device)
    runs, long_inputs = serve_full_width(device, swa_worst)
    rows += swa_rows(device, runs, swa_worst, long_inputs)
    for key, run in runs.items():
        print(f"{LM_ARCH} {key}: prefill {run['prefill_ms']:.3f} ms, decode "
              f"{run['decode_ms_per_step']:.4f} ms/step, "
              f"{run['decode_tok_s']:.1f} decode tok/s")
    rows += som_phase(device, xtr, ytr, xte, yte, afm_acc, rows)
    del xtr, ytr, xte, yte
    examples_phase()
    lint_phase()
    rows += training_phase(device)
    rows += moe_phase(device)
    rows += recurrent_phase(device)
    rows += audio_phase(device)
    rows += vlm_phase(device)
    dryrun_phase(device)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
