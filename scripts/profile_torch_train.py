#!/usr/bin/env python3
"""Where a train step of the port's LM training path spends its time, on
one NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_train.py [--steps 30] \
        [--optimized] [--lr 1e-3] [--batch 4] [--seq 1024] [--probe-side 8] \
        [--arch llama3.2-1b|whisper-medium|...] [--moe-impl dense|ragged|ep]

Builds ``--arch`` at full width (bf16, seeded weights, ``configs.get``,
or ``configs.get_optimized`` with ``--optimized``; an MoE config's path
set by ``--moe-impl``) with the AFM probe, as ``launch/train.py`` does
(an audio model's batches carry its zero frames), and runs ``--steps``
steps on the synthetic corpus, printing each step's
loss and time (CUDA events). Then, from the trained state:

- the step's parts apart, each with CUDA events (median of 3): the
  forward pass with its graph, the forward and backward passes
  (``lm_loss`` and ``torch.autograd.grad``), the optimizer
  (``adamw_update``) and the probe's update;
- the host syncs of 2 steps (``set_sync_debug_mode("warn")``), each with
  the innermost lines of Python on the stack where it was made, then 2
  steps without the probe under ``set_sync_debug_mode("error")``;
- 2 steps under ``torch.profiler``: wall and device busy a step, so the
  idle share, kernel launches a step, and the kernels that take most of
  the device's time.
"""
import argparse
import collections
import dataclasses
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _events_ms(fn, reps: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, from CUDA events
    around each (the card may idle inside, as it does in a step)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--probe-side", type=int, default=8)
    parser.add_argument("--optimized", action="store_true")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--moe-impl", choices=("dense", "ragged", "ep"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import GeneratorDraws
    from repro_torch.models import transformer
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      init_train_state, make_train_step)
    from repro_torch.training.train_step import lm_loss
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    arch = args.arch
    cfg = configs.get_optimized(arch) if args.optimized else configs.get(arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    b, s = args.batch, args.seq
    pcfg = probe.ProbeConfig(side=args.probe_side, dim=cfg.d_model,
                             i_max=args.steps * b)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    state = init_train_state(cfg, pcfg, seed=0, device=device)
    step = make_train_step(cfg, opt, pcfg)
    extra = transformer.stub_inputs(cfg, b, device, seq=s)
    data = [{**batch, **extra}
            for batch in tokens.batches(torch.Generator().manual_seed(1),
                                        cfg.vocab_size, b, s, args.steps,
                                        device=device)]
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i, batch in enumerate(data):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch, GeneratorDraws.for_step(0, 1000 + i,
                                                              device))
        end.record()
        losses.append(float(m["loss"]))
        print(f"step {i:3d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e} "
              f"gnorm {float(m['grad_norm']):.3f} probe_cascade "
              f"{int(m['probe_cascade'])} {start.elapsed_time(end):.3f} ms")
    k = min(5, len(losses))
    print(f"{cfg.name} (attention {cfg.attention_impl}, chunked_ce "
          f"{cfg.chunked_ce}, moe_impl {cfg.moe_impl}), B {b} x S {s}: "
          f"loss mean of the first {k} "
          f"{sum(losses[:k]) / k:.4f}, of the last {k} "
          f"{sum(losses[-k:]) / k:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    batch = data[-1]
    model = state.params
    params = dict(model.named_parameters())
    grads = {}

    def forward():
        return lm_loss(model, batch, cfg, return_hidden=True)

    def forward_backward():
        loss = forward()[0]
        grads.update(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    def optimizer():
        adamw_update(params, grads, state.opt, opt)

    with torch.no_grad():
        hidden = forward()[3]
    vecs = probe.pool_hidden(hidden.float()).contiguous()
    del hidden

    def probe_update():
        probe.update(state.probe, vecs, GeneratorDraws(7, device), pcfg)

    parts = {"forward (with its graph)": lambda: forward()[0],
             "forward + backward": forward_backward,
             "optimizer": optimizer, "probe update": probe_update}
    for name, fn in parts.items():
        print(f"part {name}: {_events_ms(fn):.3f} ms")

    def two_steps():
        nonlocal state
        for i in range(2):
            state, _ = step(state, batch, GeneratorDraws.for_step(
                0, 5000 + i, device))

    two_steps()
    torch.cuda.synchronize()
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1][-4:]
            where[" <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                              for f in reversed(stack))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            two_steps()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"host syncs in 2 steps: {sum(where.values())}")
    for stack, n in where.most_common():
        print(f"  x{n}: {stack}")
    # the same steps without the probe, where any host sync raises
    lm_step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, _ = lm_step(state, batch)
        print("2 steps without the probe under set_sync_debug_mode('error'):"
              " no host sync")
    except RuntimeError as exc:
        print(f"a step without the probe synchronised: {exc}")
        traceback.print_exc()
    finally:
        torch.cuda.set_sync_debug_mode(0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        two_steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    device_us = sum(getattr(e, attr) for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cudaLaunchCooperativeKernel"))
    print(f"profiled 2 steps: wall {wall * 1e3 / 2:.3f} ms a step, device "
          f"busy {device_us / 1e3 / 2:.3f} ms a step, idle share "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %, "
          f"{launches / 2:.1f} kernel launches a step")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation),
                     key=lambda e: -getattr(e, attr))
    for e in kernels[:25]:
        print(f"  {getattr(e, attr) / 1e3 / 2:9.3f} ms a step  "
              f"{e.count / 2:7.1f} calls  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
