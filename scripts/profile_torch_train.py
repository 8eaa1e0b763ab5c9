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

- 2 steps without the probe under ``set_sync_debug_mode("error")``;
- 2 steps under ``torch.profiler``, read by ``gpubench/trace.py`` and
  ``gpubench/spans.py``: wall and device busy a step (the union of device
  intervals), so the idle share, kernel launches a step, the kernels that
  take most of the device's time; then, a step, each of the port's spans
  (``repro_torch.analysis.spans``) with its self device ms, its host syncs
  and the device-idle ms under it.
"""
import argparse
import dataclasses
import subprocess
import sys
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


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
    from gpubench import spans
    from repro_torch import configs
    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import GeneratorDraws
    from repro_torch.models import transformer
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)
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

    def two_steps():
        nonlocal state
        for i in range(2):
            state, _ = step(state, batch, GeneratorDraws.for_step(
                0, 5000 + i, device))

    two_steps()
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

    _, summary, read = spans.profile(two_steps)
    print(f"profiled 2 steps: wall {summary.window_s * 1e3 / 2:.3f} ms a "
          f"step, device busy {summary.busy_s * 1e3 / 2:.3f} ms a step, "
          f"idle share {100 * (1 - summary.busy_s / summary.window_s):.1f} "
          f"%, {summary.launches / 2:.1f} kernel launches a step")
    for name, seconds in summary.device_ops:
        print(f"  {seconds * 1e3 / 2:9.3f} ms a step  "
              f"{summary.by_name[name][1] / 2:7.1f} calls  {name[:110]}")
    print("a step, by span (innermost at the launch call): self device ms, "
          "host syncs, device-idle ms")
    for name in sorted(set(read.span_s) | set(read.span_idle_s)
                       | set(read.span_syncs),
                       key=lambda n: -read.span_s.get(n, 0.0)):
        print(f"  {name or '(outside every span)':24}"
              f" {read.span_s.get(name, 0.0) * 500:9.3f}"
              f" {read.span_syncs.get(name, 0) / 2:5.1f}"
              f" {read.span_idle_s.get(name, 0.0) * 500:9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
