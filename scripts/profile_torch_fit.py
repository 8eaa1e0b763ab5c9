#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_fit.py [--steps 200] \
        [--kernel staged|fused]

Trains the 30x30x784 map of ``chip_smoke.py`` (B = 16, MNIST-shaped
stand-in data) through ``TopoMap(backend="kernel",
backend_options={"kernel": KERNEL})`` and reports, after a warm-up:

0. the fit rate: ``--steps`` steps of ``afm.train`` with the backend's
   stages, unsynchronised but for one ``torch.cuda.synchronize()`` at the
   end, in ms a step and samples a second (init excluded);
1. the wall time of each stage (staged: search / adapt / cascade; fused:
   the one fused stage), each stage timed on the host between
   ``torch.cuda.synchronize()`` calls;
2. a ``torch.profiler`` trace of the same number of steps, unsynchronised:
   device busy time (sum of kernel times) against the wall time, so the
   device's idle share; kernel launches and host syncs per step; and the
   kernels and host calls that take most time.

The synchronised timing adds one sync per stage and so slows the step; the
profiled run is the one whose wall time matches an ordinary fit.
"""
import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def timed_stages(stages, totals):
    """The same stages, each followed by a sync and its time added up."""
    def wrap(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return run
    return stages._replace(**{f: wrap(f, getattr(stages, f))
                              for f in stages._fields
                              if getattr(stages, f) is not None})


#: host calls counted per step: kernel launches and host syncs
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
              "cudaStreamSynchronize", "cudaMemcpyAsync")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--kernel", choices=("staged", "fused"),
                        default="staged")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.data import make_dataset
    from repro_torch.draws import GeneratorDraws
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    xtr, _, _, _ = make_dataset("mnist", device=device)
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    tm = TopoMap(cfg, backend="kernel", device=device,
                 backend_options={"kernel": args.kernel}
                 ).fit(xtr, num_steps=100)
    print(f"kernel={args.kernel}")
    state, backend = tm.state_, tm.backend

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, aux = afm.train(state, xtr, GeneratorDraws(3, device), cfg,
                       num_steps=args.steps, stages=backend.stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"fit rate, {args.steps} steps, {int(aux.waves.sum())} waves: "
          f"{wall * 1e3 / args.steps:.3f} ms/step, "
          f"{args.steps * cfg.batch / wall:.1f} samples/s")

    totals = defaultdict(float)
    stages = timed_stages(backend.stages, totals)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, aux = afm.train(state, xtr, GeneratorDraws(1, device), cfg,
                       num_steps=args.steps, stages=stages)
    wall = time.perf_counter() - t0
    waves = int(aux.waves.sum())
    print(f"synchronised stages, {args.steps} steps, {waves} waves: "
          f"{wall * 1e3 / args.steps:.3f} ms/step")
    for name, sec in totals.items():
        print(f"  {name:8s} {sec * 1e3 / args.steps:.3f} ms/step "
              f"({100 * sec / wall:.1f} %)")
    if "cascade" in totals:
        print(f"  cascade per wave "
              f"{totals['cascade'] * 1e3 / max(waves, 1):.3f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, aux = afm.train(state, xtr, GeneratorDraws(2, device), cfg,
                           num_steps=args.steps, stages=backend.stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    # the device's own events (kernels, copies) only: an operator's row
    # repeats the time of the kernels it launched
    device_us = sum(getattr(e, attr) for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    print(f"profiled, {args.steps} steps, {int(aux.waves.sum())} waves: wall "
          f"{wall * 1e3 / args.steps:.3f} ms/step, device busy "
          f"{device_us / 1e3 / args.steps:.3f} ms/step, idle share "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %")
    counts = {e.key: e.count for e in events if e.key in HOST_CALLS}
    print("per step: " + ", ".join(
        f"{k} {counts.get(k, 0) / args.steps:.2f}" for k in HOST_CALLS))
    print(events.table(sort_by=attr, row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
