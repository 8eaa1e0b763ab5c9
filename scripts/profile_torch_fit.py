#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_fit.py [--steps 200] \
        [--kernel staged|fused] [--backend kernel|async] \
        [--latency zero|constant] [--search exact|heuristic]

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

``--backend async`` trains the same map through ``TopoMap(backend=
"async")``, one sample an event (``--search``, exact by default;
``--latency constant`` sends the run through the discrete-event engine
with ``delay=1.0``), and reports 0 and 2 for ``--steps`` events of
``AsyncBackend.run``: events and rounds a second, then per event and per
round the wall time, device busy time, idle share, kernel launches and host
syncs.
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
    parser.add_argument("--backend", choices=("kernel", "async"),
                        default="kernel")
    parser.add_argument("--latency", choices=("zero", "constant"),
                        default="zero")
    parser.add_argument("--search", choices=("exact", "heuristic"),
                        default="exact")
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
    if args.backend == "async":
        return profile_async(args, xtr, device)
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

    (_, aux), events, attr, device_us, wall = profiled(lambda: afm.train(
        state, xtr, GeneratorDraws(2, device), cfg, num_steps=args.steps,
        stages=backend.stages))
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


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (its result, its key averages,
    the attribute of their device time, the device's busy microseconds,
    wall seconds)."""
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
    # the device's own events (kernels, copies) only: an operator's row
    # repeats the time of the kernels it launched
    device_us = sum(getattr(e, attr) for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    return out, events, attr, device_us, wall


def profile_async(args, xtr, device) -> int:
    """``--backend async``: events of ``AsyncBackend.run`` from a map
    warmed up by 200 events of the same backend."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    cfg = afm.AFMConfig(side=30, dim=784, batch=1)
    opts = {"kernel": args.kernel, "search": args.search}
    if args.latency == "constant":
        opts = {"latency": "constant", "delay": 1.0, "search": args.search}
    tm = TopoMap(cfg, backend="async", device=device,
                 backend_options=opts).fit(xtr, num_steps=200)
    print(f"backend=async {opts}")
    state, backend = tm.state_, tm.backend
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backend.run(state, xtr, GeneratorDraws(3, device), args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = backend.last_report
    print(f"run rate, {args.steps} events, {rep.rounds} rounds, "
          f"{rep.deliveries} deliveries: {args.steps / wall:.1f} events/s, "
          f"{rep.rounds / wall:.1f} rounds/s, {wall * 1e3 / args.steps:.3f} "
          f"ms/event, {wall * 1e3 / rep.rounds:.3f} ms/round")
    _, events, attr, device_us, wall = profiled(
        lambda: backend.run(state, xtr, GeneratorDraws(2, device),
                            args.steps))
    rep = backend.last_report
    print(f"profiled, {args.steps} events, {rep.rounds} rounds: wall "
          f"{wall * 1e3 / args.steps:.3f} ms/event "
          f"({wall * 1e3 / rep.rounds:.3f} ms/round), device busy "
          f"{device_us / 1e3 / args.steps:.4f} ms/event, idle share "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %")
    counts = {e.key: e.count for e in events if e.key in HOST_CALLS}
    for unit, k in (("event", args.steps), ("round", rep.rounds)):
        print(f"per {unit}: " + ", ".join(
            f"{name} {counts.get(name, 0) / k:.2f}" for name in HOST_CALLS))
    print(events.table(sort_by=attr, row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
