#!/usr/bin/env python3
"""Where a served map request of the PyTorch/CUDA port spends its time, on
one NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_maps.py [--requests 200]

Serves the 30x30x784 map shape of ``chip_smoke.py`` (initial weights from
the MNIST-shaped stand-in, seed 0) and reports:

0. per call on one sample, back to back (the host's rate) and queued ahead
   of the card behind a sleep kernel (the card's time; 100 calls, so that
   the CUDA driver's launch queue stays short): ``BmuEngine.bmu`` (one ``bmu``
   launch on the sample), the bare ``bmu`` wrapper, and the design the
   engine does not use, a CUDA graph of the wrapper captured here over
   fixed buffers at bucket 8: a whole dispatch (weights and sample copied
   in, replay, packed answer copied out), then each part alone; and a
   10,000-sample query three ways: one B = 10,000 launch, ``BmuEngine.bmu``
   (4,096 + 4,096 + 1,808) and the ladder padded to 3 x 4,096, as JAX
   runs it;
1. whole requests from the host, back to back: ``MapService.transform``
   on a numpy sample (host-to-device copy, dispatch, stats, one stream
   sync, as the gateway calls it) and ``MapGateway.transform`` from one
   client thread;
2. a ``torch.profiler`` trace of ``--requests`` batch-1 requests through
   ``MapService.transform``: wall and device busy time a request, the
   device's idle share, and kernel launches, copies and syncs a request.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: host calls counted per request
HOST_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
              "cudaStreamSynchronize", "cudaStreamWaitEvent",
              "cudaEventRecord")


def per_call_us(fn, iters: int, queue_ahead: bool) -> float:
    """Mean microseconds a call from CUDA events around ``iters`` calls;
    with ``queue_ahead`` a sleep kernel holds the card while the host
    queues them, so the events time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def host_us(fn, iters: int) -> float:
    """Mean microseconds a call on the host clock, each call synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import afm
    from repro_torch.data import make_dataset
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.serving import BmuEngine, MapGateway, MapService
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    xtr, _, xte, _ = make_dataset("mnist", train_size=2048, test_size=10000,
                                  device=device)
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    state = afm.init(GeneratorDraws(0, device), cfg, xtr)
    w, s1 = state.w, xte[:1].contiguous()
    engine = BmuEngine()
    w_s, s_s = w.clone(), torch.zeros((8, cfg.dim), device=device)
    bmu_ops.bmu(w_s, s_s)                 # build and load before capture
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        idx, q2 = bmu_ops.bmu(w_s, s_s)
        out = torch.stack([idx.view(torch.float32), q2])
    torch.cuda.current_stream().wait_stream(side)

    def graph_dispatch():
        w_s.copy_(w)
        s_s[:1].copy_(s1)
        graph.replay()
        return out[:, :1].clone()

    parts = {
        "BmuEngine.bmu": lambda: engine.bmu(w, s1),
        "bare bmu wrapper": lambda: bmu_ops.bmu(w, s1),
        "graph dispatch": graph_dispatch,
        "- weight copy (2.82 MB)": lambda: w_s.copy_(w),
        "- sample copy": lambda: s_s[:1].copy_(s1),
        "- replay alone": graph.replay,
        "- output copy": lambda: out[:, :1].clone(),
    }
    print("per call, one sample: queued ahead of the card (back to back)")
    for name, fn in parts.items():
        queued = per_call_us(fn, 100, True)
        b2b = per_call_us(fn, 1000, False)
        print(f"  {name:28s} {queued:9.3f} us ({b2b:9.3f} us)")
    xq = xte.contiguous()
    padded = torch.zeros((3 * 4096, cfg.dim), device=device)
    padded[:len(xq)] = xq
    blocks = padded.split(4096)
    queries = {
        "one B=10,000 launch": lambda: bmu_ops.bmu(w, xq),
        "BmuEngine.bmu": lambda: engine.bmu(w, xq),
        "padded ladder, 3 x 4,096": lambda: [bmu_ops.bmu(w, b)
                                             for b in blocks],
    }
    print("10,000-sample query: queued ahead of the card (back to back)")
    for name, fn in queries.items():
        queued = per_call_us(fn, 20, True)
        b2b = per_call_us(fn, 20, False)
        print(f"  {name:28s} {queued:9.3f} us ({b2b:9.3f} us)")

    svc = MapService(cfg, state, device=device)
    q1 = xte[:1].cpu().numpy()
    print("whole requests of one sample, host clock, back to back:")
    print(f"  MapService.transform (numpy)   "
          f"{host_us(lambda: svc.transform(q1), 1000):9.3f} us")
    with MapGateway(device=device) as gw:
        gw.attach("map", svc)
        print(f"  MapGateway.transform, 1 client "
              f"{host_us(lambda: gw.transform('map', q1), 1000):9.3f} us")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reqs = [xte[i:i + 1].cpu().numpy() for i in range(args.requests)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for q in reqs:
            svc.transform(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    device_us = sum(getattr(e, attr) for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    n = args.requests
    print(f"profiled, {n} batch-1 MapService.transform requests: wall "
          f"{wall * 1e6 / n:.3f} us/request, device busy "
          f"{device_us / n:.3f} us/request, idle share "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %")
    counts = {e.key: e.count for e in events if e.key in HOST_CALLS}
    print("per request: " + ", ".join(
        f"{k} {counts.get(k, 0) / n:.2f}" for k in HOST_CALLS))
    print(events.table(sort_by=attr, row_limit=10))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    print(f"numpy {np.__version__}, torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
