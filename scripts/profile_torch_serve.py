#!/usr/bin/env python3
"""Where a decode step of the port's LM serving path spends its time, on one
NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_serve.py [--steps 32] \
        [--shape serve|long_500k] [--arch llama3.2-1b|whisper-medium|...] \
        [--moe-impl dense|ragged|ep]

Builds ``--arch`` at full width (bf16, seeded weights; an MoE config's
path set by ``--moe-impl``) and prefills it as
``chip_smoke.py`` does: ``serve`` is B 4 with a 128-token prompt on a
192-slot linear cache, ``long_500k`` B 1 with an 8,704-token prompt
(chunked) on the 8,192-slot ring; an audio model's prefill runs its
encoder over the launcher's zero frames. After a few warm-up steps it runs
``--steps`` greedy decode steps under ``torch.profiler`` and reports the
wall time a step, the device's busy time a step (sum of kernel and copy
times) and so its idle share, kernel launches a step, and the kernels and
host calls that take most time.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: host calls counted per step: kernel launches and host syncs
HOST_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx",
              "cudaStreamSynchronize", "cudaMemcpyAsync")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--shape", choices=("serve", "long_500k"),
                        default="serve")
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--moe-impl", choices=("dense", "ragged", "ep"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import transformer
    from repro_torch.serving import serve_step
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    cfg = configs.get(args.arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    if args.shape == "serve":
        batch, prompt_len, cache_len = 4, 128, 128 + 64
    else:
        cfg = dataclasses.replace(configs.for_shape(cfg, "long_500k"),
                                  attention_impl="chunked")
        cache_len = configs.cache_len_for(cfg, "long_500k")
        batch, prompt_len = 1, cache_len + 512
    model = transformer.init_params(cfg, seed=0, device=device)
    prompt = prompts_for(cfg, batch, prompt_len, 0, device)
    last, cache = transformer.prefill(
        model, {"tokens": prompt,
                **transformer.stub_inputs(cfg, batch, device)}, cfg,
        cache_len=cache_len)
    step = serve_step.make_decode_step(cfg)
    tok = last.argmax(-1)
    pos = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)

    def decode(n):
        nonlocal tok, pos, cache
        for _ in range(n):
            tok, _, cache = step(model, {"tokens": tok[:, None], "pos": pos},
                                 cache)
            pos = pos + 1

    decode(4)                                          # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode(args.steps)
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
    print(f"{cfg.name} (moe_impl {cfg.moe_impl}) {args.shape}: B {batch}, "
          f"prompt {prompt_len}, cache {cache_len}; "
          f"profiled {args.steps} decode steps: wall "
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
