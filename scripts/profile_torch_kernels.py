#!/usr/bin/env python3
"""Where the sliding-window decode kernel's time goes, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_kernels.py

Builds stripped copies of ``kernels/swa/swa.cu`` beside the real one, each
into its own library under ``build/kernel_variants/`` (the sources are
edited as text; the script fails if an edit no longer applies):

- ``as is``: the kernel;
- ``no math``: the bf16 kernel's per-chunk math (QK^T, softmax, PV) skipped
  by a condition the compiler cannot fold, so what is left is the launch,
  the loads, the merge, the ticket and the combine;
- ``no loads``: no K/V copies issued (the math runs on whatever the shared
  memory holds), so what is left is the launch, the math and the tail.

Each is timed queued ahead of the card (CUDA events around 32 calls behind
a sleep kernel, median of 3) at llama3.2-1b's long_500k decode shape (B 1,
32/8 heads, hd 64, W 8192, bf16, 16 caches in turn so K/V come from device
memory) and at its serve shape (B 4, W 192), beside an empty elementwise
op queued the same way (the floor of any launch), in two rounds.
"""
import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLEEP_CYCLES = 100_000_000


def queued_us(fn, iters=32, rounds=3):
    """Median device time of one call, queued ahead of the card, in us."""
    out = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters * 1e3)
    return sorted(out)[len(out) // 2]


def replace(text, old, new):
    if old not in text:
        raise RuntimeError(f"swa.cu no longer holds {old[:60]!r}")
    return text.replace(old, new)


def variants(source: str) -> dict:
    math_start = "    // S for slots 8 nt + 2 gc (+1) of this warp's 16\n"
    math_end = "    __syncthreads();                       // this stage is refilled next\n"
    a, b = source.index(math_start), source.index(math_end)
    no_math = (source[:a] + "    if (slots < 0) {\n" + source[a:b] + "    }\n"
               + source[b:])
    no_loads = replace(replace(source, "    if (c < chunks) issue(c);\n", ""),
                       "    if (c + MMA_STAGES < chunks) issue(c + MMA_STAGES);\n",
                       "")
    return {"as is": source, "no math": no_math, "no loads": no_loads}


def build(name: str, source: str):
    """A library of all the port's kernels with swa.cu replaced."""
    from repro_torch.kernels import _build
    kernels = ROOT / "build" / "kernel_variants" / name.replace(" ", "_")
    shutil.rmtree(kernels, ignore_errors=True)
    shutil.copytree(_build.KERNELS_DIR, kernels / "kernels",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (kernels / "kernels" / "swa" / "swa.cu").write_text(source)
    saved = _build.KERNELS_DIR, _build.BUILD_DIR, _build._library
    try:
        _build.KERNELS_DIR, _build.BUILD_DIR = kernels / "kernels", kernels
        _build._library = None
        return _build.load()
    finally:
        _build.KERNELS_DIR, _build.BUILD_DIR, _build._library = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.device import sm_count
    from repro_torch.kernels.swa import ops as swa_ops
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    source = (ROOT / "src/repro_torch/kernels/swa/swa.cu").read_text()
    libs = {name: build(name, text) for name, text in variants(source).items()}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device).manual_seed(0)
    tickets = torch.zeros(64, dtype=torch.int32, device=device)

    def shape(b, w, pos, n_caches):
        caches = [tuple(torch.randn(s, generator=gen, device=device).bfloat16()
                        for s in ((b, 32, 64), (b, w, 8, 64), (b, w, 8, 64)))
                  for _ in range(n_caches)]
        posv = (pos + torch.arange(b, dtype=torch.int32)).to(device)
        return caches, posv, swa_ops.plan(b, 8, w, sm_count(device))

    shapes = {"long_500k (B 1, W 8192)": shape(1, 8192, 8703, 16),
              "serve (B 4, W 192)": shape(4, 192, 128, 1)}
    x = torch.zeros(1, device=device)
    for rnd in range(2):
        print(f"round {rnd + 1}: an empty elementwise op, queued: "
              f"{queued_us(lambda: x.add_(1)):.3f} us")
        for label, (caches, posv, plan) in shapes.items():
            b, w = caches[0][1].shape[:2]
            out = torch.empty_like(caches[0][0])
            ml = torch.empty(b, 8, plan.splits, 4, 2, device=device)
            acc = torch.empty(b, 8, plan.splits, 4, 64, device=device)
            for name, lib in libs.items():
                turn = itertools.cycle(caches)

                def call():
                    q, k, v = next(turn)
                    err = lib.repro_swa_decode(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        posv.data_ptr(), b, 8, w, 4, 64, 1, plan.splits,
                        plan.slots, ml.data_ptr(), acc.data_ptr(),
                        tickets.data_ptr(), out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                print(f"round {rnd + 1}: {label}, {plan.splits} x "
                      f"{plan.slots} slots, {name}: {queued_us(call):.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
