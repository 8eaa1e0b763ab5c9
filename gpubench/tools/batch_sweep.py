"""The peak memory of one measured train step at doubling batch sizes, to
size a train cell's batch: the largest B whose step peaks at or under
``--limit-gb`` (80 % of an 80 GB card by default).

    python3 gpubench/tools/batch_sweep.py --workload granite-moe-train-probe
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from gpubench import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--limit-gb", type=float, default=64.0)
    ap.add_argument("--start", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    b = args.start
    while True:
        traffic = {**cell.traffic, "batch": b}
        try:
            loop = cell.kind.Loop(cell, args.seed, "cuda", traffic)
            loop.step()
            loop.step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loop.step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        except torch.OutOfMemoryError:
            peak = float("inf")
        loop = None
        torch.cuda.empty_cache()
        print(f"batch {b}: peak of one step {peak / 1e9:.3f} GB", flush=True)
        if peak > args.limit_gb * 1e9:
            break
        b *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
