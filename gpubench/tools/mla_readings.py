"""Latent attention's spans and counters over an MLA prefill cell's traced
stretch (one request a rung, after every rung has been sent once, inside
the harness's ``ranges``, as a ``--trace 1`` run profiles it):

- ``span_ms``: the self device ms a request of the program's spans
  ``attention`` and ``mla_latent`` (``gpubench/spans.py``);
- ``range_ms``: the device ms a request inside the harness's ranges
  (``attention``, ``mla_latent``, ``moe``);
- ``counters``: a request's calls of the 192/128 flash forward
  (``flash_ops.launches_mla``), their causal FLOPs (``flops_mla``) and
  the bytes written into latent caches (``attention.latent_bytes``).

    python3 gpubench/tools/mla_readings.py --workload deepseek-v2-lite-prefill-long --seed <n>

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench import program, spans, spec, trace  # noqa: E402


def counters() -> dict:
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import attention
    return {"launches_mla": flash_ops.launches_mla,
            "flops_mla": flash_ops.flops_mla,
            "latent_bytes": attention.latent_bytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    cell = spec.cell(args.workload)
    client = cell.kind.Client(cell, args.seed, "cuda")
    for rung in range(len(client.ladder)):
        client.send(client.rung_prompts(0, rung))
    n = cell.traffic["trace_requests"]
    before = counters()
    with trace.ranges(program.layer_ranges(cell.config)):
        _, summary, read = spans.profile(
            lambda: [client.send(client.rung_prompts(0, r))
                     for r in range(n)])
    after = counters()
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "requests": n,
        "lengths": [client.ladder[r] for r in range(n)],
        "device": torch.cuda.get_device_name(0),
        "span_ms": {k: 1e3 * read.span_s.get(k, 0.0) / n
                    for k in ("attention", "mla_latent")},
        "range_ms": {k: 1e3 * v / n for k, v in summary.range_s.items()},
        "counters": {k: (after[k] - before[k]) / n for k in after},
        "busy_s": summary.busy_s, "window_s": summary.window_s}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
