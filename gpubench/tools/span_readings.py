"""The program's spans over a cell's traced stretch, as a ``--trace 1`` run
profiles it: a train cell's ``trace_steps`` steps after its checked steps,
a prefill cell's one request a rung (inside the harness's ``ranges``)
after every rung has been sent once. Read by ``gpubench/spans.py``.

    python3 gpubench/tools/span_readings.py --workload <cell> --seed <n>

Prints one JSON line: the readings a step (train) or a request (prefill)
of each layer's self device ms, host syncs and device-idle ms, the sums
they are checked by, and the trace's whole tables.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench import program, spans, spec, trace  # noqa: E402

#: a train step's layers: (reading, its forward and backward spans)
TRAIN = (("attention_ms.train", ("attention", "attention.backward")),
         ("moe_ms.train", ("moe", "moe.backward")),
         ("lm_head_ms.train", ("lm_head", "lm_head.backward")),
         ("cross_entropy_ms.train", ("cross_entropy",
                                     "cross_entropy.backward")),
         ("optimizer_ms.train", ("optimizer",)),
         ("probe_ms.train", ("probe",)),
         ("other_ms.train", ("train_step",)))

#: device ops by kind, the first pattern that matches the name
KINDS = (("gemm", re.compile(r"gemm|xmma|cutlass|cublas|Kernel2", re.I)),
         ("copy_or_cast", re.compile(r"copy|Memcpy|Memset")),
         ("elementwise", re.compile(r"elementwise")),
         ("softmax", re.compile(r"softmax", re.I)),
         ("reduce", re.compile(r"reduce", re.I)))


def kinds(ops: dict) -> dict:
    """{kind: seconds} of a span's {device op name: seconds}."""
    out = {}
    for name, seconds in ops.items():
        kind = next((k for k, rx in KINDS if rx.search(name)), "other")
        out[kind] = out.get(kind, 0.0) + seconds
    return out


def traced(cell, seed: int):
    """(Summary, Spans, units): the cell's traced stretch read both ways,
    and the steps or requests it held."""
    if cell.traffic["kind"] == "train":
        loop = cell.kind.Loop(cell, seed, "cuda")
        cell.kind.program_record(loop)
        n = cell.traffic["trace_steps"]
        _, summary, read = spans.profile(
            lambda: [loop.step() for _ in range(n)])
        return summary, read, n
    client = cell.kind.Client(cell, seed, "cuda")
    for rung in range(len(client.ladder)):
        client.send(client.rung_prompts(0, rung))
    n = cell.traffic["trace_requests"]
    with trace.ranges(program.layer_ranges(cell.config)):
        _, summary, read = spans.profile(
            lambda: [client.send(client.rung_prompts(0, r))
                     for r in range(n)])
    return summary, read, n


def readings(kind: str, summary, read, n: int) -> dict:
    s = read.span_s
    device = sum(sec for sec, _ in summary.by_name.values())
    out = {"host_syncs": sum(read.span_syncs.values()) / n,
           "device_s": device, "span_s_sum": sum(s.values()),
           "outside_s": s.get("", 0.0),
           "busy_s": summary.busy_s, "window_s": summary.window_s,
           "trace_idle_s": sum(read.span_idle_s.values()),
           "launches": summary.launches / n}
    if kind == "train":
        for name, keys in TRAIN:
            out[name] = 1e3 * sum(s.get(k, 0.0) for k in keys) / n
    else:
        for layer in ("attention", "moe", "generate"):
            out[f"{layer}_idle_ms"] = 1e3 * read.span_idle_s.get(layer,
                                                                 0.0) / n
        out["range_ms"] = {k: 1e3 * v / n for k, v in summary.range_s.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    cell = spec.cell(args.workload)
    summary, read, n = traced(cell, args.seed)
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "units": n,
        "device": torch.cuda.get_device_name(0),
        "readings": readings(cell.traffic["kind"], summary, read, n),
        "span_s": read.span_s, "span_syncs": read.span_syncs,
        "span_kinds_ms": {k: {kind: 1e3 * v / n
                              for kind, v in kinds(ops).items()}
                          for k, ops in read.span_ops.items()},
        "span_idle_s": read.span_idle_s,
        "idle_gaps": summary.idle_gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
