"""The benchmark of ``repro_torch`` on NVIDIA H100 cards: one run of one
cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell's files are found by the names in
``BENCHMARK.json`` (``gpubench/spec.py``). A run builds its inputs and
weights from ``--seed``, warms every shape it uses, measures for
``--seconds``, then checks what the timed path produced against the plain
reference (``gpubench/check.py``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit, which the last lines of standard error
repeat.

Without a card, with fewer cards than the cell asks for, or when the
process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
after the window, it prints no result and exits with 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names the process may not hold, compared whole
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed directory of the checkout,
    so a second run there finds what the first built. The port's kernel
    library builds into ``build/repro_torch`` by itself."""
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / "gpubench_cache" / sub)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _metric_lines(entries: list, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in entries if values.get(m["name"]) is not None}


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, **fault) -> dict:
    """Runs ``cell`` once on ``device`` and returns the result's object;
    ``fault``, from a test, breaks the timed path underneath."""
    import torch

    from gpubench import check, spec
    out = cell.kind.run(cell, seed=seed, seconds=seconds, trace=trace,
                        device=device, **fault)
    t_ref = time.perf_counter()
    reference = out["reference"]()
    nums, notes = cell.kind.numbers(out["program"], reference, cell.check)
    notes["reference_s"] = time.perf_counter() - t_ref
    correct, report = check.judge(nums, cell.check["limits"])
    cuda = torch.device(device).type == "cuda"
    ctx = {**out["ctx"], "model": cell.config["model"],
           "device_name": torch.cuda.get_device_name(0) if cuda else "cpu"}
    if trace:
        values = {m["name"]: spec.metric_reader(m["name"])(ctx)
                  for m in cell.per_layer}
        metrics = _metric_lines(cell.per_layer, values)
    else:
        values = {"setup_s": out["setup_done"] - t_start, **out["e2e"]}
        metrics = _metric_lines(cell.end_to_end, values)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx["device_name"],
           "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        s = ctx["summary"]
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:160], t] for n, t in s.device_ops],
            "idle_gaps": [[n[:160], t] for n, t in s.idle_gaps]}
    result["notes"] = notes
    result["check"] = report
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from gpubench import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda")
    found = forbidden_modules()
    if found:
        print(f"gpubench: the process holds {found} after the window",
              file=sys.stderr)
        return 2
    for name, r in result["check"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
