"""The dry run's results as one markdown table, a row an arch x shape with
both production meshes side by side.

    PYTHONPATH=src python3 scripts/dryrun_table.py [results/dryrun_torch]

Reads ``<arch>__<shape>__<mesh>.json`` as ``python -m
repro_torch.launch.dryrun --all [--multi-pod]`` writes them, and prints for
each mesh the bottleneck, the three roofline terms (compute, memory,
collective, seconds), a device's argument + temp bytes against the card's
80 GB, and the ops run replicated. A combination without its file is
"missing".
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch import configs

MESHES = ("16x16", "2x16x16")


def cell(res) -> str:
    if res is None:
        return "missing | | |"
    if not res.get("ok"):
        return "FAIL | | |"
    r, mem = res["roofline"], res["memory"]
    gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
    fits = "fits" if gb * 1e9 <= res["constants"]["device_memory_bytes"] \
        else "**over**"
    return (f"{r['bottleneck']} | {r['compute_s']:.3g} / {r['memory_s']:.3g}"
            f" / {r['collective_s']:.3g} | {gb:.1f} {fits}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else "results/dryrun_torch")
    head = " | ".join(f"{m}: bound | c / m / coll s | GB (80)"
                      for m in MESHES)
    print(f"| arch | shape | {head} | replicated |")
    print("|---|---|" + "---|---|---|" * len(MESHES) + "---|")
    for arch in configs.ALIASES:
        for shape in configs.SHAPES:
            found = {}
            for mesh in MESHES:
                path = root / f"{arch}__{shape}__{mesh}.json"
                found[mesh] = (json.loads(path.read_text())
                               if path.exists() else None)
            ops = sorted({op for res in found.values() if res
                          for op in res.get("replicated_ops", [])})
            cells = " | ".join(cell(found[m]) for m in MESHES)
            print(f"| {arch} | {shape} | {cells} | "
                  f"{', '.join(ops) or 'none'} |")


if __name__ == "__main__":
    main()
