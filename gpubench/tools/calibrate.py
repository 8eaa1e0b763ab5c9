"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed the numbers its kind's check compares
(``kinds/<kind>.py``, ``readings``) of the program (the lower readings),
of the control (the reference in float8 put in the program's place: the
upper readings) and, where the kind plants one, of a fault (a train
cell: half of each batch left out; a state left unchanged reads 1 by the
measure and needs no run).

    python3 gpubench/tools/calibrate.py --workload <cell> --seeds 12 \\
        [--control-seeds 3] [--fault-seeds 3] [--first-seed N]

One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench import inputs, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 12345)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    readings = cell.kind.readings
    for k in range(args.seeds):
        seed = inputs.mix64(args.first_seed, k) % (2 ** 33)
        t0 = time.perf_counter()
        for who, nums, notes in readings(cell, seed, k < args.control_seeds,
                                         k < args.fault_seeds):
            print(json.dumps({"seed": seed, "who": who, "numbers": nums,
                              "notes": notes,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
