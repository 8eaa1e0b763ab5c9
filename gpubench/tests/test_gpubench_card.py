"""The benchmark on the card: each cell runs through the command of
``BENCHMARK.json`` for ``run_seconds`` and prints a correct result line,
and the control is not correct at the cell's own size. Marked ``gpu``;
skips where there is no card.

    python3 -m pytest -q -m gpu gpubench/tests/test_gpubench_card.py
"""
from __future__ import annotations

import json
import subprocess

import pytest
import torch

from gpubench import spec

BENCH = spec.benchmark()


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(BENCH["command"] + [
        "--workload", workload, "--seed", str(2 ** 32 + 77),
        "--seconds", str(BENCH["run_seconds"]),
        "--trace", str(trace)], cwd=spec.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    cell = spec.cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_at_the_cells_size(workload):
    """On three seeds at the cell's own size, the program is correct and
    the control (the reference in float8 in the program's place) is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from gpubench import check
    cell = spec.cell(workload)
    for k in range(3):
        for who, nums, _ in cell.kind.readings(cell, 2 ** 32 + 1000 + k,
                                               control=True, fault=False):
            ok, report = check.judge(nums, cell.check["limits"])
            assert ok == (who == "program"), (who, report)
