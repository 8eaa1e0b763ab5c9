"""The harness on the CPU: it finds every cell, configuration, mix and
metric by name, a cell added by files alone too; its configuration files
are what the program runs; its arithmetic matches hand counts; and
nothing it runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from gpubench import flops, inputs, program, spec, weights
from gpubench.tests import smoke

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = spec.cell(workload)
    for fn in ("run", "numbers", "readings"):
        assert callable(getattr(cell.kind, fn))
    for fn in ("groups", "layer_leaves", "loss", "last_logits"):
        assert callable(getattr(cell.family, fn))
    assert cell.check["limits"]
    assert all(isinstance(v, (int, float)) for v in
               cell.check["limits"].values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_is_what_the_program_runs(conf):
    data = spec.load_json(spec.ROOT / conf["file"])
    cfg = program.model_config(data)       # raises on any difference
    assert data["reduced"] == conf["reduced"] == []
    model = program.build_model(cfg, "meta")
    family = spec.load_module(spec.ROOT, "reference", data["reference"])
    weights.check_matches(family, data["model"],
                          dict(model.named_parameters()))
    for module, attr in program.layer_ranges(data).values():
        assert callable(getattr(module, attr))


def test_configuration_file_that_differs_is_refused():
    data = spec.load_json(spec.ROOT / BENCH["configs"][0]["file"])
    data["model"]["num_layers"] += 1
    with pytest.raises(RuntimeError, match="num_layers"):
        program.model_config(data)


def test_benchmark_file_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    root = smoke.make_root(tmp_path)
    for name in ("smoke-train", "smoke-prefill", "smoke-prefill-batch"):
        cell = spec.cell(name, root)
        assert cell.config["model"]["d_model"] == 128
        assert [m["name"] for m in cell.per_layer]
    assert spec.cell("smoke-prefill-batch", root).traffic["batch"] == 2
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", root)


STUB_KIND = """
def run(cell, *, seed, seconds, trace, device):
    return {"setup_done": 0.0, "attempted": 3, "failed": 0,
            "e2e": {"stub_per_s": cell.family.answer() + seed % 2},
            "ctx": {"stub": seconds}, "peak_bytes": 0,
            "program": cell.family.answer(),
            "reference": lambda: cell.family.answer()}


def numbers(program, reference, check):
    return {"gap": abs(program - reference)}, {}


def readings(cell, seed, control, fault, device="cuda"):
    return [("program", *numbers(1, 1, cell.check))]
"""
STUB_FAMILY = """
def answer():
    return 42.0
"""


def test_a_kind_and_a_family_added_by_files_alone_run(tmp_path):
    """A cell of a new kind on a configuration of a new family, added by
    new files and entries alone, runs through the harness: its kind, its
    family and its metric's reader are found by name."""
    root = smoke.make_root(tmp_path)
    here = root / spec.HERE.name
    (here / "kinds" / "stub.py").write_text(STUB_KIND)
    (here / "reference" / "stub_family.py").write_text(STUB_FAMILY)
    (here / "configs" / "stub.json").write_text(json.dumps(
        {"reference": "stub_family", "model": {}}))
    (here / "traffic" / "stub.json").write_text(json.dumps({"kind": "stub"}))
    (here / "cells" / "stub-cell.json").write_text(json.dumps(
        {"limits": {"gap": 0.0}}))
    (here / "metrics" / "stub_ms.py").write_text(
        "def read(ctx):\n    return ctx.get('stub')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "none",
                             "file": "gpubench/configs/stub.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "stub-cell", "config": "stub",
                               "traffic": "stub", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "stub_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["stub-cell"]})
    bench["per_layer"].append({"name": "stub_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "stub", "moves": "stub_per_s",
                               "workloads": ["stub-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("stub-cell", root)
    from gpubench import run
    res = run.run_cell(cell, seed=2 ** 33, seconds=0.5, trace=False,
                       device="cpu")
    assert res["correct"] and res["metrics"]["stub_per_s"]["value"] == 42.0
    assert set(res["metrics"]) == {"stub_per_s", "setup_s"}
    assert spec.metric_reader("stub_ms", root)({"stub": 0.5}) == 0.5


def test_flops_match_hand_counts():
    granite = spec.load_json(spec.ROOT / "gpubench/configs/"
                             "granite-moe-1b-a400m.json")["model"]
    deepseek = spec.load_json(spec.ROOT / "gpubench/configs/"
                              "deepseek-moe-16b.json")["model"]
    # granite: per layer attention 2*1024*1024 + 2*1024*512, router
    # 1024*32, 8 experts of 3*1024*512; 24 layers
    assert flops.active_block_params(granite) == 24 * (
        3_145_728 + 32_768 + 8 * 1_572_864) == 378_273_792
    # deepseek: the dense first layer (attention + 3*2048*10944) and 27
    # MoE layers (attention, router 2048*64, 6 + 2 experts of 3*2048*1408)
    assert flops.active_block_params(deepseek) == (
        16_777_216 + 67_239_936 + 27 * (16_777_216 + 131_072 + 69_206_016)
    ) == 2_409_103_360
    # a granite step at B 4 x S 1,024: 6 T (blocks + head) plus three
    # times the causal attention's forward, 4 B H hd S(S+1)/2 a layer
    matrices = 6 * 4096 * (378_273_792 + 49_155 * 1024)
    attention = 3 * 24 * 4 * 4 * 16 * 64 * (1024 * 1025 // 2)
    assert flops.train_step_flops(granite, 4, 1024) == matrices + attention
    assert abs(flops.train_step_flops(granite, 4, 1024) / 1e12 - 11.15) < 0.01
    assert flops.bf16_peak("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.bf16_peak("NVIDIA H100 PCIe") == 756e12


def test_ladder_and_orders():
    lad = inputs.length_ladder(512, 4096, 32, 64)
    assert len(lad) == 32 and min(lad) == 512 and max(lad) == 3968
    assert abs(sum(lad) / 32 - 1722) < 1
    mix = spec.load_json(spec.HERE / "traffic" / "long-prefill-ladder.json")
    lad = inputs.ladder(mix["ladder"])
    # a median of 1,500 and the 4,096 context: lo = 1,500^2 / 4,096
    assert lad == inputs.length_ladder(1500 ** 2 / 4096, 4096, 32, 64)
    assert sorted(lad)[15:17] == [1472, 1536] and max(lad) == 3968
    a = inputs.permutation(2 ** 40 + 3, 32, 5)
    assert sorted(a) == list(range(32))
    assert a == inputs.permutation(2 ** 40 + 3, 32, 5)
    assert a != inputs.permutation(2 ** 40 + 4, 32, 5)


def test_weights_are_the_seeds_and_groups_stand_alone():
    m = smoke._smoke_config(spec.load_json(
        spec.ROOT / "gpubench/configs/deepseek-moe-16b.json"),
        smoke.DEEPSEEK)["model"]
    fam = spec.load_module(spec.ROOT, "reference", "moe_lm")
    a = weights.make_group(fam, m, "blocks.1", 2 ** 35 + 1, "cpu")
    b = weights.make_group(fam, m, "blocks.1", 2 ** 35 + 1, "cpu")
    c = weights.make_group(fam, m, "blocks.1", 2 ** 35 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.1.moe.wg"], c["blocks.1.moe.wg"])
    assert float(a["blocks.1.ln1"].abs().sum()) == 0.0
    assert abs(float(a["blocks.1.attn.wq"].std()) - 128 ** -0.5) < 0.01


FORBIDDEN_CHECK = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from gpubench import run, spec
from gpubench.tests import smoke
root = smoke.make_root(Path(tempfile.mkdtemp()))
for name in ("smoke-train", "smoke-prefill"):
    res = run.run_cell(spec.cell(name, root), seed=2 ** 34 + 1, seconds=0.5,
                       trace=False, device="cpu")
    assert res["correct"], res
    for m in spec.cell(name, root).per_layer:
        spec.metric_reader(m["name"])
print(json.dumps(run.forbidden_modules()))
"""


def test_nothing_it_runs_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c",
                          FORBIDDEN_CHECK.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = sorted((spec.HERE / "reference").glob("*.py"))
    assert ref
    for path in ref:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.reference.moe_lm, gpubench.reference.afm_probe, "
            "gpubench.reference.common; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib'}))" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
