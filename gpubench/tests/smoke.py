"""Small cells the CPU tests run: the benchmark's own files at the root of
a scratch directory, plus smoke-sized configurations and mixes of the same
kinds (the geometry of ``repro_torch.configs``' smoke configs, in f32),
added by files and entries alone: ``smoke-train``, ``smoke-prefill`` and
``smoke-prefill-batch`` (two prompts a request)."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from gpubench import spec

GRANITE = {"num_layers": 2, "d_model": 128, "num_heads": 4, "num_kv_heads": 2,
           "head_dim": 32, "d_ff": 128, "vocab_size": 512, "num_experts": 4,
           "experts_per_token": 2, "num_shared_experts": 0, "moe_d_ff": 128,
           "first_dense_layers": 0, "first_dense_d_ff": 0,
           "tie_embeddings": True}
DEEPSEEK = {"num_layers": 3, "d_model": 128, "num_heads": 4, "num_kv_heads": 4,
            "head_dim": 32, "d_ff": 128, "vocab_size": 512, "num_experts": 4,
            "experts_per_token": 2, "num_shared_experts": 1, "moe_d_ff": 128,
            "first_dense_layers": 1, "first_dense_d_ff": 256,
            "tie_embeddings": False}
F32 = {"dtype": "float32", "param_dtype": "float32"}
#: the cells' files (``cells/<cell>.json``): limits for f32 against f32
#: at smoke sizes, where the program and the reference agree to rounding
_PREFILL = {"limits": {**{f"{n}.{b}": 1e-4
                          for n in ("token_gap", "logit_err")
                          for b in ("short", "middle", "long")},
                       "rows_off": 0},
            "per_row": {"token_gap": 1e-3, "logit_err": 1e-3}}
SMOKE_CHECKS = {
    "smoke-train": {"limits": {"grad": 1e-3, "change": 1e-3,
                               "pooled": 1e-3, "probe": 1e-3}},
    "smoke-prefill": _PREFILL, "smoke-prefill-batch": _PREFILL}


def _smoke_config(src: dict, geometry: dict) -> dict:
    conf = copy.deepcopy(src)
    over = {k: v for k, v in geometry.items() if k != "head_dim"}
    conf["overrides"] = {**conf["overrides"], **over, **F32}
    conf["model"].update(geometry)
    conf["model"].update(F32)
    return conf


def make_root(tmp: Path) -> Path:
    """A checkout's benchmark at ``tmp`` with the cells
    ``smoke-train`` and ``smoke-prefill`` added by files alone."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp / spec.HERE.name
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, src_name, geometry in (
            ("granite-smoke", "granite-moe-1b-a400m", GRANITE),
            ("deepseek-smoke", "deepseek-moe-16b", DEEPSEEK)):
        src = spec.load_json(here / "configs" / f"{src_name}.json")
        (here / "configs" / f"{name}.json").write_text(
            json.dumps(_smoke_config(src, geometry)))
        bench["configs"].append({"name": name, "source": src["source"],
                                 "file": f"gpubench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
    train = spec.load_json(here / "traffic" / "markov-train-s1024.json")
    train.update(batch=2, seq=32)
    train["probe"] = {**train["probe"], "side": 4}
    (here / "traffic" / "smoke-train.json").write_text(json.dumps(train))
    pre = spec.load_json(here / "traffic" / "long-prefill-ladder.json")
    pre.update(ladder={"median": 64, "hi": 128, "rungs": 4, "multiple": 16},
               checked_per_rung=2, checked_cycles=2, trace_requests=4)
    (here / "traffic" / "smoke-prefill.json").write_text(json.dumps(pre))
    (here / "traffic" / "smoke-prefill-batch.json").write_text(
        json.dumps({**pre, "batch": 2}))
    for cell, config, mix in (
            ("smoke-train", "granite-smoke", "smoke-train"),
            ("smoke-prefill", "deepseek-smoke", "smoke-prefill"),
            ("smoke-prefill-batch", "deepseek-smoke", "smoke-prefill-batch")):
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "CPU"})
        (here / "cells" / f"{cell}.json").write_text(
            json.dumps(SMOKE_CHECKS[cell]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        if any(w.endswith("train-probe") for w in m["workloads"]):
            m["workloads"].append("smoke-train")
        if any(w.endswith("prefill-long") for w in m["workloads"]):
            m["workloads"] += ["smoke-prefill", "smoke-prefill-batch"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
