"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each sits in a file of its own, found by name:

- ``configs/<config>.json``: the model as it is run (``model``), the
  architecture's name in ``repro_torch.configs`` (``arch``) and the
  overrides applied to it, the model family's plain reference
  (``reference``: ``reference/<family>.py``, which also names the
  weights), the program's functions the traced run wraps in ranges
  (``ranges``), with ``source``, ``reduced``, ``departs`` and ``assumed``;
- ``traffic/<mix>.json``: the kind and its parameters, read by the one
  generator of that kind, ``kinds/<kind>.py``, which also holds the
  numbers its check compares and the readings its limits are set from;
- ``cells/<workload>.json``: the limit of each number the check of
  ``correct`` compares;
- ``metrics/<metric>.py``: one reader a per-layer metric, a ``read(ctx)``
  that returns a number, or None where its cell has nothing to read.

Kinds, families and readers are loaded from the files of the benchmark
at hand, by name, so a cell that brings a kind or a family of its own
needs no edit elsewhere.

A later cell, mix, configuration or metric is added by adding such files
and entries, never by editing one that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(root: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark at ``root``."""
    path = root / HERE.name / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in {root / HERE.name}")
    key = f"gpubench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    check: dict           # cells/<workload>.json
    end_to_end: list      # the cell's entries of ``end_to_end``
    per_layer: list       # the cell's entries of ``per_layer``
    chips: int
    kind: object          # kinds/<traffic's kind>.py
    family: object        # reference/<config's reference>.py


def _metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``, its files read.
    Raises KeyError for a name the benchmark does not hold."""
    bench = benchmark(root)
    here = root / HERE.name
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(root / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _metric_applies(m, workload)]
    # a per-layer metric belongs to the cells that report the end-to-end
    # metric it moves (and, where it lists them, to those cells alone)
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _metric_applies(m, workload)]
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, config=conf, traffic=traffic,
                check=load_json(here / "cells" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer, chips=int(w["chips"]),
                kind=load_module(root, "kinds", traffic["kind"]),
                family=load_module(root, "reference", conf["reference"]))


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return load_module(root, "metrics", name).read
