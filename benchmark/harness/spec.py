"""What ``BENCHMARK.json`` names, found by name.

A cell (``workloads``) names a configuration and a traffic mix; the
configuration's file is the one ``configs`` gives it, the mix's is
``benchmark/traffic/<name>.json``, the limits of the numbers that decide
its ``correct`` are ``benchmark/limits/<cell>.json`` and each per-layer
metric's reader is ``benchmark/metrics/<name>.py``, under the
checkout's root.  A cell reads the per-layer
metrics whose ``workloads`` list it, or that have none.  Adding a cell,
a configuration, a mix or a metric adds files and entries; no code here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path



@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mix = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")["limits"]
    return Cell(name, int(w["chips"]), config, mix, mine(bench["end_to_end"]),
                mine(bench["per_layer"]), limits)


def metric_reader(root: Path, name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
