"""BENCHMARK.json against the contract's form, and what it names found
by name; a cell, configuration, mix and metric added as files."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_found_by_name(cell):
    c = spec.find_cell(REPO, cell)
    assert c.chips == 1
    assert c.config["bank"]["num_templates"] == 10000
    assert c.mix["batch_size"] in (8, 32)
    assert {m["name"] for m in c.end_to_end} == {"scan_audio_s_per_s", "setup_s"}
    for m in c.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]))
    assert "binmm_bf16_roofline" in {m["name"] for m in c.per_layer}
    assert c.config["control"]["name"]


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/") and (REPO / f).is_file()


def test_a_new_cell_added_as_files(tmp_path):
    """A configuration, a mix and a metric reader added as new files and
    entries are found, and the metric is read in a run, no code changed."""
    from benchmark.tests.conftest import make_root

    from benchmark import run

    root = make_root(tmp_path)
    (root / "benchmark" / "metrics" / "batches_seen.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('batches')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "host loop, scan.stream_scan",
                               "moves": "scan_audio_s_per_s", "workloads": ["tiny.tinymix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(root, "tiny.tinymix")
    assert cell.mix["pool"] == 4 and cell.config["bank"]["num_templates"] == 16
    out = run.run_cell("tiny.tinymix", 5, 0.5, True, torch.device("cpu"), root=root,
                       log=lambda _m: None)
    assert out["metrics"]["batches_seen"]["value"] > 0
    assert out["correct"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_limits(cell):
    from benchmark.reference.judge import NUMBERS

    limits = spec.find_cell(REPO, cell).limits
    assert limits and set(limits) <= set(NUMBERS)
    assert all(0 < v < 1 for v in limits.values())
