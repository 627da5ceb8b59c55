"""Fixtures of the benchmark's tests: a checkout root holding a tiny
cell (K 16 templates of L 8 frames on a 32-bin frontend, 1 s
utterances, batch 2) beside the real ones, so that a whole run goes
through on the CPU in seconds.  Tests that need a CUDA card carry the
``card`` marker and skip inside the test where none is present."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def make_root(tmp: Path, config: str = "bank10k_bf16", k: int = 16, length: int = 8,
              seconds: float = 1.0, pool: int = 4, batch: int = 2,
              control: dict | None = None) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``tmp``, with the cell ``tiny.tinymix`` added as files and entries
    (``control``: the tiny configuration's, in place of ``config``'s)."""
    bench_dir = tmp / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "benchmark" / sub, bench_dir / sub, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
    cfg["bank"].update(num_templates=k, template_length=length)
    cfg["pipeline"]["frontend"]["nfft"] = 64
    cfg["nfft"] = 39
    if control is not None:
        cfg["control"] = control
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "benchmark" / "traffic" / "long30s.json").read_text())
    mix.update(pool=pool, batch_size=batch, lengths={"kind": "fixed", "seconds": seconds},
               trace={"start_s": 0.2, "stretch_s": 0.2})
    (bench_dir / "traffic" / "tinymix.json").write_text(json.dumps(mix))
    limits = json.loads(
        (REPO / "benchmark" / "limits" / "bank10k_bf16.long30s.json").read_text())["limits"]
    (bench_dir / "limits" / "tiny.tinymix.json").write_text(json.dumps({"limits": limits}))
    bench["configs"].append({"name": "tiny", "source": "a test", "file":
                             "benchmark/configs/tiny.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.tinymix", "config": "tiny",
                               "traffic": "tinymix", "chips": 1, "why": "a test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
