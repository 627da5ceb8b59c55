"""The comparison fails what it has to fail.

On the CPU at a size a test run holds (the tiny cell of ``conftest``,
the bf16 cell's limits): the timed path broken underneath a whole run
(half of each batch left out; one answer altered where it is produced;
one detection moved off its peak), and each kind of control that a
configuration can name (a ``pipeline`` override: the program's own int8
spectra; ``reference_bits``: the reference in int4 in the program's
place), all read ``correct`` false, while the sound run reads true.  The
card's test runs each cell's control at the cell's own size on three
seeds.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import REPO, make_root
from template_speech_recognition_tpu_torch import scan


def _run(root, seed=101, control=False):
    return run.run_cell("tiny.tinymix", seed, 1.5, False, torch.device("cpu"), root=root,
                        control=control, log=lambda _m: None)


def _half_left_out(orig):
    def step(*a, **k):
        s, t, kid = orig(*a, **k)
        s = s.clone()
        s[s.shape[0] // 2:] = float("-inf")
        return s, t, kid
    return step


def _answer_altered(orig):
    def step(*a, **k):
        s, t, kid = orig(*a, **k)
        kid = kid.clone()
        kid[0, 0] = (kid[0, 0] + 1) % 16
        return s, t, kid
    return step


def test_sound_run_is_correct(tmp_path):
    out = _run(make_root(tmp_path))
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(scan, "scan_step", fault(scan.scan_step))
    out = _run(make_root(tmp_path))
    assert not out["correct"] and out["failed"] > 0


def test_nms_fault_is_not_correct(tmp_path, monkeypatch):
    """NMS that suppresses nothing (radius 0): the top windows come back
    with their own scores and templates, so the score and winner gaps
    stay nought, and the peak gap and the peaks missed must see it."""
    orig = scan.batched_top_detections

    def top(scores, valid, length, _radius, top_k, time_major):
        return orig(scores, valid, length, 0, top_k, time_major)

    monkeypatch.setattr(scan, "batched_top_detections", top)
    out = _run(make_root(tmp_path))
    assert not out["correct"], out["check"]
    assert out["check"]["score_rms"]["value"] < out["check"]["score_rms"]["limit"]


@pytest.mark.parametrize("control", [
    {"name": "int8", "pipeline": {"detect": {"int8_spectra": True}}},
    {"name": "int4", "reference_bits": 4},
], ids=["pipeline", "reference_bits"])
def test_control_is_not_correct(tmp_path, control):
    out = _run(make_root(tmp_path, k=64, control=control), control=True)
    assert not out["correct"], out["check"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_control_on_the_card(cell):
    """The cell's control at the cell's own size and load, three seeds,
    each ``correct`` false (a short window: the check reads every scan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
             "--seconds", "5", "--trace", "0", "--control"],
            cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["control"] and line["correct"] is False, line["check"]
