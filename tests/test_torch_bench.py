"""The port's benchmark on the CPU: the CLI's ``bench`` and ``bench_cuda.py``.

At a tiny workload (B 2, T 300, K 16, L 8) with ``--device cpu``: the
script's ``main`` (the end-to-end scan over 2 utterances, twice: its
constants patched) prints one JSON line with every key of the
reference's ``bench.py`` (its ``tpu_*`` keys named for the card), and
the CLI's ``bench`` with ``BENCH_E2E=0`` the keys ``bench.py`` prints
then; the parser takes the reference's ``bench`` flags, and without a
GPU and without ``--device cpu`` the CLI and the script run as
``__main__`` exit non-zero.  Each backend's timed call computes the
NumPy oracle's scores.
"""

from __future__ import annotations

import ast
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import bench_cuda
from oracle.score import sliding_score
from template_speech_recognition_tpu import cli as jcli
from template_speech_recognition_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_cuda.py")
TINY = {"BENCH_B": "2", "BENCH_T": "300", "BENCH_K": "16", "BENCH_L": "8"}


def _bench_py_keys() -> set[str]:
    """The keys of the reference ``bench.py``'s JSON line (the ``result``
    dict and the keys it adds), ``tpu_*`` renamed ``h100_*``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return {k.replace("tpu_", "h100_", 1) if k.startswith("tpu_") else k for k in keys}


BENCH_KEYS = _bench_py_keys()
E2E_KEYS = {"e2e_audio_s_per_s", "e2e_frac_of_kernel", "frontend_audio_s_per_s"}


def _check_line(line: dict, backend: str, e2e: bool = True) -> None:
    want = BENCH_KEYS if e2e else BENCH_KEYS - E2E_KEYS
    assert want <= set(line), want - set(line)
    assert e2e or not E2E_KEYS & set(line)
    assert line["backend"] == backend and line["value"] > 0 and line["vs_baseline"] > 0
    assert (line["bank_k"], line["template_len"], line["batch_utts"],
            line["frames_per_utt"]) == (16, 8, 2, 300)
    # CPU numbers never stand under the card's names
    assert line["h100_step_ms"] is None and line["h100_effective_tflops"] is None
    assert line["cpu_step_ms"] > 0 and line["card"] is None
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    if e2e:
        assert len(line["e2e_audio_s_per_s_runs"]) == 2 and line["e2e_audio_s_per_s"] > 0
        assert line["e2e_spread"] >= 1.0


def test_bench_py_keys_are_known():
    assert BENCH_KEYS >= {"metric", "value", "unit", "vs_baseline", "h100_step_ms",
                          "h100_effective_tflops", "cpu_oracle_audio_s_per_s", "backend",
                          "timing"} | E2E_KEYS
    assert not any(k.startswith("tpu_") for k in BENCH_KEYS)


def _tiny(monkeypatch, backend: str, e2e: bool = False) -> None:
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_BACKEND", backend)
    monkeypatch.setenv("BENCH_E2E", "1" if e2e else "0")


def test_cli_bench_prints_bench_keys(monkeypatch, capsys):
    """The CLI runs the script given by ``--bench-script`` through
    ``runpy`` and restores ``sys.argv``: with ``BENCH_E2E=0``, one line
    with the scorer's keys only, as in ``bench.py``."""
    _tiny(monkeypatch, "fft")
    argv = sys.argv
    assert cli.main(["bench", "--bench-script", BENCH, "--device", "cpu"]) == 0
    assert sys.argv == argv
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    _check_line(json.loads(out[-1]), "fft", e2e=False)


def test_cli_bench_without_e2e(monkeypatch, capsys):
    """The default script, ``BENCH_E2E=0``: the scorer's keys only."""
    _tiny(monkeypatch, "conv")
    assert cli.main(["bench", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    _check_line(json.loads(out[-1]), "conv", e2e=False)


def test_bench_cuda_script_prints_bench_keys(monkeypatch, capsys):
    """The script's ``main`` with the end-to-end scan: every key of
    ``bench.py``, the scans' rates on the line before."""
    _tiny(monkeypatch, "pallas", e2e=True)
    monkeypatch.setattr(bench_cuda, "E2E_UTTS", 2)
    monkeypatch.setattr(bench_cuda, "E2E_REPS", 2)
    assert bench_cuda.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "e2e audio-s/s of 2 scans" in out[-2]
    _check_line(json.loads(out[-1]), "pallas")


def test_bench_parser_takes_the_reference_flags():
    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {s for a in sub.choices["bench"]._actions for s in a.option_strings}

    assert flags(jcli.build_parser()) <= flags(cli.build_parser())
    args = cli.build_parser().parse_args(["bench", "--bench-script", "x.py"])
    assert args.fn is cli.cmd_bench and args.bench_script == "x.py" and args.device is None
    default = cli.build_parser().parse_args(["bench"]).bench_script
    assert os.path.samefile(default, BENCH)


def test_bench_without_gpu_exits_nonzero(monkeypatch, capsys):
    """No GPU and no ``--device cpu``: the CLI's ``bench`` returns the
    script's 2 and the script exits 2, printing no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench"]) == 2
    monkeypatch.setattr(sys, "argv", [BENCH])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(BENCH, run_name="__main__")
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert not out.out.strip() and out.err.count("no CUDA device") == 2


@pytest.mark.parametrize("backend", ["fft", "conv", "pallas"])
def test_bench_scorer_computes_the_oracle_scores(backend):
    """The timed call of each backend on the CPU scores the bench's
    workload as ``oracle.score.sliding_score`` does (float32 class:
    1e-4 x max|score|; conv and pallas round the operands to bf16, which
    the oracle gets too)."""
    b, t, k, length, f, e = 2, 60, 5, 8, 8, 8
    fn = bench_cuda.scorer_call(torch, backend, (b, t, k, length, f * e), torch.device("cpu"))
    got = fn()
    g = torch.Generator(device="cpu").manual_seed(0)
    feats = (torch.rand((b, t, f * e), generator=g) < 0.15).to(torch.float32)
    w = torch.randn((k, length, f * e), generator=g)
    c = torch.randn((k,), generator=g)
    tv = t - length + 1
    if backend == "fft":
        got = got[:, :tv].transpose(1, 2)                  # time-major, untrimmed
    else:
        w = w.to(torch.bfloat16).to(torch.float32)
    assert tuple(got.shape) == (b, k, tv)
    for i in range(b):
        want = sliding_score(feats[i].numpy().reshape(t, f, e),
                             w.numpy().reshape(k, length, f, e), c.numpy())
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
