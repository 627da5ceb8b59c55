"""The port's on-card parity gate on the CPU: ``verify_cuda.py``.

With ``--device cpu`` every check runs the plain versions at the
reference check's own shapes, seeds and gates (``verify_tpu.py``'s 15,
in its order), against the same NumPy oracle, and each passes; the JSON
it writes has ``PARITY_TPU.json``'s top-level keys, and each check
``kernel``, ``ok`` and ``seconds``.  A check whose plain version is
patched to return wrong values fails, and so does the run (``all_ok``
false, exit code 1).  Without a GPU and without ``--device cpu``,
``verify_cuda.py``, ``soak_cuda.py`` and ``soak_bank10k_cuda.py`` run as
``__main__`` exit non-zero and print no result.
"""

from __future__ import annotations

import json
import os
import runpy
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import verify_cuda
import verify_tpu
from template_speech_recognition_tpu_torch.ops import (
    binspread_kernel,
    correlation_kernel,
    dtw_kernel,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_NAMES = [fn.__name__ for fn in verify_cuda.CHECKS]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity")
    rc = verify_cuda.main(["--device", "cpu", "--out", str(out)])
    with open(out / verify_cuda.OUT_NAME) as f:
        return rc, json.load(f)


def test_checks_are_the_reference_checks():
    assert CHECK_NAMES == [fn.__name__ for fn in verify_tpu.CHECKS]
    assert len(CHECK_NAMES) == 15


@pytest.mark.parametrize("index", range(15), ids=CHECK_NAMES)
def test_check_passes_on_cpu(parity, index):
    """Each check, its plain versions against the reference check's
    oracle and gate: ``ok``, with a finite error measure."""
    _rc, out = parity
    r = out["kernels"][index]
    assert r["ok"], r
    assert "error" not in r
    measures = {k: v for k, v in r.items() if k not in ("kernel", "ok", "seconds")}
    assert measures and all(v == v for v in measures.values())      # no NaN


def test_parity_json_has_the_reference_keys(parity):
    rc, out = parity
    with open(os.path.join(REPO, "PARITY_TPU.json")) as f:
        ref = json.load(f)
    assert rc == 0
    assert set(out) == set(ref)
    assert (out["backend"], out["device"], out["compiled"], out["all_ok"]) == (
        "cpu", "cpu", False, True)
    assert len(out["kernels"]) == len(ref["kernels"]) == 15
    for r in out["kernels"]:
        assert {"kernel", "ok", "seconds"} <= set(r)
        # the launch and trace proof is the card's alone
        assert "launches" not in r and "cuda_functions" not in r


@pytest.mark.parametrize("only,module,plain", [
    ("correlation", correlation_kernel, "correlation_scores_plain"),
    ("dtw", dtw_kernel, "banded_dtw_plain"),
    ("binspread_kernel", binspread_kernel, "binarize_freqspread_plain"),
])
def test_wrong_plain_version_fails(monkeypatch, tmp_path, capsys, only, module, plain):
    """A plain version patched to return wrong values: its check gives
    ``ok: false``, the run ``all_ok: false`` and exit code 1."""
    real = getattr(module, plain)
    monkeypatch.setattr(module, plain, lambda *a, **k: 1 - real(*a, **k))
    assert verify_cuda.main(["--device", "cpu", "--out", str(tmp_path), "--only", only]) == 1
    with open(tmp_path / verify_cuda.OUT_NAME) as f:
        out = json.load(f)
    assert out["all_ok"] is False
    assert [r["ok"] for r in out["kernels"]] == [False]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["parity_cuda_all_ok"] is False and last["failed"] == [out["kernels"][0]["kernel"]]


@pytest.mark.parametrize("script", ["verify_cuda.py", "soak_cuda.py", "soak_bank10k_cuda.py"])
def test_without_gpu_exits_nonzero(monkeypatch, capsys, script):
    path = os.path.join(REPO, script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(path, run_name="__main__")
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert not out.out.strip() and "no CUDA device" in out.err
