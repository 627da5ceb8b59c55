"""A run's last line, its refusal without a card, and what it loads."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import torch

from benchmark import run
from benchmark.tests.conftest import REPO

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_keys(tiny_root):
    out = run.run_cell("tiny.tinymix", 2**31 + 11, 1.5, False, torch.device("cpu"),
                       root=tiny_root, log=lambda _m: None)
    line = run.result_line(out, "cpu", 1, "none", False)
    assert list(line)[:5] == CONTRACT_KEYS and list(line)[-1] == "check"
    assert set(line["metrics"]) == {"scan_audio_s_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert line["attempted"] > 0 and line["failed"] == 0 and line["correct"] is True
    for v in line["check"].values():
        assert set(v) == {"value", "limit"} and 0 <= v["value"] <= v["limit"]
    json.dumps(line)


def test_traced_run_reports_per_layer_metrics(tiny_root):
    out = run.run_cell("tiny.tinymix", 7, 5.0, True, torch.device("cpu"),
                       root=tiny_root, log=lambda _m: None)
    line = run.result_line(out, "cpu", 1, "none", True)
    assert "scan_audio_s_per_s" not in line["metrics"]
    assert "scan_mfu" in line["metrics"]        # the CPU trace has no device event
    assert {"device_idle_share", "binmm_bf16_roofline"}.isdisjoint(line["metrics"])


def test_no_card_no_result():
    """Without a CUDA device a run exits non-zero and prints nothing on
    standard output."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bank10k_bf16.long30s",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        return
    assert proc.returncode != 0 and proc.stdout == ""


def test_same_seed_same_inputs():
    from benchmark.harness import traffic
    from benchmark.harness.bank import make_templates

    mix = json.loads((REPO / "benchmark/traffic/timit.json").read_text())
    mix["pool"] = 6
    a, b = traffic.make_pool(mix, 2**31 + 5), traffic.make_pool(mix, 2**31 + 5)
    assert all((x == y).all() for x, y in zip(a, b))
    assert sorted(map(len, a)) == sorted(map(len, traffic.make_pool(mix, 3)))
    bank = {"num_templates": 3, "template_length": 2, "prob_low": 0.01, "prob_high": 0.99}
    t1 = make_templates(bank, {"nfft": 16}, 2**31 + 5, "cpu")
    t2 = make_templates(bank, {"nfft": 16}, 2**31 + 5, "cpu")
    assert torch.equal(t1[0], t2[0]) and torch.equal(t1[1], t2[1])
    assert 0.01 <= float(t1[0].min()) and float(t1[0].max()) < 0.99


def _modules_after(code: str) -> set[str]:
    src = textwrap.dedent(code) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
    """)
    proc = subprocess.run([sys.executable, "-c", src], cwd=REPO, capture_output=True,
                          text=True, timeout=600, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(tmp_path):
    """Importing the harness and a whole run of a tiny cell on the CPU
    load no module named jax, jaxlib, flax or the JAX package (top-level
    names compared whole)."""
    from benchmark.tests.conftest import make_root

    make_root(tmp_path)
    loaded = _modules_after(f"""
        import torch
        from pathlib import Path
        from benchmark import run
        run.run_cell("tiny.tinymix", 3, 0.3, True, torch.device("cpu"),
                     root=Path({str(tmp_path)!r}), log=lambda _m: None)
        assert run.banned_modules() == []
    """)
    assert "template_speech_recognition_tpu_torch" in loaded
    assert loaded.isdisjoint({"jax", "jaxlib", "flax", "template_speech_recognition_tpu"})


def test_reference_loads_nothing_of_the_program():
    """The reference, imported and run on a tiny utterance and bank,
    loads nothing of the port, of oracle/, chip_smoke.py, bench_cuda.py
    or JAX."""
    loaded = _modules_after("""
        import numpy as np, torch
        from benchmark.reference import check, control, frontend, judge, score
        rng = np.random.default_rng(0)
        wave = torch.from_numpy(rng.standard_normal(16000).astype(np.float32))
        fcfg = dict(sample_rate=16000, frame_length=400, hop_length=160, nfft=64,
                    preemphasis=0.95, edge_quantile=0.98, spread_time=1, spread_freq=1)
        lo, amb = frontend.edge_map(wave, fcfg, 1e-4)
        p = torch.rand(4, 3, 32, 8) * 0.98 + 0.01
        wt, c = score.llr_rows(p, torch.full((32, 8), 0.3))
        s_lo, s_hi = score.interval_scores(lo.reshape(lo.shape[0], -1),
                                           amb.reshape(amb.shape[0], -1), wt, c)
        dets = control.top_detections(s_lo, 10, 8)
        g = judge.utterance_gaps(s_lo, s_hi, tuple(d[None] for d in dets), 8, 10)
        assert float(g[:, :8].max()) == 0.0 and float(g[:, 10].max()) == 0.0
    """)
    banned = {"template_speech_recognition_tpu_torch", "template_speech_recognition_tpu",
              "oracle", "chip_smoke", "bench_cuda", "jax", "jaxlib", "flax"}
    assert loaded.isdisjoint(banned), loaded & banned
