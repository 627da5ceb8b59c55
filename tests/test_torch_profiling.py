"""The port's ``utils.profiling`` (cost models, roofline report, named
ranges, traces) against the JAX reference's, and its
``utils.compile_cache`` on the CPU."""

from __future__ import annotations

import glob
import json
import os
import subprocess

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

from template_speech_recognition_tpu.utils import profiling as jprof
from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.utils import compile_cache
from template_speech_recognition_tpu_torch.utils import profiling as tprof

SHAPES = [
    dict(b=8, t=3000, k=1024, length=32, d=2048),
    dict(b=1, t=3000, k=1024, length=32, d=2048),
    dict(b=3, t=517, k=9, length=13, d=504),
    dict(b=2, t=64, k=1, length=64, d=8),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bytes_per_el", [1, 2, 4])
def test_direct_and_fft_scores_equal_reference(shape, bytes_per_el):
    got = tprof.CostModel.direct_scores(**shape, bytes_per_el=bytes_per_el)
    want = jprof.CostModel.direct_scores(**shape, bytes_per_el=bytes_per_el)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    for nfft in (159, 255, 1024):
        got = tprof.CostModel.fft_scores(**shape, nfft=nfft, bytes_per_el=bytes_per_el)
        want = jprof.CostModel.fft_scores(**shape, nfft=nfft, bytes_per_el=bytes_per_el)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


@pytest.mark.parametrize("samples,fl,hop,nfft,n_mels", [
    (480000, 400, 160, 512, 0), (480000, 400, 160, 512, 64), (48000, 400, 160, 1024, 129),
    (399, 400, 160, 512, 0), (16000, 320, 80, 256, 40)])
def test_frontend_and_dtw_equal_reference(samples, fl, hop, nfft, n_mels):
    for b in (1, 8):
        got = tprof.CostModel.frontend(b, samples, fl, hop, nfft, n_mels)
        want = jprof.CostModel.frontend(b, samples, fl, hop, nfft, n_mels)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    for n_pairs, length, m, band, lanes in ((984, 32, 40, 8, None), (984, 96, 104, 8, 128),
                                           (1, 1, 1, 0, None)):
        got = tprof.CostModel.dtw(n_pairs, length, m, band, lanes)
        want = jprof.CostModel.dtw(n_pairs, length, m, band, lanes)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    a, b_ = tprof.OpCost(1.0, 2.0), tprof.OpCost(3.0, 5.0)
    assert a + b_ == tprof.OpCost(4.0, 7.0)


@pytest.mark.parametrize("measured", [1e-3, 3.7374e-3, 1e-6, 0.0])
def test_roofline_report_keys_and_arithmetic(measured):
    cost = tprof.CostModel.direct_scores(8, 3000, 1024, 32, 2048)
    got = tprof.roofline_report(cost, measured)
    want = jprof.roofline_report(jprof.CostModel.direct_scores(8, 3000, 1024, 32, 2048),
                                 measured, tprof.PEAK_BF16_FLOPS, tprof.HBM_BYTES_PER_S)
    assert got == want
    assert set(got) == {"compute_s", "memory_s", "bound", "roofline_s", "roofline_frac",
                        "measured_s"}
    assert got["compute_s"] == cost.flops / 989e12
    assert got["memory_s"] == cost.hbm_bytes / 3.35e12
    assert got["bound"] == "compute" and got["roofline_s"] == got["compute_s"]
    assert got["roofline_frac"] == (got["roofline_s"] / measured if measured > 0 else 0.0)
    mem = tprof.roofline_report(tprof.OpCost(1.0, 3.35e9), 2e-3, 1e12, 3.35e12)
    assert mem["bound"] == "memory" and mem["roofline_s"] == 1e-3
    assert mem["roofline_frac"] == 0.5


def test_peaks_are_the_h100s():
    assert (tprof.HBM_BYTES_PER_S, tprof.PEAK_FP32_FLOPS, tprof.PEAK_TF32_FLOPS,
            tprof.PEAK_BF16_FLOPS, tprof.PEAK_INT8_OPS) == (3.35e12, 67e12, 495e12, 989e12,
                                                           1979e12)
    assert tprof.sm_int_ops_per_s(132, 1.98e9) == 132 * 64 * 1.98e9
    assert tprof.smem_bytes_per_s(132, 1.98e9) == 132 * 128 * 1.98e9


@pytest.mark.parametrize("n_mels", [0, 64])
def test_frontend_fused_roofline(n_mels):
    """Four resources of the card; the formula's terms by hand."""
    b, s, fl, hop, nfft = 8, 480000, 400, 160, 512
    r = tprof.CostModel.frontend_fused_roofline(b, s, fl, hop, nfft, n_mels, 1, 1,
                                                sm_count=100, sm_clock_hz=1e9)
    assert set(r) == {"tensor_s", "sm_int_s", "smem_s", "memory_s", "bound", "roofline_s"}
    t = 1 + (s - fl) // hop
    f_out = n_mels - 1 if n_mels else nfft // 2
    bins = nfft // 2 + 1
    cells = 4.0 * b * t * f_out
    tensor = 3 * 2.0 * b * t * fl * 2 * bins + (3 * 2.0 * b * t * bins * n_mels)
    assert r["tensor_s"] == pytest.approx(tensor / 495e12, rel=1e-12)
    assert r["sm_int_s"] == pytest.approx(cells * (13 + 4 * 2 / 32) / (100 * 64 * 1e9),
                                          rel=1e-12)
    assert r["smem_s"] == pytest.approx(cells * 20 / (100 * 128 * 1e9), rel=1e-12)
    hbm = b * (s * 4.0 + t * fl * 8.0 + 5 * t * f_out * 8.0)
    assert r["memory_s"] == pytest.approx(hbm / 3.35e12, rel=1e-12)
    assert r["roofline_s"] == max(r[k] for k in ("tensor_s", "sm_int_s", "smem_s", "memory_s"))
    assert r[f"{r['bound']}_s"] == r["roofline_s"]


def _trace_names(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_named_scope_as_context_and_decorator(tmp_path):
    @tprof.named_scope("decorated_stage")
    def work(x):
        return x * 2

    with tprof.profile_trace(str(tmp_path)) as prof:
        with tprof.named_scope("context_stage"):
            y = torch.ones(16) + 1
        assert torch.equal(work(y), torch.full((16,), 4.0))
        work(y)
    names = {e.name for e in prof.events()}
    assert {"context_stage", "decorated_stage"} <= names
    assert {"context_stage", "decorated_stage"} <= _trace_names(str(tmp_path))


def test_named_scope_without_a_profiler_opens_no_range(monkeypatch):
    """With no profiler running, ``named_scope`` never calls
    ``record_function``, as a context or a decorator, and gives one
    shared null context a name; under one it does."""
    from torch.profiler import ProfilerActivity, profile

    opened = []

    def spy(name):
        opened.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(tprof, "record_function", spy)

    @tprof.named_scope("decorated_stage")
    def work(x):
        return x + 1

    with tprof.named_scope("context_stage"):
        assert work(1) == 2
    assert tprof.named_scope("context_stage") is tprof.named_scope("context_stage")
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.named_scope("context_stage"):
            assert work(1) == 2
    assert opened == ["context_stage", "decorated_stage"]


def test_profile_trace_none_is_a_no_op(tmp_path):
    with tprof.profile_trace(None) as prof:
        x = torch.arange(4).sum()
    assert prof is None and int(x) == 6
    assert not os.listdir(tmp_path)


def test_profile_trace_sees_the_loops_stage_ranges(tmp_path):
    """The per-utterance loop's stages (``pipeline``: frontend, score,
    nms) by name in a CPU trace of the exact loop."""
    import numpy as np

    from oracle.fixtures import make_synthetic_corpus
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.convert import bank_from_numpy
    from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter
    from template_speech_recognition_tpu_torch.pipeline import detect_corpus

    cfg = C.PipelineConfig(detect=C.DetectConfig(exact_scores=True))
    rng = np.random.default_rng(0)
    f = cfg.frontend.feature_freqs
    bank = bank_from_numpy(rng.uniform(0.05, 0.95, (2, 8, f, 8)).astype(np.float32),
                           rng.uniform(0.05, 0.95, (f, 8)).astype(np.float32),
                           ["aa", "iy"], device="cpu")
    corpus = SyntheticAdapter(make_synthetic_corpus(num_utterances=2, phones_per_utterance=3,
                                                    seed=1))
    with tprof.profile_trace(str(tmp_path)):
        res = detect_corpus(corpus, bank, cfg, "aa")
    assert len(res.detections.scores) > 0
    assert {"frontend", "score", "nms"} <= _trace_names(str(tmp_path))


def test_enable_compile_cache_on_the_cpu_starts_no_nvcc(monkeypatch):
    started = []
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compile_cache.enable_compile_cache() == str(_cuda.BUILD_DIR)
    assert not started


def test_enable_compile_cache_builds_every_source_at_once(monkeypatch):
    """With a card, one ``_cuda.build`` call names every ``csrc`` source
    (it skips those already built)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_cuda, "build", lambda stems: calls.append(list(stems)) or {})
    assert compile_cache.enable_compile_cache() == str(_cuda.BUILD_DIR)
    srcs = sorted(os.path.splitext(n)[0] for n in os.listdir(_cuda.CSRC) if n.endswith(".cu"))
    assert calls == [srcs] and len(srcs) == 11


def test_cli_builds_only_for_the_card(monkeypatch, tmp_path):
    """``cli.main`` calls ``enable_compile_cache`` when the subcommand runs
    on cuda, not with ``--device cpu``."""
    from template_speech_recognition_tpu_torch import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: calls.append(1))
    real = cli.build_parser

    def parser():
        p = real()
        for sub in p._subparsers._group_actions[0].choices.values():
            sub.set_defaults(fn=lambda args: 0)
        return p

    monkeypatch.setattr(cli, "build_parser", parser)
    bank = str(tmp_path / "bank.npz")
    assert cli.main(["classify", "--bank", bank, "--device", "cpu"]) == 0
    assert calls == []
    assert cli.main(["classify", "--bank", bank]) == 0
    assert cli.main(["classify", "--bank", bank, "--device", "cuda:0"]) == 0
    assert calls == [1, 1]
