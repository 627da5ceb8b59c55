"""The harness's reckoning: the scan's batches from the lengths fed, the
work formulas, and the trace arithmetic."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark.harness import buckets, cost, trace
from benchmark.harness.spec import metric_reader
from benchmark.tests.conftest import REPO
from template_speech_recognition_tpu_torch import scan
from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.utils.profiling import CostModel


class Lengths:
    sample_rate = 16000

    def __init__(self, lengths):
        self.lengths = lengths

    def iter_utterances(self):
        for i, n in enumerate(self.lengths):
            yield f"u{i}", np.zeros(n, np.float32), []


@pytest.mark.parametrize("batch", [1, 3, 8, 32])
def test_batches_as_the_scan_makes_them(batch):
    """``buckets.plan`` against the batches ``scan.stream_scan`` runs."""
    rng = np.random.default_rng(batch)
    lengths = [int(n) for n in rng.integers(400, 5 * 16384, 97)]
    seen = []

    def compute(wavs, vs, _marks):
        seen.append((wavs.shape[1], wavs.shape[0], int((vs > 0).sum())))
        b = wavs.shape[0]
        return (torch.zeros((b, 2)), torch.zeros((b, 2), dtype=torch.int32),
                torch.zeros((b, 2), dtype=torch.int32))

    scan.stream_scan(Lengths(lengths), FrontendConfig(), batch, compute, 1,
                     torch.device("cpu"))
    want = [(b.pad, b.rows, b.used) for b in buckets.plan(lengths, batch)]
    assert seen == want
    mirror = buckets.Mirror(batch)
    for n in lengths:
        mirror.feed(n)
    assert [(b.pad, b.rows, b.used) for b in mirror.close()] == want


@pytest.mark.parametrize("shape", [
    dict(b=8, t=3069, k=10000, length=32, d=2048, nfft=223),
    dict(b=32, t=406, k=1024, length=32, d=2048, nfft=159),
])
def test_work_formulas_against_the_cost_model(shape):
    ops, nbytes = cost.fft_scores(**shape)
    ref = CostModel.fft_scores(**shape)
    assert ops == ref.flops and nbytes == ref.hbm_bytes
    ops1, nbytes1 = cost.fft_scores(**shape, spectra_bytes=1)
    bins = shape["nfft"] // 2 + 1
    assert ops1 == ops and nbytes - nbytes1 == bins * 2 * shape["d"] * shape["k"]
    f_ops, f_bytes = cost.frontend(shape["b"], 491520, 400, 160, 512)
    f_ref = CostModel.frontend(shape["b"], 491520, 400, 160, 512)
    assert (f_ops, f_bytes) == (f_ref.flops, f_ref.hbm_bytes)
    b_ops, _ = cost.binmm(**shape, operand_bytes=2)
    hop = shape["nfft"] - shape["length"] + 1
    m = shape["b"] * -(-(shape["t"] - shape["length"] + 1) // hop)
    assert b_ops == 2.0 * bins * 2 * m * 2 * shape["d"] * shape["k"]


def test_shape_of_a_batch():
    cell = types.SimpleNamespace(config={
        "bank": {"num_templates": 10000, "template_length": 32}, "nfft": 223,
        "pipeline": {"frontend": {"frame_length": 400, "hop_length": 160, "nfft": 512}}})
    got = cost.scan_shape(buckets.Batch(491520, 8, 8), cell)
    assert got == dict(b=8, t=3069, k=10000, length=32, d=2048, nfft=223)
    assert cost.bound_s(989e12, 0.0, 989e12) == 1.0
    assert cost.bound_s(0.0, 3.35e12, 989e12) == 1.0


def test_idle_share_on_a_synthetic_trace():
    """Overlapping device intervals count once; gaps are named by the
    host event that covers them."""
    events = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("copy", 300.0, 400.0),
              ("k3", 450.0, 500.0)]
    ivals = [(s, e) for _n, s, e in events]
    assert trace.busy_union(ivals) == 300.0
    assert trace.idle_gaps(ivals) == [(150.0, 300.0), (400.0, 450.0)]
    host = [(140.0, 310.0, "aten::zeros"), (0.0, 1000.0, "outer"), (405.0, 420.0, "x")]
    labels = dict(trace.gap_labels(trace.idle_gaps(ivals), host))
    assert labels == {"aten::zeros": 150e-6, "outer": 50e-6}
    ctx = types.SimpleNamespace(stretch={"device_events": events, "window_s": 1000e-6,
                                         "batches": [buckets.Batch(16384, 2, 2)] * 2})
    idle = metric_reader(REPO, "device_idle_share")(ctx)
    assert idle == pytest.approx(70.0)
    assert metric_reader(REPO, "device_ops_per_batch")(ctx) == 2.0
    assert metric_reader(REPO, "device_idle_share")(
        types.SimpleNamespace(stretch=None)) is None


def test_kernel_rooflines_read_only_their_kernel():
    cell = types.SimpleNamespace(config={
        "bank": {"num_templates": 10000, "template_length": 32}, "nfft": 223,
        "pipeline": {"frontend": {"frame_length": 400, "hop_length": 160, "nfft": 512}}})
    batch = buckets.Batch(491520, 8, 8)
    ops, nbytes = cost.binmm(**cost.scan_shape(batch, cell), operand_bytes=2)
    bound_us = cost.bound_s(ops, nbytes, cost.PEAK["bfloat16"]) * 1e6
    events = [("(anonymous namespace)::binmm_kernel(x)", 0.0, 2 * bound_us),
              ("(anonymous namespace)::idft_kernel(x)", 0.0, 5.0)]
    ctx = types.SimpleNamespace(cell=cell, stretch={"device_events": events,
                                                    "batches": [batch], "window_s": 1.0})
    assert metric_reader(REPO, "binmm_bf16_roofline")(ctx) == pytest.approx(50.0)
    ctx.stretch["device_events"] = [("(anonymous namespace)::binmm_int8_kernel(x)", 0.0, 9.0)]
    assert metric_reader(REPO, "binmm_bf16_roofline")(ctx) is None


def test_stages_from_a_synthetic_trace():
    """Each device operation goes to the stage whose marks enclose the
    host call that launched it, whenever the device ran it: the host's
    gaps count in no stage, and a record after the NMS mark (the fetch's)
    changes nothing."""
    up = "Memcpy HtoD (Pinned -> Device)"
    calls, device = [], []
    for b in range(2):
        t = 1000.0 * b
        seq = [("cudaMemcpyAsync", up, 40.0), ("cudaEventRecordWithFlags", None, 0),
               ("cudaLaunchKernel", "planes_kernel", 10.0),
               ("cudaEventRecordWithFlags", None, 0),
               ("cudaLaunchKernel", "binmm_kernel", 60.0),
               ("cudaEventRecordWithFlags", None, 0),
               ("cudaLaunchKernel", "where", 20.0), ("cudaEventRecordWithFlags", None, 0),
               ("cudaLaunchKernel", "cat", 1.0), ("cudaEventRecordWithFlags", None, 0),
               ("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pinned)", 2.0)]
        for i, (call, op, dur) in enumerate(seq):
            corr = 100 * b + i
            calls.append((t + i, call, corr))
            if op:
                # the device runs it much later than the host launched it
                device.append((op, t + 500.0 + i * 100.0, t + 500.0 + i * 100.0 + dur, corr))
    st = trace.stage_seconds(calls, device)
    assert st == pytest.approx({"upload": 80e-6, "frontend": 20e-6, "score": 120e-6,
                                "nms": 40e-6, "after": 6e-6})
    ctx = types.SimpleNamespace(stretch={"batches": [buckets.Batch(16384, 2, 2)] * 2,
                                         "stage_s": st})
    assert metric_reader(REPO, "score_ms_per_batch")(ctx) == pytest.approx(0.06)
    assert metric_reader(REPO, "frontend_ms_per_batch")(ctx) == pytest.approx(0.01)
    assert metric_reader(REPO, "nms_ms_per_batch")(ctx) == pytest.approx(0.02)
    ctx.stretch["stage_s"] = dict.fromkeys(st, 0.0)
    assert metric_reader(REPO, "score_ms_per_batch")(ctx) is None
