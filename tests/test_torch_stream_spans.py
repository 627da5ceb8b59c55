"""The streaming scan's host-only spans (``stream.next``,
``stream.stage``, ``stream.drain``) in a CPU trace, and its
``staging_bytes`` counter."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)
from torch.profiler import ProfilerActivity, profile, record_function

from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.checkpoint import ScanManifest
from template_speech_recognition_tpu_torch.config import FrontendConfig

BATCH = 4
# three buckets of 16,384 samples: two full batches and a tail of 2 in
# the first, one full and a tail of 1 in the second, a tail of 2 in the
# third; the first full batch is the shard the manifest holds
LENGTHS = [9000, 16000, 4000, 12000, 30000, 7000, 16384, 11000, 500, 20000,
           25000, 32000, 17000, 40000, 3000, 45000, 8000]


class Waves:
    sample_rate = 16000

    def __init__(self, lengths, seed=0):
        rng = np.random.default_rng(seed)
        self.waves = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]

    def iter_utterances(self):
        for i, w in enumerate(self.waves):
            yield f"u{i}", w, []


def compute_into(seen):
    """A scan step stub that notes each batch's shape and dtype, inside
    a range of its own."""
    def compute(wavs, vs, _marks):
        with record_function("test.compute"):
            seen.append((wavs.shape[0], wavs.shape[1], wavs.dtype))
            b = wavs.shape[0]
            s = vs.to(torch.float32)[:, None].repeat(1, 2)
            return s, torch.zeros((b, 2), dtype=torch.int32), torch.ones((b, 2), dtype=torch.int32)
    return compute


def scan(corpus, manifest, seen):
    return tscan.stream_scan(corpus, FrontendConfig(), BATCH, compute_into(seen), 1,
                             torch.device("cpu"), manifest=manifest)


def host_ranges(prof):
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


@pytest.mark.parametrize("int16", [False, True])
def test_spans_and_staging_bytes(tmp_path, monkeypatch, int16):
    monkeypatch.setenv("SCAN_FETCH_GROUP", "2")
    monkeypatch.setenv("SCAN_PIPELINE_DEPTH", "1")
    if int16:
        monkeypatch.setenv("SCAN_UPLOAD_INT16", "1")
    corpus = Waves(LENGTHS)
    full = ScanManifest(str(tmp_path / "full"))
    scan(corpus, full, [])
    n_shards = len(full.completed())
    one = ScanManifest(str(tmp_path / "one"))
    one.record(0, full.load_shard(0))

    seen: list = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = scan(corpus, one, seen)
    ranges = host_ranges(prof)
    ctr = res.counters

    assert n_shards == 6 and ctr["shards_loaded"] == 1
    assert ctr["batches"] == len(seen) == n_shards - 1
    assert len(ranges["stream.stage"]) == len(seen)
    assert len(ranges["stream.drain"]) == ctr["fetches"] >= 3
    assert len(ranges["stream.next"]) == len(LENGTHS) + 1
    assert len(ranges["test.compute"]) == len(seen)
    spans = [iv for name in ("stream.next", "stream.stage", "stream.drain")
             for iv in ranges[name]]
    for c0, c1 in ranges["test.compute"]:
        assert all(e <= c0 or s >= c1 for s, e in spans)

    item = 2 if int16 else 4
    assert all(dt == (torch.int16 if int16 else torch.float32) for _b, _p, dt in seen)
    assert ctr["staging_bytes"] == sum(b * pad * item + b * 4 for b, pad, _dt in seen)
    full_dets = scan(corpus, None, []).detections
    assert np.array_equal(res.detections.scores, full_dets.scores)


def test_no_span_without_a_profiler(monkeypatch):
    """With no profiler running, the loop opens no ``record_function``
    range, and its counter counts all the same."""
    from template_speech_recognition_tpu_torch.utils import profiling as tprof

    opened = []

    def spy(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(tprof, "record_function", spy)
    seen: list = []
    res = scan(Waves(LENGTHS[:6]), None, seen)
    assert opened == []
    assert res.counters["staging_bytes"] == sum(b * pad * 4 + b * 4 for b, pad, _dt in seen)
