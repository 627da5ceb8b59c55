"""The program's host spans in a stretch (``harness/spans.py``) and the
six metrics that read them and the staging counter."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import run
from benchmark.harness import spans as sp
from benchmark.harness import spec
from benchmark.harness.trace import idle_gaps
from benchmark.tests.conftest import REPO

IDLE = ("idle_stage_ms_per_batch", "idle_next_ms_per_batch", "idle_drain_ms_per_batch",
        "idle_launch_ms_per_batch")
SIX = ("host_stage_ms_per_batch",) + IDLE + ("staging_mb_per_batch",)

# device ops at 0-100, 150-200, 300-400 and 600-700 us: gaps 100-150,
# 200-300 and 400-600; spans straddle the gaps' edges
DEVICE = [("k1", 0.0, 100.0), ("k2", 150.0, 200.0), ("k3", 300.0, 400.0),
          ("k2", 90.0, 110.0), ("k4", 600.0, 700.0)]
HOST = [(80.0, 130.0, "stream.stage"), (130.0, 140.0, "aten::zeros"),
        (190.0, 260.0, "stream.next"), (260.0, 280.0, "stream.stage"),
        (390.0, 450.0, "stream.drain"), (500.0, 650.0, "stream.stage"),
        (0.0, 700.0, "cudaLaunchKernel")]


def stretch(device=DEVICE, host=HOST, batches=4):
    return {"batches": list(range(batches)), "window_s": 1e-3, "device_events": device,
            "host_events": host, "stage_s": {}}


def read(name, st, counters=None):
    ctx = types.SimpleNamespace(cell=None, counters=counters or {}, batches=[], stretch=st)
    return spec.metric_reader(REPO, name)(ctx)


def test_the_parts_sum_to_the_gaps_and_spans_are_cut_at_the_edges():
    st = stretch()
    gaps = idle_gaps([(s, e) for _n, s, e in DEVICE])
    assert gaps == [(110.0, 150.0), (200.0, 300.0), (400.0, 600.0)]
    idle = sp.idle_by_span(st)
    assert set(idle) == set(sp.SPANS) | {sp.REST}
    # stage: 110-130 of the first gap, 260-280 of the second, 500-600 of the third
    assert idle["stream.stage"] == pytest.approx(140e-6)
    assert idle["stream.next"] == pytest.approx(60e-6)       # 200-260
    assert idle["stream.drain"] == pytest.approx(50e-6)      # 400-450
    assert idle[sp.REST] == pytest.approx(90e-6)             # 130-150, 280-300, 450-500
    assert sum(idle.values()) == pytest.approx(sum(b - a for a, b in gaps) / 1e6)


def test_the_readers_on_a_stretch():
    st = stretch()
    got = {name: read(name, st, {"staging_bytes": 3e6, "batches": 2.0}) for name in SIX}
    assert got["host_stage_ms_per_batch"] == pytest.approx((50 + 20 + 150) / 1e3 / 4)
    assert got["idle_stage_ms_per_batch"] == pytest.approx(0.14 / 4)
    assert got["idle_next_ms_per_batch"] == pytest.approx(0.06 / 4)
    assert got["idle_drain_ms_per_batch"] == pytest.approx(0.05 / 4)
    assert got["idle_launch_ms_per_batch"] == pytest.approx(0.09 / 4)
    assert sum(got[n] for n in IDLE) == pytest.approx(0.34 / 4)
    assert got["staging_mb_per_batch"] == pytest.approx(1.5)


@pytest.mark.parametrize("case", ["no stretch", "no batches", "no device op", "no span",
                                  "no counter"])
def test_each_reader_gives_none_without_its_inputs(case):
    st, counters = stretch(), {"staging_bytes": 3e6, "batches": 2.0}
    if case == "no stretch":
        st = None
    elif case == "no batches":
        st = stretch(batches=0)
    elif case == "no device op":
        st = stretch(device=[])
    elif case == "no span":
        st = stretch(host=[h for h in HOST if not h[2].startswith("stream.")])
    else:
        counters = {"batches": 2.0}
    got = {name: read(name, st, counters) for name in SIX}
    none = {
        "no stretch": set(SIX) - {"staging_mb_per_batch"},
        "no batches": set(SIX) - {"staging_mb_per_batch"},
        "no device op": set(IDLE),
        "no span": set(SIX) - {"staging_mb_per_batch"},
        "no counter": {"staging_mb_per_batch"},
    }[case]
    assert {n for n, v in got.items() if v is None} == none


def test_traced_cpu_run_reports_staging_and_no_idle(tiny_root):
    out = run.run_cell("tiny.tinymix", 2**31 + 23, 5.0, True, torch.device("cpu"),
                       root=tiny_root, log=lambda _m: None)
    metrics = out["metrics"]
    assert metrics["host_stage_ms_per_batch"]["value"] > 0
    # 1-s utterances in the 16,384-sample bucket, batch 2, f32
    assert metrics["staging_mb_per_batch"]["value"] == pytest.approx(
        (2 * 16384 * 4 + 2 * 4) / 1e6)
    assert set(IDLE).isdisjoint(metrics)
    assert out["correct"]
