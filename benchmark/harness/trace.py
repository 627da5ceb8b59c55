"""The traced stretch: ``torch.profiler`` over a few seconds of the
window, and what the per-layer metrics read from it.

The stretch opens and closes where the scan asks for its next utterance
and a whole group of batches has been dispatched (``group``, the scan's
``SCAN_FETCH_GROUP``), with the device drained at both ends, so that it
holds every device operation of its batches and of no other, fetches
included.  The trace stays in memory; nothing is written to disk.

``busy_union`` is the arithmetic of ``chip_smoke.py``'s
``device_ms_traced``, copied: the union of the device intervals.
``stage_seconds`` gives each device operation to the stage of the scan
step whose host call launched it, so a stage's device time holds none of
the host's gaps.
"""

from __future__ import annotations

import time


def busy_union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(intervals):
    """The gaps between the union's pieces, ``[(start, end)]``."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def gap_labels(gaps, host_events, top: int = 10):
    """Each idle gap named by what the host was doing: the shortest host
    event that covers half of it or more, else the one that overlaps it
    most, else ``host: no traced op``; seconds summed by name, longest
    first.  ``gaps`` in order and disjoint; ``host_events``: ``[(start,
    end, name)]``; times in us.  One sweep over both."""
    host = sorted(host_events)
    total: dict[str, float] = {}
    active: list = []
    i = 0
    for a, b in gaps:
        while i < len(host) and host[i][0] < b:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > a]
        best, best_ov, cover = None, 0.0, None
        for s, e, name in active:
            ov = min(e, b) - max(s, a)
            if ov <= 0:
                continue
            if ov >= 0.5 * (b - a) and (cover is None or e - s < cover[0]):
                cover = (e - s, name)
            if ov > best_ov:
                best, best_ov = name, ov
        name = cover[1] if cover else (best or "host: no traced op")
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]


UPLOAD = "Memcpy HtoD (Pinned"
STAGES = ("upload", "frontend", "score", "nms", "after")


def stage_seconds(calls, device) -> dict[str, float]:
    """Device seconds of each stage of the scan steps in a trace.

    ``calls``: the host's CUDA runtime calls ``[(start_us, name,
    correlation)]``; ``device``: the device operations ``[(name,
    start_us, end_us, correlation)]``, each launched by the call of its
    correlation.  A batch opens with the upload of its waveforms from
    pinned memory (``upload``); ``scan.scan_step`` then records a CUDA
    event at its start and after its frontend, its scorer and its NMS
    (``scan.stage_marker``), so the host calls between two of those
    records launched that stage's operations; what follows the last, up
    to the next batch's upload, is ``after`` (the detections' packing and
    the group's fetch).  Other records there change nothing."""
    ops = {corr: (name, (e - s) / 1e6) for name, s, e, corr in device}
    out = dict.fromkeys(STAGES, 0.0)
    state = "after"
    for _t, name, corr in sorted(calls):
        op = ops.get(corr)
        if op is not None and op[0].startswith(UPLOAD):
            state = "upload"
        elif name.startswith("cudaEventRecord") and state != "after":
            state = STAGES[STAGES.index(state) + 1]
        if op is not None:
            out[state] += op[1]
    return out


class Stretch:
    """A hook of ``traffic.WindowCorpus``: opens the profiler at the
    first group boundary past ``start_s`` into the window and closes it
    at the first once ``stretch_s`` more have passed (holding the window
    open until then), then ends the window."""

    def __init__(self, start_s: float, stretch_s: float, group: int):
        self.start_s, self.stretch_s, self.group = start_s, stretch_s, group
        self.prof = None
        self.state = "idle"
        self.batches = (0, 0)
        self.wall = (0.0, 0.0)

    def __call__(self, corpus) -> None:
        import torch

        n = len(corpus.mirror.batches)
        if n == 0 or n % self.group:
            return
        cuda = torch.cuda.is_available()
        if self.state == "idle" and corpus.elapsed() >= self.start_s:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.wall = (time.perf_counter(), 0.0)
            self.batches = (n, n)
            self.state = "on"
            corpus.hold = True
        elif (self.state == "on" and n > self.batches[0]
              and time.perf_counter() - self.wall[0] >= self.stretch_s):
            if cuda:
                torch.cuda.synchronize()
            self.wall = (self.wall[0], time.perf_counter())
            self.prof.stop()
            self.batches = (self.batches[0], n)
            self.state = "done"
            corpus.hold = False
            corpus.stop = True

    def read(self, mirror_batches):
        """The stretch as the metrics read it: its batches, its wall
        seconds, its device events ``[(name, start_us, end_us)]``, its
        host events and each stage's device seconds (``stage_seconds``);
        None when it never closed."""
        if self.state != "done":
            return None
        from torch.autograd import DeviceType

        # the profiler's raw events: its FunctionEvent tree takes minutes
        # to build for a trace of this size
        dev, host, linked, calls = [], [], [], []
        for e in self.prof.profiler.kineto_results.events():
            rng = (e.start_ns() / 1e3, e.end_ns() / 1e3)
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), *rng))
                linked.append((e.name(), *rng, e.correlation_id()))
            elif e.device_type() == DeviceType.CPU:
                host.append((*rng, e.name()))
                if e.name().startswith("cuda"):
                    calls.append((rng[0], e.name(), e.correlation_id()))
        return {
            "batches": mirror_batches[self.batches[0]: self.batches[1]],
            "window_s": self.wall[1] - self.wall[0],
            "device_events": dev,
            "host_events": host,
            "stage_s": stage_seconds(calls, linked),
        }
