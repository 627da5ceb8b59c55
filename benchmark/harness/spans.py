"""The program's own host spans in the traced stretch, and the device's
idle gaps split by them.

Under the profiler ``scan.stream_scan`` opens three host-only ranges:
``stream.next`` (each ``next()`` on the corpus's iterator),
``stream.stage`` (a batch's host buffers: allocated, zeroed and filled)
and ``stream.drain`` (a fetch's wait, unpacking and record).  They
enclose no device work and never overlap, so they come back as host
events alone, in the same profiler session and on the same clock as the
device operations.  A program without them gives no spans, and the
readers that need them give nothing.
"""

from __future__ import annotations

from benchmark.harness.trace import idle_gaps

SPANS = ("stream.stage", "stream.next", "stream.drain")
REST = "none"


def spans(host_events) -> dict[str, list[tuple[float, float]]]:
    """The stretch's spans by name, ``{name: [(start_us, end_us)]}`` in
    order, for each name of ``SPANS`` that occurs.  ``host_events``:
    ``[(start_us, end_us, name)]``."""
    out: dict[str, list] = {}
    for s, e, name in host_events:
        if name in SPANS:
            out.setdefault(name, []).append((s, e))
    for ivals in out.values():
        ivals.sort()
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals ``[(start, end)]``."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(stretch) -> dict[str, float] | None:
    """The idle gaps between the stretch's device operations
    (``trace.idle_gaps``), seconds, split by the spans that cover them:
    each of ``SPANS`` its overlap with the gaps (a span that straddles a
    gap's edge counts inside the gap only), ``REST`` the gaps' time under
    none of them (the spans never overlap).  None without device
    operations or without any of the spans."""
    if not stretch or not stretch["device_events"]:
        return None
    found = spans(stretch["host_events"])
    if not found:
        return None
    gaps = idle_gaps([(s, e) for _n, s, e in stretch["device_events"]])
    out = {name: overlap(gaps, found.get(name, [])) / 1e6 for name in SPANS}
    out[REST] = sum(b - a for a, b in gaps) / 1e6 - sum(out.values())
    return out
