"""The device's idle share of the traced stretch, %: 100 less the union
of the trace's device intervals (``harness.trace.busy_union``, the
arithmetic of ``chip_smoke.py``'s busy share) over the stretch's wall."""

from benchmark.harness.trace import busy_union


def read(ctx):
    st = ctx.stretch
    if not st or not st["device_events"] or st["window_s"] <= 0:
        return None
    busy = busy_union((s, e) for _n, s, e in st["device_events"]) / 1e6
    return 100.0 * (1.0 - busy / st["window_s"])
