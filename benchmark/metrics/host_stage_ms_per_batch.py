"""Host ms a batch of staging: the durations of the program's
``stream.stage`` spans in the traced stretch (a batch's host buffers
allocated, zeroed and filled; ``harness.spans``), over the stretch's
batches.  Layer: the host loop's staging, ``scan.stream_scan``."""

from benchmark.harness.spans import spans


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"]:
        return None
    stage = spans(st["host_events"]).get("stream.stage")
    if not stage:
        return None
    return sum(e - s for s, e in stage) / 1e3 / len(st["batches"])
