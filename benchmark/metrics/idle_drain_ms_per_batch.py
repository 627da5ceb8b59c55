"""Device idle ms a batch under the fetches' drain: the part of the idle
gaps between the traced stretch's device operations that the program's
``stream.drain`` spans cover (``harness.spans.idle_by_span``), over the
stretch's batches.  Layer: the host loop's fetch drain,
``scan.stream_scan``."""

from benchmark.harness.spans import idle_by_span


def read(ctx):
    st = ctx.stretch
    idle = idle_by_span(st)
    if idle is None or not st["batches"]:
        return None
    return 1e3 * idle["stream.drain"] / len(st["batches"])
