"""Device idle ms a batch under none of the program's host spans: the
idle gaps between the traced stretch's device operations less what its
``stream.next``, ``stream.stage`` and ``stream.drain`` spans cover
(``harness.spans.idle_by_span``), over the stretch's batches: the
upload, the scan step's launches and the fetches' packing.  Layer: the
host loop's launches, ``scan.scan_step``."""

from benchmark.harness.spans import REST, idle_by_span


def read(ctx):
    st = ctx.stretch
    idle = idle_by_span(st)
    if idle is None or not st["batches"]:
        return None
    return 1e3 * idle[REST] / len(st["batches"])
