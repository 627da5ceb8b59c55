"""Device operations (kernels, copies, memsets) a batch in the traced
stretch: the trace's device events over the stretch's batches, whose
fetches it holds whole (``harness.trace.Stretch``).  Layer: the host
loop, ``scan.stream_scan``."""


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or not st["device_events"]:
        return None
    return len(st["device_events"]) / len(st["batches"])
