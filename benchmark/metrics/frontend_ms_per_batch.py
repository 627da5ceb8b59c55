"""Device ms a batch of the frontend (kernels 1 and 2, with the framing
and conversions around them): the device time of the operations that
the scan step's frontend stage launched in the traced stretch
(``harness.trace.stage_seconds``), over the stretch's batches.  Layer:
the frontend, ``frontend.planes``."""


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or st["stage_s"]["frontend"] <= 0:
        return None
    return 1e3 * st["stage_s"]["frontend"] / len(st["batches"])
