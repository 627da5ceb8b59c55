"""Device ms a batch of the scorer (kernels 3, 4 and 5, with the map's
conversion to the spectra's type): the device time of the operations
that the scan step's score stage launched in the traced stretch
(``harness.trace.stage_seconds``), over the stretch's batches.  Layer:
the scorer, ``detect.fft_scorer``."""


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or st["stage_s"]["score"] <= 0:
        return None
    return 1e3 * st["stage_s"]["score"] / len(st["batches"])
