"""The scorer's share of its roofline, %: the least time of the
overlap-save formulation's work for every batch of the traced stretch
(``harness.cost.fft_scores`` at the configuration's nfft, from each
batch's shape as the harness reckons it: operations at the peak of the
spectra's precision or bytes at 3.35 TB/s, whichever is longer) over the
device time of the operations that the scan step's score stage launched
there (``harness.trace.stage_seconds``).  Layer: the scorer,
``detect.fft_scorer``."""

from benchmark.harness import cost


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or st["stage_s"]["score"] <= 0:
        return None
    spectra = ctx.cell.config["spectra"]
    bound = 0.0
    for batch in st["batches"]:
        ops, nbytes = cost.fft_scores(**cost.scan_shape(batch, ctx.cell),
                                      spectra_bytes=cost.ELEMENT_BYTES[spectra])
        bound += cost.bound_s(ops, nbytes, cost.PEAK[spectra])
    return 100.0 * bound / st["stage_s"]["score"]
