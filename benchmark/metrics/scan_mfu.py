"""The whole scan's share of the chip's peak, %: the formulation's
operations (the frontend's DFT and the overlap-save scorer,
``harness.cost``, at the nfft the configuration states) for every batch
of the traced stretch, over the stretch's wall and the peak of the
configuration's spectra precision.  It reads the same work whatever
implements it, and bounds every kernel's share from above."""

from benchmark.harness import cost


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or st["window_s"] <= 0:
        return None
    fcfg = ctx.cell.config["pipeline"]["frontend"]
    spectra = ctx.cell.config["spectra"]
    ops = 0.0
    for batch in st["batches"]:
        ops += cost.fft_scores(**cost.scan_shape(batch, ctx.cell))[0]
        ops += cost.frontend(batch.rows, batch.pad, fcfg["frame_length"],
                             fcfg["hop_length"], fcfg["nfft"])[0]
    return 100.0 * ops / st["window_s"] / cost.PEAK[spectra]
