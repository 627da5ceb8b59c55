"""Kernel 4's share of its roofline, %: ``binmm_kernel``'s device time
by name in the traced stretch against the least time of its work for
the stretch's batches (``harness.cost.binmm``: X and W2 in bf16 read
once, one f32 output plane written once; 989 TFLOP/s or 3.35 TB/s).
Layer: the kernels, ``ops.fft_binmm_kernel``."""

from benchmark.harness import cost

KERNEL = "binmm_kernel"


def read(ctx):
    st = ctx.stretch
    if not st:
        return None
    secs = sum(e - s for name, s, e in st["device_events"] if KERNEL in name) / 1e6
    if secs <= 0:
        return None
    bound = sum(cost.bound_s(*cost.binmm(**cost.scan_shape(b, ctx.cell), operand_bytes=2),
                             cost.PEAK["bfloat16"]) for b in st["batches"])
    return 100.0 * bound / secs
