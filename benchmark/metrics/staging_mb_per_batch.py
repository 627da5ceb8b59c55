"""MB of host buffers a batch that the scan allocated: the window's
``staging_bytes`` counter (``scan.stream_scan``: each computed batch's
waveform and length buffers, pinned on the card, and each fetch's
pinned host buffer) over its ``batches``.  Layer: the host loop's
staging, ``scan.stream_scan``."""


def read(ctx):
    c = ctx.counters
    if not c.get("staging_bytes") or not c.get("batches"):
        return None
    return c["staging_bytes"] / c["batches"] / 1e6
