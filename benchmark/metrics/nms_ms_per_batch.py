"""Device ms a batch of NMS (the score map masked, its max and argmax
over the templates, the peaks kept and sorted): the device time of the
operations that the scan step's nms stage launched in the traced
stretch (``harness.trace.stage_seconds``), over the stretch's batches.
Layer: NMS, ``scan.batched_top_detections``."""


def read(ctx):
    st = ctx.stretch
    if not st or not st["batches"] or st["stage_s"]["nms"] <= 0:
        return None
    return 1e3 * st["stage_s"]["nms"] / len(st["batches"])
