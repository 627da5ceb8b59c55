"""The comparison that decides ``correct``.

Each utterance that the window scanned came back as up to ``top_k``
detections (score, window start, template id): the best template's
score at peaks of the best-score curve that no window within
``nms_radius`` beats (``oracle/detect.py``'s ``nms_mask``: strictly
beats the earlier, at least ties the later ones), the highest ``top_k``
of them.  The reference scores every window and template of the
utterance (``reference.score``), between ``s_lo`` and ``s_hi`` where the
front end leaves a cell ambiguous, and each detection is judged by what
it says.  Four gaps, in score units, zero where the claim holds:

* ``score``: the detection's score outside the reference's [s_lo, s_hi]
  of its window and template;
* ``winner``: how far the reported template lies below the best one at
  that window (``max_k s_lo - s_hi`` of it);
* ``peak``: how far the reported window lies below another within the
  radius (the neighbour's least best score over its own most);
* ``missed``: how far a window that is surely a peak stands above its
  neighbours (``best s_lo`` over the neighbours' ``best s_hi``), where
  the utterance did not report it; for an utterance that reported
  ``top_k`` detections, no more than by what it stands above the lowest
  of them.

Each gap is taken as its largest value over every detection judged
(``_max``) and as its root mean square (``_rms``: over the detections,
for ``missed`` over the windows that are surely peaks), in units of
``scale``, the largest |score| that the reference gives over the
utterances judged.  The configuration's ``check.limits`` names the
numbers compared.  A scan fails where one of its gaps passes the limit
of that gap's ``_max`` number, where it answers at no valid window
start or template id, or where it answers nothing though a window is
surely a peak.
"""

from __future__ import annotations

import numpy as np
import torch

GAPS = ("score", "winner", "peak", "missed")
# each gap's largest value and its root mean square (over the
# detections; for ``missed``, over the windows that are surely peaks)
NUMBERS = tuple(f"{g}_{stat}" for g in GAPS for stat in ("max", "rms"))


def neighbour_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """[..., T] -> the max over t' with 0 < |t' - t| <= radius (-inf where none)."""
    if radius == 0:
        return torch.full_like(x, float("-inf"))
    neg = torch.full(x.shape[:-1] + (radius,), float("-inf"), dtype=x.dtype, device=x.device)
    p = torch.cat([neg, x, neg], dim=-1)
    win = p.unfold(-1, 2 * radius + 1, 1).clone()              # [..., T, 2r+1]
    win[..., radius] = float("-inf")
    return win.amax(dim=-1)


def utterance_gaps(s_lo, s_hi, dets, top_k: int, radius: int) -> torch.Tensor:
    """The gaps of ``n`` scans of one utterance -> [n, 11] float64: for
    each gap its largest value and its sum of squares, then the number of
    detections, of windows that are surely peaks, and of detections at
    no valid window or template.

    ``s_lo``, ``s_hi``: [T', K]; ``dets``: (scores [n, P] float32 with
    -inf for empty slots, times [n, P], ids [n, P]) as numpy arrays."""
    dev = s_lo.device
    tout, k = s_lo.shape
    s = torch.as_tensor(dets[0], dtype=torch.float64, device=dev)
    t = torch.as_tensor(dets[1], dtype=torch.int64, device=dev)
    kid = torch.as_tensor(dets[2], dtype=torch.int64, device=dev)
    n = s.shape[0]
    out = torch.zeros((n, 11), dtype=torch.float64, device=dev)
    live = torch.isfinite(s)
    bad = live & ((t < 0) | (t >= tout) | (kid < 0) | (kid >= k))
    ok = live & ~bad
    tc, kc = t.clamp(0, tout - 1), kid.clamp(0, k - 1)
    lo, hi = s_lo.to(torch.float64), s_hi.to(torch.float64)
    best_lo, best_hi = lo.amax(dim=1), hi.amax(dim=1)
    at_lo, at_hi = lo[tc, kc], hi[tc, kc]
    zero = torch.zeros_like(s)
    gaps = [
        torch.maximum(torch.maximum(at_lo - s, s - at_hi), zero),
        torch.clamp(best_lo[tc] - at_hi, min=0.0),
        torch.clamp(neighbour_max(best_lo, radius)[tc] - best_hi[tc], min=0.0),
    ]
    for j, g in enumerate(gaps):
        g = torch.where(ok, g, zero)
        out[:, 2 * j] = g.amax(dim=1)
        out[:, 2 * j + 1] = (g * g).sum(dim=1)
    margin = best_lo - neighbour_max(best_hi, radius)              # [T']
    sure = margin > 0
    reported = torch.zeros((n, tout), dtype=torch.int32, device=dev)
    reported.scatter_add_(1, tc, ok.to(torch.int32))
    reported = reported > 0
    full = live.sum(dim=1) >= top_k
    s_min = torch.where(live, s, torch.full_like(s, float("inf"))).amin(dim=1)
    gap = margin[None, :].expand(n, tout)
    gap = torch.where(full[:, None], torch.minimum(gap, best_lo[None, :] - s_min[:, None]), gap)
    gap = torch.clamp(torch.where(sure[None, :] & ~reported, gap, torch.zeros_like(gap)),
                      min=0.0)
    out[:, 6] = gap.amax(dim=1)
    out[:, 7] = (gap * gap).sum(dim=1)
    out[:, 8] = ok.sum(dim=1)
    out[:, 9] = sure.sum()
    out[:, 10] = bad.sum(dim=1)
    return out


def numbers(gaps: np.ndarray, scale: float) -> dict:
    """``gaps`` [n, 11] of every scan judged -> each of ``NUMBERS``, in
    units of ``scale``."""
    scale = max(scale, 1e-30)
    out = {}
    for j, g in enumerate(GAPS):
        count = gaps[:, 9].sum() if g == "missed" else gaps[:, 8].sum()
        out[f"{g}_max"] = float(gaps[:, 2 * j].max()) / scale if len(gaps) else 0.0
        out[f"{g}_rms"] = float(np.sqrt(gaps[:, 2 * j + 1].sum() / max(count, 1.0))) / scale
    return out


def verdict(gaps: np.ndarray, scale: float, limits: dict) -> dict:
    """Each number that ``limits`` names beside its limit, every number
    read, and the scans that failed: an answer at no valid window or
    template, no answer where a window is surely a peak, or a gap past
    the limit of its ``_max`` number."""
    read = numbers(gaps, scale)
    bad = (gaps[:, 10] > 0) | ((gaps[:, 8] == 0) & (gaps[:, 9] > 0))
    for j, g in enumerate(GAPS):
        if f"{g}_max" in limits:
            bad |= gaps[:, 2 * j] / max(scale, 1e-30) > limits[f"{g}_max"]
    return {
        "numbers": {name: {"value": read[name], "limit": float(lim)}
                    for name, lim in limits.items()},
        "read": read,
        "failed": int(bad.sum()),
    }
