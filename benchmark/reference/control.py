"""A control that puts the reference in the program's place, at a lower
precision: a configuration's ``control`` names it by
``reference_bits``.

The LLR filter of each template is quantized to a signed integer of
that many bits, symmetric over the template (``round(W / s)`` clipped to
``[-q, q]``, ``q = 2**(bits - 1) - 1``, ``s = max|W| / q``), and scored on
the reference's own map as ``reference.score`` scores, then reduced to
detections as the scan reduces its scores: the best template a window
(the lowest id on a tie), ``oracle/detect.py``'s NMS (strictly above the
earlier windows within the radius, at least the later ones), the
``top_k`` highest by score, then by time.  The judge must find it not
correct.
"""

from __future__ import annotations

import numpy as np
import torch


def quantized_rows(wt: torch.Tensor, bits: int) -> torch.Tensor:
    """Wt [L, D, K] float32 -> the same dequantized from ``bits``-bit
    integers per template, in place."""
    q = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(wt.abs().amax(dim=(0, 1)), min=1e-30) / q     # [K]
    for l in range(wt.shape[0]):
        wt[l] = torch.clamp(torch.round(wt[l] / scale), -q, q) * scale
    return wt


def top_detections(scores: torch.Tensor, radius: int, top_k: int):
    """Scores [T', K] -> (scores [top_k] float32, times, ids) numpy, -inf
    in empty slots."""
    best = scores.amax(dim=1)
    best_k = torch.argmax(scores, dim=1)
    keep = torch.ones_like(best, dtype=torch.bool)
    if radius:
        neg = torch.full((radius,), float("-inf"), dtype=best.dtype, device=best.device)
        win = torch.cat([neg, best, neg]).unfold(0, 2 * radius + 1, 1)
        keep = (best > win[:, :radius].amax(dim=1)) & (best >= win[:, radius + 1:].amax(dim=1))
    times = torch.nonzero(keep)[:, 0]
    vals = best[times]
    order = np.lexsort((times.cpu().numpy(), -vals.cpu().numpy()))[:top_k]
    s = np.full(top_k, -np.inf, np.float32)
    t = np.zeros(top_k, np.int64)
    k = np.zeros(top_k, np.int64)
    s[: len(order)] = vals.cpu().numpy()[order]
    t[: len(order)] = times.cpu().numpy()[order]
    k[: len(order)] = best_k[times].cpu().numpy()[order]
    return s, t, k
