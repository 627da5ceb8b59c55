"""Non-max suppression and fixed-size top-K detection extraction.

Counterpart of ``template_speech_recognition_tpu.detect.nms``:

    keep[t]  <=>  s[t] >  max(s[t-r .. t-1])
             and  s[t] >= max(s[t+1 .. t+r])

(ties go to the earliest frame).  The template axis reduces by max with
ties to the lowest template id (``torch.argmax`` returns the first
maximum); the top-K orders by score descending, then time ascending --
a stable descending sort, because ``torch.topk`` promises no order
among ties.  Suppressed and absent slots score -inf; padding slots past
the number of frames have time 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_sided_max(s: torch.Tensor, radius: int, side: str) -> torch.Tensor:
    """left: out[t] = max(s[t-r..t-1]); right: out[t] = max(s[t+1..t+r])
    (-inf outside).  s [N, T] float."""
    pad = torch.full((s.shape[0], radius), float("-inf"), dtype=s.dtype,
                     device=s.device)
    if side == "left":
        p = torch.cat([pad, s[:, :-1]], dim=1)
    else:
        p = torch.cat([s[:, 1:], pad], dim=1)
    return F.max_pool1d(p[:, None, :], kernel_size=radius, stride=1)[:, 0]


def nms_mask(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """[..., T] float scores -> bool keep mask (see module docstring)."""
    if radius == 0:
        return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    s = scores.reshape(-1, scores.shape[-1])
    left = _one_sided_max(s, radius, "left")
    right = _one_sided_max(s, radius, "right")
    return ((s > left) & (s >= right)).reshape(scores.shape)


def top_detections(
    scores: torch.Tensor,
    radius: int,
    top_k: int,
    time_major: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bank scores [..., K, T''] (or [..., T'', K] with ``time_major``)
    -> (scores [..., top_k] f32, times [..., top_k] int32, template ids
    [..., top_k] int32).  Leading dimensions batch utterances."""
    k_axis = -1 if time_major else -2
    best = torch.amax(scores, dim=k_axis)
    best_k = torch.argmax(scores, dim=k_axis)
    keep = nms_mask(best, radius)
    neg = float("-inf")
    masked = torch.where(keep, best.to(torch.float32),
                         torch.full_like(best, neg, dtype=torch.float32))
    k = min(top_k, masked.shape[-1])
    vals, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, times = vals[..., :k], order[..., :k]
    if k < top_k:
        pad_shape = masked.shape[:-1] + (top_k - k,)
        vals = torch.cat([vals, torch.full(pad_shape, neg, device=vals.device)], -1)
        times = torch.cat(
            [times, torch.zeros(pad_shape, dtype=times.dtype, device=times.device)], -1
        )
    # as the reference's take(best_k, times): padding slots read time 0
    ids = torch.gather(best_k, -1, times)
    return vals, times.to(torch.int32), ids.to(torch.int32)
