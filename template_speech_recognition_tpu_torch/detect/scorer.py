"""Score masking.

Counterpart of ``template_speech_recognition_tpu.detect.scorer``
(``masked_scores`` only; the direct scorers are later work).
"""

from __future__ import annotations

import torch


def masked_scores(
    scores: torch.Tensor,
    valid_frames: torch.Tensor,
    template_length: int,
    fill: float = float("-inf"),
    time_major: bool = False,
) -> torch.Tensor:
    """``fill`` where the window overruns the valid region.

    Valid window starts: t <= valid_frames - template_length.  Batched:
    scores [B, K, T''] (or [B, T'', K] with ``time_major``), valid [B].
    """
    t_axis = 1 if time_major else -1
    n_win = scores.shape[t_axis]
    t_idx = torch.arange(n_win, device=scores.device, dtype=torch.int32)
    limit = valid_frames.to(device=scores.device, dtype=torch.int32) - template_length
    ok = t_idx[None, :] <= limit[:, None]                    # [B, T'']
    ok = ok[:, :, None] if time_major else ok[:, None, :]
    return torch.where(ok, scores, torch.full_like(scores, fill))
