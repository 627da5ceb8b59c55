"""Exemplar registration and Bernoulli template / background estimation.

Counterpart of ``template_speech_recognition_tpu.models.template``.
Registration uses the same integer nearest-neighbour index map
``src_row(i) = min(floor(i * L_i / L), L_i - 1)``, one gather over the
padded stack, so registered stacks are bitwise the reference's;
estimation is a (masked) mean over the whole stack.
"""

from __future__ import annotations

import torch


def register_exemplars(exemplars: torch.Tensor, lengths, template_length: int) -> torch.Tensor:
    """Padded exemplars [N, Lmax, F, E] + lengths [N] -> [N, L, F, E].

    Uniform time resampling by exact integer index mapping (no
    interpolation arithmetic, so bit-reproducible)."""
    n = exemplars.shape[0]
    ln = torch.as_tensor(lengths, device=exemplars.device).to(torch.int64)
    i = torch.arange(template_length, device=exemplars.device, dtype=torch.int64)
    src = torch.minimum((i[None, :] * ln[:, None]) // template_length, ln[:, None] - 1)
    rows = torch.arange(n, device=exemplars.device)[:, None]
    return exemplars[rows, src]


def estimate_template(stack: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    """[N, L, F, E] binary stack -> clipped mean template [L, F, E] f32."""
    mean = stack.to(torch.float32).mean(dim=0)
    return mean.clamp(eps, 1.0 - eps)


def estimate_background(binary_maps: torch.Tensor, valid_frames, eps: float = 0.01) -> torch.Tensor:
    """Occurrence frequency over background spans.

    binary_maps: [B, T, F, E] (rows past each map's valid frames False);
    valid_frames: [B].  Returns q [F, E] float32 in [eps, 1 - eps]."""
    total = binary_maps.to(torch.float32).sum(dim=(0, 1))
    vf = torch.as_tensor(valid_frames, device=binary_maps.device)
    count = vf.to(torch.float32).sum().clamp(min=1.0)
    return (total / count).clamp(eps, 1.0 - eps)
