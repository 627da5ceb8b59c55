"""Plane-major frontend: waveforms -> flat binary feature map.

Counterpart of ``template_speech_recognition_tpu.frontend.planes``
(``frontend_batch_flat``, ``_windowed_frames``, ``_dual_ranks``).  Two
kernels carry it: the response planes (``ops.frontend_kernel``) and the
select + binarize + spread (``ops.selbin_kernel``), so the planes cross
device memory once between them.

The output is the flat channel-major map [B, T_pad, D = 8*F'] (d =
e*F' + f; channel 2i = plane i > its rank-k statistic, channel 2i+1 =
plane i < its rank-(n-1-k) statistic) with T_pad = frames rounded up
to 128 on every device; rows >= valid are False.  (On the CPU the JAX
reference takes its layered path and returns T - 1 rows; the rows
below valid are the same.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.ops import framing
from template_speech_recognition_tpu_torch.ops.frontend_kernel import (
    edge_response_planes,
    edge_response_planes_plain,
)
from template_speech_recognition_tpu_torch.ops.selbin_kernel import (
    select_binspread,
    select_binspread_plain,
)


class FlatFeatureMap(NamedTuple):
    """Flat binary edge map [B, T, D] (d = e*F' + f) + valid rows."""

    binary: torch.Tensor        # [B, T_pad, E*F'] bool (invalid rows False)
    valid_frames: torch.Tensor  # [B] int32: rows < valid are real


def _windowed_frames(waveforms: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] -> [B, T, frame_length] preemphasized windowed frames."""
    y = framing.preemphasize(waveforms, cfg.preemphasis)
    frames = framing.frame_signal(y, cfg.frame_length, cfg.hop_length)
    return frames * framing.hamming_window(cfg.frame_length, waveforms.device)


def _dual_ranks(valid_frames: torch.Tensor, f: int, quantile: float) -> torch.Tensor:
    """[B] valid frames -> [B, 2] int32 (rank+1) for ranks k and n-1-k,
    k = min(n-1, floor(f32(q) * f32(n))) computed in float32 exactly as
    the reference does."""
    n = (valid_frames.to(torch.int32) * f).to(torch.int32)
    k1 = torch.minimum(
        n - 1,
        torch.floor(n.to(torch.float32) * float(np.float32(quantile))).to(
            torch.int32
        ),
    )
    k2 = n - 1 - k1
    return (torch.stack([k1, k2], dim=-1) + 1).to(torch.int32)


def frontend_batch_flat(
    waveforms: torch.Tensor,          # [B, S] padded
    num_valid_samples: torch.Tensor,  # [B]
    cfg: FrontendConfig,
    plain: bool = False,
) -> FlatFeatureMap:
    """[B, S] padded waveforms -> flat binary feature maps.

    ``plain=True`` runs the kernels' plain PyTorch versions on any
    device (the reference the kernels are held against)."""
    dev = waveforms.device
    frames = _windowed_frames(waveforms, cfg)
    nv = num_valid_samples.to(device=dev, dtype=torch.int32)
    valid_frames = torch.where(
        nv >= cfg.frame_length,
        torch.div(nv - cfg.frame_length, cfg.hop_length, rounding_mode="floor"),
        torch.zeros_like(nv),
    ).to(torch.int32)
    b, t = frames.shape[0], frames.shape[1]
    t_pad = ((t + 127) // 128) * 128
    f = cfg.feature_freqs
    fp = torch.zeros((b, t_pad, cfg.frame_length), dtype=torch.float32, device=dev)
    fp[:, :t] = frames
    planes_fn = edge_response_planes_plain if plain else edge_response_planes
    selbin_fn = select_binspread_plain if plain else select_binspread
    stacked = planes_fn(
        fp.reshape(b * t_pad, cfg.frame_length), cfg.nfft,
        sample_rate=cfg.sample_rate,
        n_mels=cfg.n_mels if cfg.use_mel else 0,
    )                                                   # [4, B*T_pad, F]
    need = _dual_ranks(valid_frames, f, cfg.edge_quantile)
    flat_u8, _keys = selbin_fn(
        stacked.reshape(4, b, t_pad, f), need, valid_frames,
        cfg.spread_freq, cfg.spread_time,
    )
    return FlatFeatureMap(flat_u8.to(torch.bool), valid_frames)
