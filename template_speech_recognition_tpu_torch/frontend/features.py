"""The front end's classic-layout entry points: waveform -> binary
oriented-edge feature map [T', F', 8].

Counterpart of ``template_speech_recognition_tpu.frontend.features``:
``spectrogram`` (the log-(mel-)spectrogram), and ``frontend`` /
``frontend_batch``, which run the plane-major flat frontend
(``frontend.planes.frontend_batch_flat``, the kernels) and relayout its
output to the channels-minor map with T' = num_frames - 1 rows.  The
streaming scan calls the flat frontend directly and skips the relayout.

Parity contract (the reference's): identical arithmetic modulo fp32
summation order, so binary maps agree except at cells whose response
ties the threshold within float tolerance (>= 99.9% agreement).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.frontend.planes import (
    _windowed_frames,
    frontend_batch_flat,
)
from template_speech_recognition_tpu_torch.ops import dft
from template_speech_recognition_tpu_torch.ops.layout import flat_to_channels


class FeatureMap(NamedTuple):
    """Padded binary edge map plus its valid time extent."""

    binary: torch.Tensor        # [.., T', F', 8] bool (padded rows False)
    valid_frames: torch.Tensor  # [..] int32: rows < valid are real


def spectrogram(waveform: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[S] (padded) -> [T, num_bins] float32 log-(mel-)spectrogram."""
    frames = _windowed_frames(waveform, cfg)
    if cfg.use_mel:
        return dft.log_mel_spectrogram(frames, cfg.nfft, cfg.sample_rate, cfg.n_mels)
    return dft.log_magnitude_spectrogram(frames, cfg.nfft)


def frontend_batch(waveforms: torch.Tensor, num_valid_samples: torch.Tensor,
                   cfg: FrontendConfig, plain: bool = False) -> FeatureMap:
    """[B, S] + [B] -> FeatureMap [B, T', F', 8] (T' = frames - 1).
    ``plain=True`` runs the kernels' plain versions."""
    fm = frontend_batch_flat(waveforms, num_valid_samples, cfg, plain=plain)
    t_out = cfg.num_feature_frames(waveforms.shape[-1])
    binary = flat_to_channels(fm.binary[:, :t_out], cfg.feature_freqs)
    return FeatureMap(binary, fm.valid_frames)


def frontend(waveform: torch.Tensor, num_valid_samples, cfg: FrontendConfig) -> FeatureMap:
    """Padded waveform [S] + valid count -> FeatureMap [T', F', 8].  The
    quantile threshold is taken over valid cells only, so the valid
    region does not depend on the padding."""
    nv = torch.as_tensor(num_valid_samples, device=waveform.device).reshape(1)
    fm = frontend_batch(waveform[None], nv, cfg)
    return FeatureMap(fm.binary[0], fm.valid_frames[0])
