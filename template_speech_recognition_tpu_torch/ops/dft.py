"""DFT and mel bases for the frontend, and the log(-mel) spectrograms.

Counterpart of ``template_speech_recognition_tpu.ops.dft``: the basis
matrices come from the same float64 -> float32 recipe, so the port and
the reference multiply by bit-identical matrices.  The spectrograms are
fp32 matrix products with TF32 off (the reference's HIGHEST precision:
the log amplifies error in near-zero power bins).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LOG_EPS = np.float32(1e-6)


@functools.lru_cache(maxsize=8)
def _dft_np(frame_length: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(nfft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def dft_matrices(frame_length: int, nfft: int, device=None):
    """(cos, -sin) [frame_length, nfft//2 + 1] float32."""
    cos_m, sin_m = _dft_np(frame_length, nfft)
    return torch.from_numpy(cos_m).to(device), torch.from_numpy(sin_m).to(device)


@functools.lru_cache(maxsize=8)
def _mel_np(sample_rate: int, nfft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    nyq = sample_rate / 2.0
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(nyq), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((nfft + 1) * hz_pts / sample_rate).astype(np.int64)
    fb = np.zeros((nfft // 2 + 1, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = bins[m], bins[m + 1], bins[m + 2]
        for b in range(lo, ctr):
            if ctr > lo:
                fb[b, m] = (b - lo) / (ctr - lo)
        for b in range(ctr, hi):
            if hi > ctr:
                fb[b, m] = (hi - b) / (hi - ctr)
    return fb


def mel_filterbank(sample_rate: int, nfft: int, n_mels: int, device=None):
    """HTK-style triangular filters, [nfft//2+1, n_mels] (oracle-identical)."""
    return torch.from_numpy(_mel_np(sample_rate, nfft, n_mels)).to(device)


def _power(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    cos_m, sin_m = dft_matrices(frames.shape[-1], nfft, frames.device)
    re = frames @ cos_m
    im = frames @ sin_m
    return re * re + im * im


def log_magnitude_spectrogram(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    """Windowed frames [..., T, frame_length] -> 0.5 * log(|DFT|^2 + eps)
    [..., T, nfft//2 + 1], float32."""
    return 0.5 * torch.log(_power(frames, nfft) + float(LOG_EPS))


def log_mel_spectrogram(frames: torch.Tensor, nfft: int, sample_rate: int,
                        n_mels: int) -> torch.Tensor:
    """Windowed frames [..., T, frame_length] -> log-mel [..., T, n_mels]."""
    fb = mel_filterbank(sample_rate, nfft, n_mels, frames.device)
    return torch.log(_power(frames, nfft) @ fb + float(LOG_EPS))
