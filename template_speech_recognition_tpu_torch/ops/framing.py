"""Waveform framing: preemphasis, overlapping frames, Hamming window.

Counterpart of ``template_speech_recognition_tpu.ops.framing``; values
are exact copies (framing is a strided view, the window is built by the
same float32 recipe), so frames are bit-identical to the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def preemphasize(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """y[0] = x[0]; y[t] = x[t] - alpha * x[t-1].  [..., S] -> same."""
    x = x.to(torch.float32)
    shifted = torch.nn.functional.pad(x[..., :-1], (1, 0))
    return x - shifted * float(np.float32(alpha))


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """[..., S] -> [..., T, frame_length] overlapping frames (a view)."""
    x = x.to(torch.float32)
    if x.shape[-1] < frame_length:
        raise ValueError(f"signal too short: {x.shape[-1]} < {frame_length}")
    return x.unfold(-1, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def _hamming_np(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float32)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32)


def hamming_window(n: int, device=None) -> torch.Tensor:
    """Symmetric Hamming window, float32 (same arithmetic as the oracle)."""
    return torch.from_numpy(_hamming_np(n)).to(device)
