"""The edge-feature front end in plain PyTorch, float64.

A frozen copy of ``oracle/frontend.py`` (``stft_log_magnitude``,
``edge_responses``, ``quantile_threshold``, ``binary_edge_map``,
``spread_binary``, ``frontend``) for the log-magnitude path, rewritten
from NumPy float32 into ``torch`` float64 so that it runs on the card at
corpus scale.  The constants that the oracle fixes in float32 (the
preemphasis factor, the log floor, the quantile and its rank) keep their
float32 values.

Besides the binary map it returns the cells whose decision lies within
``delta`` of their channel's threshold (``ambiguous``): an
implementation whose responses are within ``delta / 2`` of these may set
them either way (its threshold, an order statistic, moves by at most as
much as its responses).  The comparison scores each window between the
two ways (``reference.score``).
"""

from __future__ import annotations

import numpy as np
import torch

LOG_EPS = float(np.float32(1e-6))


def stft_log_magnitude(wave: torch.Tensor, sample_rate: int, frame_length: int,
                       hop_length: int, nfft: int, preemphasis: float) -> torch.Tensor:
    """Waveform [S] -> log-magnitude spectrogram [T, nfft // 2 + 1]."""
    x = wave.to(torch.float64)
    y = torch.cat([x[:1], x[1:] - float(np.float32(preemphasis)) * x[:-1]])
    n_frames = 1 + (y.shape[0] - frame_length) // hop_length
    if n_frames <= 0:
        raise ValueError(f"signal too short: {y.shape[0]} < {frame_length}")
    frames = y[: (n_frames - 1) * hop_length + frame_length].unfold(0, frame_length, hop_length)
    k = torch.arange(frame_length, dtype=torch.float64, device=x.device)
    window = 0.54 - 0.46 * torch.cos(2.0 * np.pi * k / (frame_length - 1))
    n = k[:, None]
    f = torch.arange(nfft // 2 + 1, dtype=torch.float64, device=x.device)[None, :]
    ang = 2.0 * np.pi * n * f / nfft
    fw = frames * window
    re = fw @ torch.cos(ang)
    im = fw @ -torch.sin(ang)
    return 0.5 * torch.log(re * re + im * im + LOG_EPS)


def edge_responses(spec: torch.Tensor) -> torch.Tensor:
    """[T, F] -> [T-1, F-1, 8]: channel 2o is +d, 2o+1 is -d, for the
    time, frequency, diagonal and anti-diagonal differences."""
    d_time = (spec[1:, :] - spec[:-1, :])[:, :-1]
    d_freq = (spec[:, 1:] - spec[:, :-1])[:-1, :]
    d_diag = spec[1:, 1:] - spec[:-1, :-1]
    d_anti = spec[1:, :-1] - spec[:-1, 1:]
    planes = []
    for d in (d_time, d_freq, d_diag, d_anti):
        planes += [d, -d]
    return torch.stack(planes, dim=-1)


def quantile_rank(n: int, quantile: float) -> int:
    """k = min(n - 1, floor(f32(q) * f32(n))), in float32 as the oracle."""
    return min(n - 1, int(np.floor(np.float32(quantile) * np.float32(n))))


def spread(binary: torch.Tensor, spread_time: int, spread_freq: int) -> torch.Tensor:
    """Dilation of [T, F, C] by a (2 rt + 1) x (2 rf + 1) rectangle,
    zero-padded, per channel."""
    x = binary.to(torch.float32).permute(2, 0, 1)[:, None]          # [C, 1, T, F]
    out = torch.nn.functional.max_pool2d(
        x, (2 * spread_time + 1, 2 * spread_freq + 1), stride=1,
        padding=(spread_time, spread_freq))
    return out[:, 0].permute(1, 2, 0) > 0


def edge_map(wave: torch.Tensor, fcfg: dict, delta: float):
    """Waveform [S] -> (binary [T-1, F-1, 8] bool, ambiguous [T-1, F-1, 8]
    bool): the spread edge map with every ambiguous pre-spread cell off,
    and the spread cells that some ambiguous cell could set."""
    spec = stft_log_magnitude(wave, fcfg["sample_rate"], fcfg["frame_length"],
                              fcfg["hop_length"], fcfg["nfft"], fcfg["preemphasis"])
    resp = edge_responses(spec)
    t, f, c = resp.shape
    flat = resp.reshape(t * f, c)
    k = quantile_rank(t * f, fcfg["edge_quantile"])
    tau = torch.kthvalue(flat, k + 1, dim=0).values                 # [C]
    margin = resp - tau
    amb = margin.abs() <= delta
    sure = (margin > 0) & ~amb
    rt, rf = fcfg["spread_time"], fcfg["spread_freq"]
    lo = spread(sure, rt, rf)
    hi = spread(sure | amb, rt, rf)
    return lo, hi & ~lo
