"""Kernel 1: windowed frames -> the four oriented difference planes.

Replaces two ``pallas_call``s of
``template_speech_recognition_tpu/ops/frontend_pallas.py`` that compute
one function: ``edge_response_planes_stacked_pallas`` (``_kernel_stacked``,
line 251; the two-kernel frontend) and ``edge_response_planes_pallas``
(``_kernel``, line 209; the layered frontend), in both their modes.
The four-output form (``edge_response_planes_4``) and the channels-minor
``edge_responses`` are views of the one stacked output.

Computes, for frame rows ``r`` of ``frames [N, frame_length]``, the DFT
``re, im`` of the frame against cos / -sin ``[frame_length, nfft//2 +
1]`` (the Nyquist column included), ``power = re^2 + im^2``, then

* log-magnitude mode: ``spec[r] = 0.5 * log(power + 1e-6)``, F = nfft // 2;
* log-mel mode (``n_mels > 0``): ``spec[r] = log(power @ fb + 1e-6)``
  with ``fb`` the HTK filterbank ``[nfft//2 + 1, n_mels]`` (no 1/2),
  F = n_mels - 1;

and the four differences against the next row ``r + 1`` (dt, df, dd,
da), written plane-major ``[4, N, F]``.  The last row's next row is
clamped (row ``N - 1`` itself): garbage by contract, as on the TPU --
callers mask rows ``>= valid``.

CUDA design (``csrc/frontend_planes.cu``): one block per 32 frame rows
plus one halo row; each of nfft // 2 threads owns one DFT column for
all 33 rows (66 fp32 accumulators in registers) and one extra warp
computes the Nyquist column.  The spectrogram tile (in mel mode: the
power of all bins, then the mel tile) stays in shared memory and only
the planes reach device memory.  The DFT and the mel product are true
fp32 (SIMT FMA), never TF32: the log amplifies error in near-zero power
bins.  The mel product runs over each filter's nonzero bins only.

What bounds it on the H100: fp32 operations.  ``2 * 2 * N * 400 * 257``
flops (10.1 GFLOP at B=8, T_pad=3072) over 67 TFLOP/s of fp32 SIMT is
0.15 ms; the bytes (frames in, planes out: 39 + 101 MB, or 39 + 25 MB
at F = 63) take 0.04 ms or less.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.dft import (
    _mel_np,
    dft_matrices,
    log_magnitude_spectrogram,
    log_mel_spectrogram,
)

NAME = "frontend_planes"
SOURCE = "template_speech_recognition_tpu_torch/csrc/frontend_planes.cu"
REPLACES = "template_speech_recognition_tpu/ops/frontend_pallas.py:251"
# The log-mel mode counts its launches under a name of its own; on the
# log-mel scan it serves the layered frontend's four-output kernel.
MEL_NAME = "frontend_planes_mel"
MEL_REPLACES = "template_speech_recognition_tpu/ops/frontend_pallas.py:209"

# DFT columns (nfft // 2) rounded up to a warp, plus the Nyquist warp,
# must fit one block of 1024 threads
MAX_DFT_WIDTH = 992


def supported(nfft: int, n_mels: int = 0) -> bool:
    """Shapes the CUDA kernel takes: any F, a DFT width of at most 992."""
    return 1 <= nfft // 2 <= MAX_DFT_WIDTH and (n_mels == 0 or n_mels >= 2)


def edge_response_planes_plain(
    frames: torch.Tensor,       # [N, frame_length] f32 windowed frames
    nfft: int,
    sample_rate: int = 0,
    n_mels: int = 0,
) -> torch.Tensor:              # [4, N, F]
    """Plain PyTorch version: the same function in fp32 GEMMs, TF32 off
    (``ops.dft``'s spectrograms): the log amplifies TF32's ~1e-3
    relative error without bound in near-zero power bins."""
    frames = frames.to(torch.float32)
    if n_mels:
        spec = log_mel_spectrogram(frames, nfft, sample_rate, n_mels)
        f = n_mels - 1
    else:
        spec = log_magnitude_spectrogram(frames, nfft)
        f = nfft // 2
    cur = spec
    nxt = torch.cat([spec[1:], spec[-1:]])
    return torch.stack([
        nxt[:, :f] - cur[:, :f],                # d_time
        cur[:, 1 : f + 1] - cur[:, :f],         # d_freq
        nxt[:, 1 : f + 1] - cur[:, :f],         # d_diag
        nxt[:, :f] - cur[:, 1 : f + 1],         # d_anti
    ])


@functools.lru_cache(maxsize=8)
def _dft_on(frame_length: int, nfft: int, device: str):
    cos_m, sin_m = dft_matrices(frame_length, nfft, device)
    return cos_m.contiguous(), sin_m.contiguous()


@functools.lru_cache(maxsize=8)
def _mel_on(sample_rate: int, nfft: int, n_mels: int, device: str):
    """The filterbank transposed [n_mels, bins] and each filter's
    nonzero bins [lo, hi) as [n_mels, 2] int32 (0, 0 for an empty one)."""
    fb = _mel_np(sample_rate, nfft, n_mels)              # [bins, n_mels]
    nz = fb != 0
    bins = fb.shape[0]
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), bins - nz[::-1].argmax(0), 0)
    rng = np.stack([lo, hi], axis=1).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(fb.T)).to(device),
            torch.from_numpy(rng).to(device))


def edge_response_planes(
    frames: torch.Tensor,
    nfft: int,
    sample_rate: int = 0,
    n_mels: int = 0,
) -> torch.Tensor:
    """[N, frame_length] f32 -> [4, N, F] f32 planes (F = nfft // 2, or
    n_mels - 1 in log-mel mode).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if _cuda.on_cpu(frames):
        return edge_response_planes_plain(frames, nfft, sample_rate, n_mels)
    _cuda.require(frames, "frames", torch.float32, 2)
    if not supported(nfft, n_mels):
        raise ValueError(
            f"nfft={nfft}, n_mels={n_mels}: the kernel takes 1 <= nfft//2 <= "
            f"{MAX_DFT_WIDTH} and n_mels 0 or >= 2"
        )
    n, fl = frames.shape
    w = nfft // 2
    dev = str(frames.device)
    cos_m, sin_m = _dft_on(fl, nfft, dev)
    fbt = mrange = None
    f = w
    if n_mels:
        fbt, mrange = _mel_on(sample_rate, nfft, n_mels, dev)
        f = n_mels - 1
    out = torch.empty((4, n, f), dtype=torch.float32, device=frames.device)
    lib = _cuda.load("frontend_planes")
    fn = _cuda.declare(lib, "tsr_frontend_planes", 6, 4)
    err = fn(
        _cuda.ptr(frames), _cuda.ptr(cos_m), _cuda.ptr(sin_m), _cuda.ptr(fbt),
        _cuda.ptr(mrange), _cuda.ptr(out), n, fl, w, n_mels,
        _cuda.stream_ptr(frames.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(MEL_NAME if n_mels else NAME)
    return out


def edge_response_planes_4(frames, nfft, sample_rate=0, n_mels=0):
    """The four planes (dt, df, dd, da), each [N, F]: views of the
    stacked output (the layered frontend's four-output kernel)."""
    return tuple(edge_response_planes(frames, nfft, sample_rate, n_mels).unbind(0))


def edge_responses(frames, nfft, sample_rate=0, n_mels=0):
    """Channels-minor view [N, F, 8] of the planes and their negations
    (channel 2i = plane i, 2i+1 = -plane i)."""
    dt, df, dd, da = edge_response_planes_4(frames, nfft, sample_rate, n_mels)
    return torch.stack([dt, -dt, df, -df, dd, -dd, da, -da], dim=-1)
