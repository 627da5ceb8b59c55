"""Kernel 1: windowed frames -> the four oriented difference planes.

Replaces ``template_speech_recognition_tpu/ops/frontend_pallas.py``
``edge_response_planes_stacked_pallas`` (``_kernel_stacked``,
``_make_logspec``; its ``pallas_call`` at line 251), non-mel mode.

Computes, for frame rows ``r`` of ``frames [N, frame_length]``:
``spec[r] = 0.5 * log(re^2 + im^2 + 1e-6)`` with ``re, im`` the DFT of
the frame against cos / -sin ``[frame_length, nfft//2 + 1]`` (the
Nyquist column included), then the four differences against the next
row ``r + 1`` (dt, df, dd, da), written plane-major ``[4, N, F]``,
``F = nfft // 2``.  The last row's next row is clamped (row ``N - 1``
itself): garbage by contract, as on the TPU -- callers mask rows
``>= valid``.

CUDA design (``csrc/frontend_planes.cu``): one block per 32 frame rows
plus one halo row; each of F threads owns one DFT column for all 33
rows (66 fp32 accumulators in registers) and one extra warp computes
the Nyquist column, so the spectrogram tile, its log and all four
differences stay in shared memory and only the planes reach device
memory.  The DFT is true fp32 (SIMT FMA), never TF32: the log
amplifies error in near-zero power bins.

What bounds it on the H100: fp32 operations.  ``2 * 2 * N * 400 * 257``
flops (10.1 GFLOP at B=8, T_pad=3072) over 67 TFLOP/s of fp32 SIMT is
0.15 ms; the bytes (frames in, planes out: 39 + 101 MB) take 0.04 ms.
"""

from __future__ import annotations

import functools

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.dft import (
    LOG_EPS,
    dft_matrices,
    mel_filterbank,
)

NAME = "frontend_planes"
SOURCE = "template_speech_recognition_tpu_torch/csrc/frontend_planes.cu"
REPLACES = "template_speech_recognition_tpu/ops/frontend_pallas.py:251"


def edge_response_planes_plain(
    frames: torch.Tensor,       # [N, frame_length] f32 windowed frames
    nfft: int,
    sample_rate: int = 0,
    n_mels: int = 0,
) -> torch.Tensor:              # [4, N, F]
    """Plain PyTorch version: the same function in fp32 GEMMs.

    TF32 is switched off for matmuls here (PyTorch's default, stated
    and set): the log amplifies TF32's ~1e-3 relative error without
    bound in near-zero power bins."""
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = frames.to(torch.float32)
    cos_m, sin_m = dft_matrices(frames.shape[1], nfft, frames.device)
    re = frames @ cos_m
    im = frames @ sin_m
    power = re * re + im * im
    if n_mels:
        fb = mel_filterbank(sample_rate, nfft, n_mels, frames.device)
        spec = torch.log(power @ fb + float(LOG_EPS))
        f = n_mels - 1
    else:
        spec = torch.log(power + float(LOG_EPS)) * 0.5
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


def edge_response_planes(
    frames: torch.Tensor,
    nfft: int,
    sample_rate: int = 0,
    n_mels: int = 0,
) -> torch.Tensor:
    """[N, frame_length] f32 -> [4, N, nfft//2] f32 planes.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if _cuda.on_cpu(frames):
        return edge_response_planes_plain(frames, nfft, sample_rate, n_mels)
    if n_mels:
        raise NotImplementedError(
            "the mel mode of kernel 1 has no CUDA kernel yet "
            "(ROADMAP.md Queue 2, 'frontend planes: mel mode')"
        )
    _cuda.require(frames, "frames", torch.float32, 2)
    n, fl = frames.shape
    f = nfft // 2
    if f % 32 or f + 32 > 1024:
        raise ValueError(f"nfft//2={f} must be a multiple of 32 and <= 992")
    cos_m, sin_m = _dft_on(fl, nfft, str(frames.device))
    out = torch.empty((4, n, f), dtype=torch.float32, device=frames.device)
    lib = _cuda.load("frontend_planes")
    fn = _cuda.declare(lib, "tsr_frontend_planes", 4, 3)
    err = fn(
        _cuda.ptr(frames), _cuda.ptr(cos_m), _cuda.ptr(sin_m), _cuda.ptr(out),
        n, fl, f, _cuda.stream_ptr(frames.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
