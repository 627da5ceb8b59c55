"""Kernel 3: overlap-save blocking + forward DFT of the feature map.

Replaces ``template_speech_recognition_tpu/ops/fft_dft_pallas.py``
``fft_block_dft_pallas`` (``_kernel``; its ``pallas_call`` at line 104).

``out[f, b, i, d] = sum_{tau < nfft} g[tau, f] * x[b, i*hop + tau, d]``
with ``x`` read as zero past its T rows; ``f < bins`` goes to ``xr``
and the rest to ``xi``, both ``[bins, B, nblk, D]``.  fp32
accumulation, output in the input dtype (bf16 on the card).

CUDA design (``csrc/fft_gemm.cu``, ``DftOps``): one GEMM per (b, i)
window, M = 2*bins, N = D, K = nfft, on the shared mma.sync tile
routine.  The window gather happens in the B-operand load (row
``i*hop + tau`` of the unpadded map, zero past T), so nothing is padded
or blocked in device memory; nfft = 159 is odd and only the last
k-tile is partial.

What bounds it on the H100: bytes.  The map in once and the spectra
out once (101 + 126 MB at B=8, T_pad=3072, D=2048, bins=80, nblk=24)
take 0.068 ms; the 20 GFLOP of bf16 take 0.02 ms at 989 TFLOP/s.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "fft_block_dft"
SOURCE = "template_speech_recognition_tpu_torch/csrc/fft_gemm.cu"
REPLACES = "template_speech_recognition_tpu/ops/fft_dft_pallas.py:104"


def _check_extent(t: int, nfft: int, hop: int, nblk: int) -> None:
    if t <= (nblk - 1) * hop:
        raise ValueError("last window starts beyond the utterance")
    if t > nblk * hop + nfft - hop:
        raise ValueError(f"t {t} overruns the {nblk}-block decomposition")


def fft_block_dft_plain(x, g, nfft: int, hop: int, nblk: int):
    """Plain PyTorch version: zero-pad, unfold the windows, one fp32
    einsum, round to the input dtype."""
    b, t, d = x.shape
    _check_extent(t, nfft, hop, nblk)
    bins = g.shape[1] // 2
    tneed = nblk * hop + nfft - hop
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 0, tneed - t))
    blocks = xp.unfold(1, nfft, hop)                      # [B, nblk, D, nfft]
    out = torch.einsum("tf,bidt->fbid", g.to(torch.float32), blocks)
    out = out.to(x.dtype)
    return out[:bins].contiguous(), out[bins:].contiguous()


def fft_block_dft(x, g, nfft: int, hop: int, nblk: int):
    """x [B, T, D] x g [nfft, 2*bins] -> xr, xi [bins, B, nblk, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 only)."""
    if _cuda.on_cpu(x, g):
        return fft_block_dft_plain(x, g, nfft, hop, nblk)
    _cuda.require(x, "x", torch.bfloat16, 3)
    _cuda.require(g, "g", torch.bfloat16, 2)
    b, t, d = x.shape
    _check_extent(t, nfft, hop, nblk)
    if g.shape[0] != nfft or g.shape[1] % 2 or d % 8:
        raise ValueError(f"bad shapes: g {tuple(g.shape)}, nfft {nfft}, D {d}")
    bins = g.shape[1] // 2
    xr = torch.empty((bins, b, nblk, d), dtype=torch.bfloat16, device=x.device)
    xi = torch.empty_like(xr)
    lib = _cuda.load("fft_gemm")
    fn = _cuda.declare(lib, "tsr_fft_block_dft", 4, 7)
    err = fn(
        _cuda.ptr(x), _cuda.ptr(g), _cuda.ptr(xr), _cuda.ptr(xi),
        b, t, d, nfft, hop, nblk, bins, _cuda.stream_ptr(x.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return xr, xi
