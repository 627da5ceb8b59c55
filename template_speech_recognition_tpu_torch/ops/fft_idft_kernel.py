"""Kernel 5: inverse-DFT epilogue, written time-major.

Replaces ``template_speech_recognition_tpu/ops/fft_idft_pallas.py``
``fft_idft_pallas`` (``_kernel``; its ``pallas_call`` at line 94).

``scores[b, i*hop + tau, k] = sum_r imat[r, tau] * ycat[r, (b*nblk + i)*K + k] + c[k]``
in fp32: the iDFT GEMM, the blocks -> time reassembly and the offset
add in one pass, output ``[B, nblk*hop, K]`` (time-major).

CUDA design (``csrc/fft_idft.cu``): persistent blocks walk work items
of one block j x 128 rows of hop x 128 templates; a producer warp
streams imat and ycat, both as they lie (MN-major operands of
``wgmma``), through a 4-stage TMA ring, and two consumer warpgroups of
64 rows each run m64n128k16 ``wgmma``s; the epilogue adds ``c``, stages
the tile in shared memory and stores it with TMA through a 3-D map
over the output viewed as ``[m, hop, K]``, so a tile past hop or K is
clipped at block j's end and the reassembly costs nothing.  TMA needs
16-byte rows: K % 8 == 0, and imat is padded with zero columns to a
multiple of 8 where hop is not one (rows past hop are not stored).

What bounds it on the H100: bytes.  ycat in once and the fp32 scores
out once (63 + 101 MB at m=192, K=1024, bins=80, hop=128) take
0.049 ms; the 8 GFLOP of bf16 take 0.008 ms.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "fft_idft"
SOURCE = "template_speech_recognition_tpu_torch/csrc/fft_idft.cu"
REPLACES = "template_speech_recognition_tpu/ops/fft_idft_pallas.py:94"


def _shapes(ycat, imat, c, nblk: int):
    two_bins, mk = ycat.shape
    hop, k = imat.shape[1], c.shape[0]
    if two_bins != imat.shape[0] or mk % k or (mk // k) % nblk:
        raise ValueError(
            f"bad shapes: ycat {tuple(ycat.shape)}, imat {tuple(imat.shape)}, "
            f"K {k}, nblk {nblk}"
        )
    m = mk // k
    return two_bins, hop, k, m, m // nblk


def fft_idft_plain(ycat, imat, c, nblk: int):
    """Plain PyTorch version: one fp32 GEMM, a reassembly permute, +c."""
    _two_bins, hop, k, _m, b = _shapes(ycat, imat, c, nblk)
    s = imat.to(torch.float32).T @ ycat.to(torch.float32)     # [hop, m*K]
    s = s.reshape(hop, b, nblk, k).permute(1, 2, 0, 3).reshape(b, nblk * hop, k)
    return s + c.to(torch.float32)


def fft_idft(ycat, imat, c, nblk: int):
    """ycat [2*bins, m*K] x imat [2*bins, hop] + c [K] -> scores
    [B, nblk*hop, K] f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 ycat/imat, f32 c)."""
    if _cuda.on_cpu(ycat, imat, c):
        return fft_idft_plain(ycat, imat, c, nblk)
    _cuda.require(ycat, "ycat", torch.bfloat16, 2)
    _cuda.require(imat, "imat", torch.bfloat16, 2)
    _cuda.require(c, "c", torch.float32, 1)
    two_bins, hop, k, m, b = _shapes(ycat, imat, c, nblk)
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8")
    hop_a = -(-hop // 8) * 8
    if hop_a != hop:
        imat = torch.nn.functional.pad(imat, (0, hop_a - hop))
    if ycat.data_ptr() % 16 or imat.data_ptr() % 16:
        raise ValueError("ycat and imat must start on a 16-byte boundary (TMA)")
    out = torch.empty((b, nblk * hop, k), dtype=torch.float32, device=ycat.device)
    lib = _cuda.load("fft_idft")
    fn = _cuda.declare(lib, "tsr_fft_idft", 4, 5)
    err = fn(
        _cuda.ptr(ycat), _cuda.ptr(imat), _cuda.ptr(c), _cuda.ptr(out),
        two_bins, hop, hop_a, m, k, _cuda.stream_ptr(ycat.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
