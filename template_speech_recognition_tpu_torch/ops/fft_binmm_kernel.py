"""Kernel 4: per-bin complex bank matmul.

Replaces ``template_speech_recognition_tpu/ops/fft_binmm_pallas.py``
``fft_binmm_pallas``, bf16 ``_kernel`` (its ``pallas_call`` at line
202), with the 3-D wrapper ``detect/fft_scorer.py::_binmm_pallas``.

Per frequency bin: ``[Xr | Xi ; Xi | -Xr] [2m, 2D] @ W2 [2D, K]`` with
fp32 accumulation, written ``[2, bins, m, K]`` in the input dtype:
``y[0]`` is the real part of ``Xf * conj(Wf)``, ``y[1]`` the imaginary.

CUDA design (``csrc/fft_binmm.cu``): TMA loads into a 4-stage
shared-memory ring feed ``wgmma`` from one producer warp.  A block owns
a 64-row slab of m, a 256-wide tile of K and one bin; consumer
warpgroup 0 accumulates the real part and warpgroup 1 the imaginary
part on the same stages (an Xr tile, an Xi tile and a W2 tile each).
The contraction runs over W2's two halves in turn; in the second, the
imaginary part multiplies Xr with ``wgmma``'s immediate scale-a = -1,
so the packed operand is never built.  W2 is read in place as an
MN-major B operand (transpose-B, 128-byte swizzle); rows past m, D and
K are TMA's zero fill.  Slabs are adjacent in the grid, so W2 streams
from device memory about once.

What bounds it on the H100: bf16 operations, just above the ridge.
258 GFLOP (m=192, D=2048, K=1024, bins=80) take 0.26 ms at 989
TFLOP/s; W2 (671 MB) plus xr/xi and the output take 0.23 ms.  The
mma.sync routine it replaced ran at ~15% of that peak, fed from
registers, without a deep enough ring to hide the W2 stream.

The int8 mode (``fft_binmm_int8``, the ``DetectConfig.int8_spectra``
bank) replaces the same ``pallas_call`` running ``_kernel_q`` (line
81): int8 x int8 -> exact int32, flushed as ``bf16(f32(acc) * sc[bin,
k])``.  Its kernel (``csrc/fft_binmm_int8.cu``) keeps the 128 x 128
tile of ``csrc/fft_gemm.cu`` on mma.sync m16n8k32 s8; W2 is
K-contiguous, so each thread transposes 4 x 4 bytes of it with byte
permutes on the way into shared memory.
D need only be a multiple of 8 (log-mel D = 504: rows 8-byte aligned).
What bounds it: bytes, 461 MB (int8 W2 336 MB, xr/xi, bf16 output) in
0.138 ms at 3.35 TB/s; 258 G int8 operations take 0.130 ms at 1979
TOP/s.  The TPU path's ``k <= 4096`` gate (a Mosaic crash) is not
carried over.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "fft_binmm"
SOURCE = "template_speech_recognition_tpu_torch/csrc/fft_binmm.cu"
REPLACES = "template_speech_recognition_tpu/ops/fft_binmm_pallas.py:202"
INT8_NAME = "fft_binmm_int8"
INT8_SOURCE = "template_speech_recognition_tpu_torch/csrc/fft_binmm_int8.cu"
INT8_REPLACES = "template_speech_recognition_tpu/ops/fft_binmm_pallas.py:81"


def fft_binmm_plain(xr, xi, w2):
    """Plain PyTorch version: materialize the packed operand, one fp32
    batched product (TF32 off, PyTorch's default), round."""
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d).to(torch.float32)
    xi3 = xi.reshape(bins, -1, d).to(torch.float32)
    m = xr3.shape[1]
    x2 = torch.cat(
        [torch.cat([xr3, xi3], dim=2), torch.cat([xi3, -xr3], dim=2)], dim=1
    )                                                      # [bins, 2m, 2D]
    y = torch.bmm(x2, w2.to(torch.float32)).to(xr.dtype)   # [bins, 2m, K]
    return torch.stack([y[:, :m], y[:, m:]])


def fft_binmm(xr, xi, w2):
    """xr, xi [bins, m, D] (or [bins, B, nblk, D]) x W2 [bins, 2D, K]
    -> [2, bins, m, K].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 only)."""
    if _cuda.on_cpu(xr, xi, w2):
        return fft_binmm_plain(xr, xi, w2)
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d)
    xi3 = xi.reshape(bins, -1, d)
    _cuda.require(xr3, "xr", torch.bfloat16, 3)
    _cuda.require(xi3, "xi", torch.bfloat16, 3)
    _cuda.require(w2, "w2", torch.bfloat16, 3)
    m = xr3.shape[1]
    k = w2.shape[2]
    if xi3.shape != xr3.shape or tuple(w2.shape[:2]) != (bins, 2 * d):
        raise ValueError(f"bad shapes: xr {tuple(xr.shape)}, w2 {tuple(w2.shape)}")
    if d % 8 or k % 8:
        raise ValueError(f"D={d} and K={k} must be multiples of 8")
    if any(a.data_ptr() % 16 for a in (xr3, xi3, w2)):
        raise ValueError("xr, xi and w2 must be 16-byte aligned")
    out = torch.empty((2, bins, m, k), dtype=torch.bfloat16, device=xr.device)
    lib = _cuda.load("fft_binmm")
    fn = _cuda.declare(lib, "tsr_fft_binmm", 4, 4)
    err = fn(
        _cuda.ptr(xr3), _cuda.ptr(xi3), _cuda.ptr(w2), _cuda.ptr(out),
        bins, m, d, k, _cuda.stream_ptr(xr.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out


def fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype=torch.bfloat16):
    """Plain PyTorch version of the int8 mode: the packed operand and
    one float64 batched product, exact for int8 operands (every partial
    sum is an integer below 2**53), then ``f32(acc) * sc`` rounded to
    ``out_dtype``."""
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d).to(torch.float64)
    xi3 = xi.reshape(bins, -1, d).to(torch.float64)
    m = xr3.shape[1]
    x2 = torch.cat(
        [torch.cat([xr3, xi3], dim=2), torch.cat([xi3, -xr3], dim=2)], dim=1
    )                                                      # [bins, 2m, 2D]
    acc = torch.bmm(x2, w2.to(torch.float64))              # [bins, 2m, K]
    y = (acc.to(torch.float32) * sc.to(torch.float32)[:, None, :]).to(out_dtype)
    return torch.stack([y[:, :m], y[:, m:]])


def fft_binmm_int8(xr, xi, w2, sc, out_dtype=torch.bfloat16):
    """int8 xr, xi [bins, m, D] (or [bins, B, nblk, D]) x int8 W2
    [bins, 2D, K], dequantized by ``sc`` [bins, K] f32 -> [2, bins, m, K]
    in ``out_dtype``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, whose output is bf16."""
    if _cuda.on_cpu(xr, xi, w2, sc):
        return fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the int8 kernel writes bfloat16, not {out_dtype}")
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d)
    xi3 = xi.reshape(bins, -1, d)
    _cuda.require(xr3, "xr", torch.int8, 3)
    _cuda.require(xi3, "xi", torch.int8, 3)
    _cuda.require(w2, "w2", torch.int8, 3)
    _cuda.require(sc, "sc", torch.float32, 2)
    m = xr3.shape[1]
    k = w2.shape[2]
    if (xi3.shape != xr3.shape or tuple(w2.shape[:2]) != (bins, 2 * d)
            or tuple(sc.shape) != (bins, k)):
        raise ValueError(f"bad shapes: xr {tuple(xr.shape)}, w2 {tuple(w2.shape)}, "
                         f"sc {tuple(sc.shape)}")
    if d % 8 or k % 4:
        raise ValueError(f"D={d} must be a multiple of 8 and K={k} of 4")
    if any(a.data_ptr() % 16 for a in (xr3, xi3, w2)):
        raise ValueError("xr, xi and w2 must be 16-byte aligned")
    out = torch.empty((2, bins, m, k), dtype=torch.bfloat16, device=xr.device)
    lib = _cuda.load("fft_binmm_int8")
    fn = _cuda.declare(lib, "tsr_fft_binmm_int8", 5, 4)
    err = fn(
        _cuda.ptr(xr3), _cuda.ptr(xi3), _cuda.ptr(w2), _cuda.ptr(sc), _cuda.ptr(out),
        bins, m, d, k, _cuda.stream_ptr(xr.device),
    )
    _cuda.check(lib, err, INT8_NAME)
    _cuda.count_launch(INT8_NAME)
    return out
