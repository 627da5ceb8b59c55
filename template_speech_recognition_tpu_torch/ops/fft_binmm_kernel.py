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
K are TMA's zero fill.  TMA's 16-byte rows want D % 8 = 0: the FFT
bank's spectra are built padded to D8 rows a half (``pad_spectra``,
``detect/fft_scorer.py``), the scan pads its map to D8 once a call, and
the wrapper pads any other operand itself.  Slabs are adjacent in the grid, so W2 streams
from device memory about once.

What bounds it on the H100: bf16 operations, just above the ridge.
258 GFLOP (m=192, D=2048, K=1024, bins=80) take 0.26 ms at 989
TFLOP/s; W2 (671 MB) plus xr/xi and the output take 0.23 ms.  The
mma.sync routine it replaced ran at ~15% of that peak, fed from
registers, without a deep enough ring to hide the W2 stream.

The int8 mode (``fft_binmm_int8``, the ``DetectConfig.int8_spectra``
bank) replaces the same ``pallas_call`` running ``_kernel_q`` (line
81): int8 x int8 -> exact int32, flushed as ``bf16(f32(acc) * sc[bin,
k])``.  Its kernel (``csrc/fft_binmm_int8.cu``) is the bf16 kernel's
pipeline on int8 ``wgmma`` (m64n256k32, s8 x s8 -> s32), with two
differences that int8 ``wgmma`` forces: it takes only K-major operands,
so W2 comes as the bank's K-major copy (``kmajor_spectra``, built once
with the bank: ``FFTBank.w2_kmajor``), and it has no scale-a, so the
imaginary part is summed over W2's second half first, negated in
registers at the seam, then summed over the first half
(``fft_binmm_int8_emulated`` runs that schedule in PyTorch).  TMA
needs 16-byte row strides: xr and xi come as views of rows padded to
16 bytes (``detect.fft_scorer.quantize_block_spectra`` writes them so)
and the K-major copy's rows are padded the same way.  The bf16 output
is staged in shared memory and stored by TMA.
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


def pad_spectra(w2: torch.Tensor, d: int) -> torch.Tensor:
    """W2 [bins, 2D, K] -> [bins, 2 D8, K] (D8 = ceil(D/8)*8): each
    half's D rows, then zero rows to D8, so it meets spectra padded to
    D8 columns.  ``w2`` itself where D % 8 == 0."""
    d8 = _cuda.padded_width(d)
    if d8 == d:
        return w2
    bins, _, k = w2.shape
    out = w2.new_zeros((bins, 2, d8, k))
    out[:, :, :d] = w2.reshape(bins, 2, d, k)
    return out.reshape(bins, 2 * d8, k)


def fft_binmm(xr, xi, w2):
    """xr, xi [bins, m, D] (or [bins, B, nblk, D]) x W2 [bins, 2D, K]
    -> [2, bins, m, K].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 only; K a multiple of 8).  Any D
    and any base: where the rows do not suit TMA the kernel runs on
    copies padded to D8 columns (``pad_spectra`` for W2); the scan's
    bank and spectra come padded already, so it copies nothing."""
    if _cuda.on_cpu(xr, xi, w2):
        return fft_binmm_plain(xr, xi, w2)
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d)
    xi3 = xi.reshape(bins, -1, d)
    _cuda.require(w2, "w2", torch.bfloat16, 3)
    m = xr3.shape[1]
    k = w2.shape[2]
    if xi3.shape != xr3.shape or tuple(w2.shape[:2]) != (bins, 2 * d):
        raise ValueError(f"bad shapes: xr {tuple(xr.shape)}, w2 {tuple(w2.shape)}")
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8")
    if w2.data_ptr() % 16:
        w2 = w2.clone()
    # TMA's 16-byte rows: where D % 8 != 0, or xr / xi are strided views
    # (kernel 3's outputs at such a D) or off 16 bytes, zero-padded
    # copies of D8 columns, and W2's two halves padded alike
    xr3, xi3 = _cuda.aligned_rows(xr3), _cuda.aligned_rows(xi3)
    if xr3.shape[2] != d:
        w2 = pad_spectra(w2, d)
        d = xr3.shape[2]
    _cuda.require(xr3, "xr", torch.bfloat16, 3)
    _cuda.require(xi3, "xi", torch.bfloat16, 3)
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


def int8_row_width(d: int) -> int:
    """Bytes of an int8 operand row as the int8 kernel's TMA reads it:
    ``d`` rounded up to 16 (TMA takes only 16-byte row strides)."""
    return -(-d // 16) * 16


def kmajor_spectra(w2: torch.Tensor) -> torch.Tensor:
    """int8 W2 [bins, 2D, K] -> its K-major copy [bins, 2, K, Dp]:
    ``out[z, h, k, j] = w2[z, h*D + j, k]`` for j < D, zero for D <= j <
    Dp = ``int8_row_width(D)``.  int8 ``wgmma`` reads B only K-major;
    the bank builds this once, never the scan."""
    bins, d2, k = w2.shape
    d = d2 // 2
    out = torch.zeros((bins, 2, k, int8_row_width(d)), dtype=w2.dtype, device=w2.device)
    out[..., :d] = w2.reshape(bins, 2, d, k).transpose(2, 3)
    return out


def fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype=torch.bfloat16, w2_kmajor=None):
    """Plain PyTorch version of the int8 mode: the packed operand and
    one float64 batched product, exact for int8 operands (every partial
    sum is an integer below 2**53), then ``f32(acc) * sc`` rounded to
    ``out_dtype``.  ``w2_kmajor`` is the kernel's operand and is not
    read here."""
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


# the int8 kernel's contraction step: one 128-byte swizzled row of int8
INT8_BK = 128


def fft_binmm_int8_emulated(xr, xi, w2_kmajor, sc, out_dtype=torch.bfloat16):
    """The int8 kernel's schedule in PyTorch, for the CPU tests: int32
    sums over k steps of ``INT8_BK`` read as TMA reads them (xr, xi zero
    past D; the K-major copy zero past D in each half), W2's second half
    (Wb) first: the real part sums ``Xi . Wb`` and the imaginary part
    ``Xr . Wb``, which it negates at the seam; then the first half (Wa):
    ``Xr . Wa`` and ``Xi . Wa``.  Flushed as ``f32(acc) * sc``."""
    bins, d = xr.shape[0], xr.shape[-1]
    xr3, xi3 = xr.reshape(bins, -1, d), xi.reshape(bins, -1, d)
    m, k = xr3.shape[1], w2_kmajor.shape[2]
    nk = -(-d // INT8_BK)
    width = nk * INT8_BK

    def box(a):                                # [.., D] -> [.., nk*BK], zero past D
        out = torch.zeros(a.shape[:-1] + (width,), dtype=torch.int32, device=a.device)
        out[..., :d] = a[..., :d]
        return out

    xr_b, xi_b = box(xr3), box(xi3)
    w_b = [box(w2_kmajor[:, h]) for h in (0, 1)]           # [bins, K, nk*BK]
    acc = [torch.zeros((bins, m, k), dtype=torch.int32, device=xr.device) for _ in range(2)]
    for half, (a_re, a_im) in ((1, (xi_b, xr_b)), (0, (xr_b, xi_b))):
        if half == 0:
            acc[1] = -acc[1]                   # the seam: Xi.Wa - Xr.Wb
        for kt in range(nk):
            ks = slice(kt * INT8_BK, (kt + 1) * INT8_BK)
            wt = w_b[half][:, :, ks].transpose(1, 2)
            acc[0] += torch.bmm(a_re[:, :, ks], wt)
            acc[1] += torch.bmm(a_im[:, :, ks], wt)
    scf = sc.to(torch.float32)[:, None, :]
    return torch.stack([(a.to(torch.float32) * scf).to(out_dtype) for a in acc])


def int8_tma_strides(x3, name="x"):
    """(row stride, bin stride) in bytes of an int8 [bins, m, D] view as
    the int8 kernel's TMA map takes them: unit element stride, 16-byte
    row and bin strides (a size-1 dimension's stride is not read, and
    is taken as the dense one), a 16-byte aligned base; raises
    otherwise."""
    bins, m, d = x3.shape
    rs = x3.stride(1) if m > 1 else int8_row_width(d)
    bs = x3.stride(0) if bins > 1 else rs * m
    if (x3.stride(2) != 1 and d > 1) or rs % 16 or bs % 16 or rs < d or bs < rs * m \
            or x3.data_ptr() % 16:
        raise ValueError(
            f"{name}: TMA needs 16-byte row and bin strides and a 16-byte aligned base, got "
            f"strides {x3.stride()} for shape {tuple(x3.shape)} (quantize_block_spectra "
            f"writes rows padded to 16 bytes)")
    return rs, bs


def fft_binmm_int8(xr, xi, w2, sc, out_dtype=torch.bfloat16, w2_kmajor=None):
    """int8 xr, xi [bins, m, D] (or [bins, B, nblk, D]) x int8 W2
    [bins, 2D, K], dequantized by ``sc`` [bins, K] f32 -> [2, bins, m, K]
    in ``out_dtype``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, whose output is bf16.

    On the card xr and xi must have 16-byte row strides (views of rows
    padded to 16 bytes, as ``quantize_block_spectra`` returns them),
    and the kernel reads W2 as its K-major copy ``w2_kmajor``
    (``kmajor_spectra(w2)``, which the int8 bank carries).  Without
    one, the copy is built here on every call: that path is for the
    small checks, never the scan's."""
    if _cuda.on_cpu(xr, xi, w2, sc):
        return fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the int8 kernel writes bfloat16, not {out_dtype}")
    bins, d = xr.shape[0], xr.shape[-1]
    xr3 = xr.reshape(bins, -1, d)
    xi3 = xi.reshape(bins, -1, d)
    _cuda.require(w2, "w2", torch.int8, 3)
    _cuda.require(sc, "sc", torch.float32, 2)
    m = xr3.shape[1]
    k = w2.shape[2]
    if (xi3.shape != xr3.shape or tuple(w2.shape[:2]) != (bins, 2 * d)
            or tuple(sc.shape) != (bins, k)):
        raise ValueError(f"bad shapes: xr {tuple(xr.shape)}, w2 {tuple(w2.shape)}, "
                         f"sc {tuple(sc.shape)}")
    if k % 8 or sc.data_ptr() % 8:
        raise ValueError(f"K={k} must be a multiple of 8 (16-byte bf16 output rows) and sc "
                         f"8-byte aligned")
    for x, name in ((xr3, "xr"), (xi3, "xi")):
        if x.device.type != "cuda" or x.dtype != torch.int8:
            raise ValueError(f"{name}: expected a CUDA int8 tensor, got {x.device} {x.dtype}")
    rs, bs = int8_tma_strides(xr3, "xr")
    if int8_tma_strides(xi3, "xi") != (rs, bs):
        raise ValueError("xr and xi must have the same strides")
    if w2_kmajor is None:
        w2_kmajor = kmajor_spectra(w2)
    _cuda.require(w2_kmajor, "w2_kmajor", torch.int8, 4)
    dp = w2_kmajor.shape[3]
    if (tuple(w2_kmajor.shape[:3]) != (bins, 2, k) or dp % 16 or dp < d
            or w2_kmajor.data_ptr() % 16):
        raise ValueError(f"w2_kmajor {tuple(w2_kmajor.shape)}: expected ({bins}, 2, {k}, Dp) "
                         f"with Dp >= {d} a multiple of 16, 16-byte aligned")
    out = torch.empty((2, bins, m, k), dtype=torch.bfloat16, device=xr.device)
    lib = _cuda.load("fft_binmm_int8")
    fn = _cuda.declare(lib, "tsr_fft_binmm_int8", 5, 5, 2)
    err = fn(
        _cuda.ptr(xr3), _cuda.ptr(xi3), _cuda.ptr(w2_kmajor), _cuda.ptr(sc), _cuda.ptr(out),
        rs, bs, bins, m, d, dp, k, _cuda.stream_ptr(xr.device),
    )
    _cuda.check(lib, err, INT8_NAME)
    _cuda.count_launch(INT8_NAME)
    return out
