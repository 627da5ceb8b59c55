"""FFT-domain sliding-window LLR correlation (overlap-save).

Counterpart of ``template_speech_recognition_tpu.detect.fft_scorer``.
Scores ``s[b, t, k] = sum_{l, d} W[k, l, d] x[b, t + l, d] + c[k]``
are computed as GEMMs in the frequency domain:

1. overlap-save blocks of ``nfft`` frames (hop = nfft - L + 1) and the
   forward DFT of each block -- kernel 3 (``ops.fft_dft_kernel``);
2. per bin, the complex product with the template spectra W2 as one
   real GEMM ``[Xr|Xi ; Xi|-Xr] @ W2`` -- kernel 4
   (``ops.fft_binmm_kernel``);
3. the inverse DFT of the first ``hop`` samples per block, written
   time-major with the offsets ``c`` added -- kernel 5
   (``ops.fft_idft_kernel``).

Numerics follow the reference: on the card every GEMM operand is bf16
(``g``, ``imat``, ``w2``, the map, ``xr``/``xi``, ``ycat``) with fp32
accumulation; on the CPU everything is float32.  One step goes further
than the reference: on the card kernel 4 (or 6) writes ``ycat`` as two
bf16 planes, hi and the remainder lo, and kernel 5
contracts both against ``imat`` stacked twice, so the product is not
rounded to bf16 (a trained bank's low bins run ~60x above its scores:
one bf16 step of them was ~0.6% of max|score| at the soak's K 10,000
bank; ROADMAP Queue 3).

int8 spectra (``build_fft_bank(mm_dtype=torch.int8)``, the config-5
bank-scale mode): W2 is quantized per (bin, template) once, the block
spectra ``xr``/``xi`` per bin on every call over the call's whole
extent, and step 2 runs int8 x int8 with exact int32 accumulation
(``ops.fft_binmm_kernel.fft_binmm_int8``), dequantized at its flush.
The DFT and the iDFT keep the working type (bf16 on the card, float32
on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
    fft_binmm,
    fft_binmm_int8,
    fft_binmm_int8_plain,
    fft_binmm_plain,
    int8_row_width,
    kmajor_spectra,
    pad_spectra,
)
from template_speech_recognition_tpu_torch.ops.fft_dft_kernel import (
    fft_block_dft,
    fft_block_dft_plain,
)
from template_speech_recognition_tpu_torch.ops.fft_idft_kernel import (
    fft_idft,
    fft_idft_plain,
)


def pick_nfft(length: int, bank_k: int = 0) -> int:
    """hop = 16-aligned ~4*L (banks of 4096 templates or more: ~6*L),
    nfft = hop + L - 1.  Copied unchanged from the reference, whose
    constants were swept on a TPU; they define the parity target here
    (a sweep on the H100 is later work).  Kernel 3 has a plan for every
    nfft >= 2 (``ops.fft_dft_kernel.plan``), so every L scans on the
    card."""
    mult = 6 if bank_k >= 4096 else 4
    hop = max(16, ((mult * length + 15) // 16) * 16)
    return hop + length - 1


@dataclasses.dataclass(frozen=True)
class FFTBank:
    """Frequency-domain template bank: ``w2`` [bins, 2D, K] spectra
    (real stacked on imaginary along the contraction axis) and ``c``
    [K] score offsets.  In the int8 mode ``w2`` holds the quantized
    spectra, ``w2_scale`` [bins, K] f32 their dequantization factors
    and ``w2_kmajor`` [bins, 2, K, Dp] their K-major copy, rows padded
    to 16 bytes (``ops.fft_binmm_kernel.kmajor_spectra``): the int8
    kernel's operand, built once here so the scan never transposes W2
    (+336 MB of device memory at K 1024, D 2048, 80 bins).

    On the card the kernels take K only in multiples of 8 (16-byte rows
    of bf16 output), so a bank of another K carries zero templates up to
    the next multiple (``k``: the spectra's columns); ``num_templates``
    is the bank's own K, the scores' width.  Their TMA rows want D in
    multiples of 8 too, so on every device each half of ``w2`` holds D8
    = ceil(D/8)*8 rows, zeros past D (``dp``; ``d`` stays the map's D):
    ``fft_sliding_scores`` pads the map to ``dp`` columns once a call,
    and the padded columns multiply zeros."""

    w2: torch.Tensor
    c: torch.Tensor
    length: int
    nfft: int
    d: int
    w2_scale: torch.Tensor | None = None
    w2_kmajor: torch.Tensor | None = None
    num_templates: int = 0

    @property
    def k(self) -> int:
        return self.w2.shape[-1]

    @property
    def dp(self) -> int:
        """Rows a half of ``w2``: D rounded up to 8."""
        return self.w2.shape[1] // 2


def _dft_mats(nfft: int, dtype, device=None):
    t = np.arange(nfft)
    f = np.arange(nfft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(t, f) / nfft
    return (
        torch.from_numpy(np.cos(ang)).to(device=device, dtype=dtype),
        torch.from_numpy(np.sin(ang)).to(device=device, dtype=dtype),
    )


def _idft_mats(nfft: int, nout: int, dtype, device=None):
    f = np.arange(nfft // 2 + 1)
    t = np.arange(nout)
    ang = 2.0 * np.pi * np.outer(f, t) / nfft
    wgt = np.full((nfft // 2 + 1, 1), 2.0)
    wgt[0] = 1.0
    if nfft % 2 == 0:
        wgt[-1] = 1.0          # the Nyquist bin exists only for even nfft
    return (
        torch.from_numpy(np.cos(ang) * wgt / nfft).to(device=device, dtype=dtype),
        torch.from_numpy(np.sin(ang) * wgt / nfft).to(device=device, dtype=dtype),
    )


@functools.lru_cache(maxsize=16)
def _dft_basis(nfft: int, dtype, device) -> torch.Tensor:
    """g = [cos | -sin] [nfft, 2 bins], the block DFT's basis, made once
    per (nfft, dtype, device): a copy from host memory to the card blocks
    the host until the device has run everything queued before it, so a
    scan must not make it per batch.  Callers read it, never write it."""
    cmat, smat = _dft_mats(nfft, dtype, device)
    return torch.cat([cmat, -smat], dim=1).contiguous()


@functools.lru_cache(maxsize=16)
def _idft_basis(nfft: int, hop: int, dtype, device, copies: int = 1) -> torch.Tensor:
    """imat = [icos ; -isin] [2 bins, hop], the iDFT's basis, made once
    per (nfft, hop, dtype, device) for the same reason; ``copies`` of it
    stacked (2: for the hi and lo planes of a bf16 ``ycat``)."""
    icmat, ismat = _idft_mats(nfft, hop, dtype, device)
    return torch.cat([icmat, -ismat] * copies, dim=0).contiguous()


def _bank_spectra(w: torch.Tensor, nfft: int, mm_dtype) -> torch.Tensor:
    """[K, L, D] filters -> [bins, 2D, K] spectra (float32 math).  The
    zero padding to nfft frames contributes nothing, so only the L
    rows of the DFT matrices are multiplied."""
    length = w.shape[1]
    cmat, smat = _dft_mats(nfft, torch.float32, w.device)
    w = w.to(torch.float32)
    wr = torch.einsum("ktd,tf->fdk", w, cmat[:length])
    wi = -torch.einsum("ktd,tf->fdk", w, smat[:length])
    return torch.cat([wr, wi], dim=1).to(mm_dtype)


def pad_templates(w: torch.Tensor, c: torch.Tensor, multiple: int = 8):
    """Filters [K, L, D] and offsets [K] with zero templates appended up
    to the next multiple of ``multiple`` (the card's kernels' K); their
    scores are sliced off (``FFTBank.num_templates``)."""
    k = w.shape[0]
    extra = -(-k // multiple) * multiple - k
    if not extra:
        return w, c
    return (torch.cat([w, w.new_zeros((extra,) + tuple(w.shape[1:]))]),
            torch.cat([c, c.new_zeros(extra)]))


def build_fft_bank(w: torch.Tensor, c: torch.Tensor, nfft: int | None = None,
                   mm_dtype=None) -> FFTBank:
    """One-time per-bank setup: W [K, L, F, E] (or [K, L, D]) + c [K]
    -> frequency-domain bank.  ``mm_dtype=None`` picks bfloat16 on the
    card (the kernels' operand type) and float32 on the CPU;
    ``torch.int8`` builds the int8 spectra: symmetric per-(bin,
    template) scales ``max(max|w2| over 2D, 1e-30) / 127`` and
    ``clip(round(w2 / scale), -127, 127)`` (round half to even, as the
    reference).  Each half of the spectra is padded to D8 rows
    (``FFTBank.dp``)."""
    if mm_dtype is None:
        mm_dtype = torch.bfloat16 if w.device.type == "cuda" else torch.float32
    if mm_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"mm_dtype {mm_dtype}: float32, bfloat16 or int8")
    k, length = w.shape[0], w.shape[1]
    d = int(np.prod(w.shape[2:]))
    if nfft is None:
        nfft = pick_nfft(length, bank_k=k)
    if nfft - length + 1 <= 0:
        raise ValueError(f"nfft {nfft} too small for template length {length}: "
                         f"nfft >= L is the only limit on it")
    w, c = w.reshape(k, length, d), c.to(torch.float32)
    if w.device.type == "cuda":
        w, c = pad_templates(w, c)
    if mm_dtype == torch.int8:
        w2f = _bank_spectra(w, nfft, torch.float32)
        scale = torch.clamp(w2f.abs().amax(dim=1), min=1e-30) / 127.0   # [bins, K]
        w2q = torch.clamp(torch.round(w2f / scale[:, None, :]), -127, 127)
        w2q = pad_spectra(w2q.to(torch.int8).contiguous(), d)
        return FFTBank(w2=w2q, c=c, length=length, nfft=nfft, d=d,
                       w2_scale=scale.contiguous(), w2_kmajor=kmajor_spectra(w2q),
                       num_templates=k)
    w2 = pad_spectra(_bank_spectra(w, nfft, mm_dtype).contiguous(), d)
    return FFTBank(w2=w2, c=c, length=length, nfft=nfft, d=d, num_templates=k)


def quantize_block_spectra(xr, xi, w2_scale):
    """Dynamic per-bin symmetric int8 quantization of the block spectra
    ``xr``, ``xi`` [bins, ...] over their whole extent -> (int8 xr, int8
    xi, ``sc`` [bins, K] f32), where ``sc`` folds the block scale into
    the bank's ``w2_scale`` for the bin matmul's flush.

    xq_r and xq_i are views ``[..., :D]`` of one zero-padded buffer
    whose rows are D rounded up to 16 bytes, the strides the int8
    kernel's TMA loads take (log-mel D = 504)."""
    dims = tuple(range(1, xr.dim()))
    xr32, xi32 = xr.to(torch.float32), xi.to(torch.float32)
    sx = torch.clamp(
        torch.maximum(xr32.abs().amax(dim=dims), xi32.abs().amax(dim=dims)), min=1e-30
    ) / 127.0                                                   # [bins]
    sxb = sx.reshape((-1,) + (1,) * len(dims))
    d = xr.shape[-1]
    buf = torch.zeros((2,) + tuple(xr.shape[:-1]) + (int8_row_width(d),),
                      dtype=torch.int8, device=xr.device)
    xq_r, xq_i = buf[0, ..., :d], buf[1, ..., :d]
    xq_r.copy_(torch.clamp(torch.round(xr32 / sxb), -127, 127))
    xq_i.copy_(torch.clamp(torch.round(xi32 / sxb), -127, 127))
    return xq_r, xq_i, sx[:, None] * w2_scale


def fft_sliding_scores(
    feats: torch.Tensor,
    bank: FFTBank,
    time_major: bool = False,
    trim: bool = True,
    plain: bool = False,
) -> torch.Tensor:
    """feats [B, T, F, E] (or [B, T, D]; bool/float) -> [B, K, T-L+1]
    (or [B, T-L+1, K] with ``time_major``).

    Window starts whose support overruns T read zero padding; callers
    mask them (``detect.scorer.masked_scores``).  ``trim=False``
    (time-major only) returns all ``nblk*hop`` rows.  ``plain=True``
    runs the kernels' plain PyTorch versions on any device."""
    if not trim and not time_major:
        raise ValueError("trim=False requires time_major=True")
    length, nfft, d = bank.length, bank.nfft, bank.d
    dev = feats.device
    quant = bank.w2_scale is not None
    if quant:
        # only the bin matmul runs in int8
        mm = torch.bfloat16 if dev.type == "cuda" else torch.float32
    else:
        mm = bank.w2.dtype
    b, t = feats.shape[0], feats.shape[1]
    x = feats.reshape(b, t, d).to(mm).contiguous()
    if bank.dp != d:
        # the bank's D8 rows: the map zero-padded to match, once a call
        x = torch.nn.functional.pad(x, (0, bank.dp - d))
    tout = t - length + 1
    if tout <= 0:
        raise ValueError(f"T {t} shorter than template length {length}")
    hop = nfft - length + 1
    bins = nfft // 2 + 1
    nblk = -(-tout // hop)
    m = b * nblk
    k = bank.k

    dft_fn = fft_block_dft_plain if plain else fft_block_dft
    binmm_fn = fft_binmm_plain if plain else fft_binmm
    binmm_int8_fn = fft_binmm_int8_plain if plain else fft_binmm_int8
    idft_fn = fft_idft_plain if plain else fft_idft

    g = _dft_basis(nfft, mm, dev)                              # [nfft, 2*bins]
    xr, xi = dft_fn(x, g, nfft, hop, nblk)                     # [bins, B, nblk, D]
    if quant:
        xq_r, xq_i, sc = quantize_block_spectra(xr, xi, bank.w2_scale)
        ycat = binmm_int8_fn(xq_r, xq_i, bank.w2, sc, out_dtype=mm,
                             w2_kmajor=bank.w2_kmajor)
    else:
        ycat = binmm_fn(xr, xi, bank.w2)                       # [(2,) 2, bins, m, K]
    ycat = ycat.reshape(-1, m * k)                             # bf16: hi and lo planes
    imat = _idft_basis(nfft, hop, mm, dev, ycat.shape[0] // (2 * bins))
    scores_t = idft_fn(ycat, imat, bank.c, nblk)
    if bank.num_templates and bank.num_templates != k:
        scores_t = scores_t[..., : bank.num_templates].contiguous()
    if time_major:
        return scores_t if not trim else scores_t[:, :tout]
    return torch.transpose(scores_t[:, :tout], 1, 2)
