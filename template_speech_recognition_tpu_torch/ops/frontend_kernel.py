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

CUDA design (``csrc/frontend_planes.cu``): the DFT on the tensor
cores as a 3-pass TF32 split (hi.lo + lo.hi + hi.hi, the dropped lo.lo
under 2^-22 of a term), ``wgmma`` fed by a TMA ring, one producer warp
and two consumer warpgroups, persistent blocks walking work items of 64
frame rows x 128 DFT columns (63 rows written: row tiles overlap by the
"next" row).  The basis is split once per (frame length, nfft, device)
and cached K-major ``[6, bins, FL4]`` (cos-hi, cos-lo, -sin-hi, -sin-lo,
cos, -sin); the frames are split in registers.  Each k8 step starts a
fresh tensor-core sum that is added round-to-nearest to the running
one, since ``wgmma`` cuts its f32 sums.  The power forms in registers,
the spectrum (in mel mode the power, then the mel sums over each
filter's nonzero bins, fp32 SIMT) stays in shared memory, and only the
planes reach device memory.  Past ``MAX_MELS`` filters (the mel sums'
room in shared memory) the mel mode launches once a chunk of filters
(``mel_chunks``: adjacent chunks share a filter, each writes its plane
columns), recomputing the DFT a chunk; each filter's sum keeps its
order, so the chunked planes are bitwise the one-launch planes.  A frame length that is not a multiple of
4 is padded with zero samples (a TMA row is a multiple of 16 bytes);
otherwise the frames must start on a 16-byte boundary.

What bounds it on the H100: operations.  ``2 * 2 * N * 400 * 257``
flops (10.1 GFLOP at B=8, T_pad=3072) take 0.15 ms at 67 TFLOP/s of
fp32 SIMT and 0.061 ms as three TF32 passes at 495 TFLOP/s; the bytes
(frames in, planes out: 39 + 101 MB, or 39 + 25 MB at F = 63) take
0.04 ms or less.

``planes64`` gives the planes in float64 with a bound on the error of
any fp32 evaluation (with ``split``, of the 3-pass split), and
``planes_metrics`` the errors the kernel and the plain version are held
to on the card: the kernel within 1e-5 (scaled) of the float64 planes
on the well-conditioned cells, both within their error bounds on every
cell.  The plain version's own fp32 GEMM is up to 1.4e-5 (scaled) off
float64 at a few hundred rows, so it is the function's definition, not
the kernel's yardstick of accuracy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.dft import (
    LOG_EPS,
    _mel_np,
    _power,
    dft_matrices,
    log_magnitude_spectrogram,
    log_mel_spectrogram,
    mel_filterbank,
)

NAME = "frontend_planes"
SOURCE = "template_speech_recognition_tpu_torch/csrc/frontend_planes.cu"
REPLACES = "template_speech_recognition_tpu/ops/frontend_pallas.py:251"
# The log-mel mode counts its launches under a name of its own; on the
# log-mel scan it serves the layered frontend's four-output kernel.
MEL_NAME = "frontend_planes_mel"
MEL_REPLACES = "template_speech_recognition_tpu/ops/frontend_pallas.py:209"

# The mel sums [64, n_mels] share the 227 KB of shared memory with a
# ring of at least two 36 KB stages and the [64, 129] spectrum tile
# (``smem_bytes`` in the source): 484 filters a launch at most.  More go
# in chunks (``mel_chunks``).
MAX_MELS = 484


def supported(nfft: int, n_mels: int = 0) -> bool:
    """Shapes the CUDA kernel takes: any DFT width, and 0 or any n_mels
    >= 2 mel filters (past ``MAX_MELS`` in chunks, a launch each)."""
    return nfft // 2 >= 1 and (n_mels == 0 or n_mels >= 2)


def mel_chunks(n_mels: int) -> list[tuple[int, int]]:
    """The launches of the mel mode: filter ranges [c0, c1], each of at
    most ``MAX_MELS`` filters, adjacent ranges sharing one filter.  The
    differences at plane column f read filters f and f + 1, so range
    [c0, c1] gives plane columns [c0, c1 - 1], and the ranges together
    give columns [0, n_mels - 1) once each.  One range up to MAX_MELS."""
    f = n_mels - 1
    return [(c0, min(c0 + MAX_MELS - 1, f)) for c0 in range(0, f, MAX_MELS - 1)]


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo), both TF32 values held in f32 (the low 13
    mantissa bits zero): ``hi`` is ``x`` rounded to nearest TF32, ties
    away from zero, and ``lo`` is ``x - hi`` rounded the same way, as
    ``cvt.rna.tf32.f32`` does (the kernel's operands), so |x - hi -
    lo| <= 2^-22 |x|."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # adding half of the dropped range to the magnitude bits rounds
        # half away from zero; the mask keeps sign, exponent and 10 bits
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _differences(spec: torch.Tensor, f: int) -> torch.Tensor:
    """The four planes of a spectrogram [N, >= f + 1] against the next
    row (row N - 1's next is itself): [4, N, f]."""
    cur = spec
    nxt = torch.cat([spec[1:], spec[-1:]])
    return torch.stack([
        nxt[:, :f] - cur[:, :f],                # d_time
        cur[:, 1 : f + 1] - cur[:, :f],         # d_freq
        nxt[:, 1 : f + 1] - cur[:, :f],         # d_diag
        nxt[:, :f] - cur[:, 1 : f + 1],         # d_anti
    ])


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
        return _differences(log_mel_spectrogram(frames, nfft, sample_rate, n_mels), n_mels - 1)
    return _differences(log_magnitude_spectrogram(frames, nfft), nfft // 2)


def mel_planes_chunked_plain(frames, nfft: int, sample_rate: int, n_mels: int):
    """The mel mode's launches past ``MAX_MELS`` in plain PyTorch, for
    the CPU tests: each chunk [c0, c1] of ``mel_chunks`` computes the
    log-mel of its own filters (the filterbank's columns c0..c1) and
    writes its difference columns [c0, c1) of [4, N, n_mels - 1]."""
    frames = frames.to(torch.float32)
    fb = mel_filterbank(sample_rate, nfft, n_mels, frames.device)
    power = _power(frames, nfft)
    out = frames.new_empty((4, frames.shape[0], n_mels - 1))
    for c0, c1 in mel_chunks(n_mels):
        spec = torch.log(power @ fb[:, c0 : c1 + 1] + float(LOG_EPS))
        out[:, :, c0:c1] = _differences(spec, c1 - c0)
    return out


def planes64(frames, nfft, sample_rate=0, n_mels=0, split=False):
    """The planes in float64, and for every cell a bound on the error of
    an fp32 evaluation in any summation order: (ref, bound), each [4, N,
    F].  Each DFT sum of n terms is off by at most n * u * sum|terms| (u
    = 2^-24), which carries through the power, the mel sum, the log and
    the difference (plus one rounding each, and 4 ulps for logf).
    ``split`` adds the 3-pass TF32 split's own error to each DFT sum,
    3 * 2^-22 * sum|terms| (``split_tf32``: three TF32 products a
    term)."""
    u, eps = 2.0 ** -24, float(LOG_EPS)
    n = frames.shape[1]
    cos_m, sin_m = (m.double() for m in dft_matrices(n, nfft, frames.device))
    x = frames.double()
    re, im = x @ cos_m, x @ sin_m
    per_term = n * u + (3 * 2.0 ** -22 if split else 0.0)
    dre, dim = per_term * (x.abs() @ cos_m.abs()), per_term * (x.abs() @ sin_m.abs())
    p = re * re + im * im
    dp = 2 * re.abs() * dre + 2 * im.abs() * dim + dre ** 2 + dim ** 2 + 3 * u * p
    half = 1.0
    if n_mels:
        fb = mel_filterbank(sample_rate, nfft, n_mels, frames.device).double()
        dp = dp @ fb + fb.shape[0] * u * (p @ fb)
        p = p @ fb
        f = n_mels - 1
    else:
        half = 0.5
        f = nfft // 2
    rel = (dp + u * (p + eps)) / (p + eps)
    ds = torch.where(rel < 0.5, -torch.log1p(-rel.clamp(max=0.5)), torch.full_like(rel, 1e3))
    spec = half * torch.log(p + eps)
    ds = half * ds + 4 * u * spec.abs()
    ref = _differences(spec, f)
    dnx = torch.cat([ds[1:], ds[-1:]])
    bound = torch.stack([dnx[:, :f] + ds[:, :f], ds[:, 1 : f + 1] + ds[:, :f],
                         dnx[:, 1 : f + 1] + ds[:, :f], dnx[:, :f] + ds[:, 1 : f + 1]])
    return ref, bound + u * ref.abs()


def planes_metrics(frames, nfft, got, want, sample_rate=0, n_mels=0, split=False):
    """Planes ``got`` (the kernel's, or any fp32 evaluation) against the
    plain version's ``want`` and the float64 planes of ``planes64``, as
    a dict.  ``scaled64`` and ``plain_scaled64``: max |error against
    float64| / max |want| of ``got`` and of ``want`` on the
    well-conditioned cells, those whose four spectrum inputs have a
    power (log-mel: a mel energy) >= 1e-2, four decades above LOG_EPS
    (``share`` of the cells); ``scaled``: the same of ``got`` against
    ``want``; ``err``: max |got - want| on all cells; ``head`` and
    ``plain_head``: the largest |error against float64| / the fp32
    error bound, on all cells (``split``: ``got``'s bound has the term
    of the 3-pass TF32 split)."""
    f = n_mels - 1 if n_mels else nfft // 2
    cos_m, sin_m = dft_matrices(frames.shape[1], nfft, frames.device)
    x64 = frames.double()
    power = (x64 @ cos_m.double()) ** 2 + (x64 @ sin_m.double()) ** 2
    if n_mels:
        power = power @ mel_filterbank(sample_rate, nfft, n_mels, frames.device).double()
    okp = power >= 1e-2
    okn = torch.cat([okp[1:], okp[-1:]])
    ok = okp[:, :f] & okp[:, 1 : f + 1] & okn[:, :f] & okn[:, 1 : f + 1]
    ref, bound = planes64(frames, nfft, sample_rate, n_mels)
    bound_k = planes64(frames, nfft, sample_rate, n_mels, split=True)[1] if split else bound
    top = want.abs().max()
    got64, want64 = got.double(), want.double()

    def scaled(a, b):
        return float((a - b).abs()[:, ok].max() / top) if bool(ok.any()) else 0.0

    return dict(
        scaled=scaled(got64, want64), err=float((got - want).abs().max()),
        share=float(ok.double().mean()), scaled64=scaled(got64, ref),
        plain_scaled64=scaled(want64, ref),
        head=float(((got64 - ref).abs() / bound_k).max()),
        plain_head=float(((want64 - ref).abs() / bound).max()),
    )


@functools.lru_cache(maxsize=8)
def _basis_on(frame_length: int, nfft: int, device: str) -> torch.Tensor:
    """The kernel's DFT basis, K-major [6, bins, FL4] f32 (FL4 = the
    frame length rounded up to 4, zero columns past it): cos-hi, cos-lo,
    -sin-hi, -sin-lo (``split_tf32``), cos, -sin."""
    cos_m, sin_m = dft_matrices(frame_length, nfft, device)
    fl4 = -(-frame_length // 4) * 4
    ct = torch.nn.functional.pad(cos_m.t(), (0, fl4 - frame_length))
    st = torch.nn.functional.pad(sin_m.t(), (0, fl4 - frame_length))
    return torch.stack([*split_tf32(ct), *split_tf32(st), ct, st]).contiguous()


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
            f"nfft={nfft}, n_mels={n_mels}: the kernel takes nfft >= 2 and n_mels 0 or >= 2"
        )
    n, fl = frames.shape
    dev = str(frames.device)
    basis = _basis_on(fl, nfft, dev)
    fl4 = basis.shape[2]
    if fl4 != fl:
        frames = torch.nn.functional.pad(frames, (0, fl4 - fl))
    elif frames.data_ptr() % 16:
        raise ValueError("frames must start on a 16-byte boundary (TMA)")
    fbt = mrange = None
    f = nfft // 2
    if n_mels:
        fbt, mrange = _mel_on(sample_rate, nfft, n_mels, dev)
        f = n_mels - 1
    out = torch.empty((4, n, f), dtype=torch.float32, device=frames.device)
    lib = _cuda.load("frontend_planes")
    fn = _cuda.declare(lib, "tsr_frontend_planes", 5, 6)
    # one launch, or (past MAX_MELS filters) one a chunk of filters, each
    # writing its plane columns of ``out``; the split basis is cached once
    for c0, c1 in mel_chunks(n_mels) if n_mels else [(0, 0)]:
        err = fn(
            _cuda.ptr(frames), _cuda.ptr(basis),
            _cuda.ptr(fbt[c0:] if n_mels else None), _cuda.ptr(mrange[c0:] if n_mels else None),
            _cuda.ptr(out), n, fl4, nfft // 2, c1 - c0 + 1 if n_mels else 0, f, c0,
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
