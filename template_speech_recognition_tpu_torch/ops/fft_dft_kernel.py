"""Kernel 3: overlap-save blocking + forward DFT of the feature map.

Replaces ``template_speech_recognition_tpu/ops/fft_dft_pallas.py``
``fft_block_dft_pallas`` (``_kernel``; its ``pallas_call`` at line 104).

``out[f, b, i, d] = sum_{tau < nfft} g[tau, f] * x[b, i*hop + tau, d]``
with ``x`` read as zero past its T rows; ``f < bins`` goes to ``xr``
and the rest to ``xi``, both ``[bins, B, nblk, D]``.  fp32
accumulation, output in the input dtype (bf16 on the card).

CUDA design (``csrc/fft_block_dft.cu``): TMA + ``wgmma`` with M = d,
N = basis columns, K = tau.  The wrapper hands the kernel the basis
transposed and padded, ``gt`` [2 BP, Kp] K-major (``padded_basis``: Kp =
nfft rounded up to 16, BP = bins rounded up to 16, or to 32 when 2 BP >
256; exact zeros in the padding), which stays in shared memory for the
whole block.  Each consumer warpgroup multiplies the 64 d columns of one
window, read by TMA through a 3-D map over [B, T, D] whose zero fill
past T completes the tail windows of each utterance, by the N = 2 BP
resident basis columns; past N = 256 the basis is split into two passes
(xr's columns, xi's), each a block of its own.  A block walks a run of
consecutive windows of one (b, 64 or 128 d) tile; ``plan`` picks the
tile width, the ring depth and the run length that fill the card.  The
epilogue writes each window's tile transposed into shared memory and
stores it by TMA.  ``fft_block_dft_tiled`` walks the same schedule in
PyTorch, for the tests.

What bounds it on the H100: bytes.  The map in once and the spectra
out once (101 + 126 MB at B=8, T_pad=3072, D=2048, bins=80, nblk=24)
take 0.068 ms; the 20 GFLOP of bf16 take 0.02 ms at 989 TFLOP/s.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "fft_block_dft"
SOURCE = "template_speech_recognition_tpu_torch/csrc/fft_block_dft.cu"
REPLACES = "template_speech_recognition_tpu/ops/fft_dft_pallas.py:104"
# the kernel's limits (csrc/fft_block_dft.cu): shared memory a block,
# x ring stages, wgmma N, TMA box rows; d columns of a consumer warpgroup
SMEM_LIMIT, MAX_STAGES, MAX_N, MAX_BOX = 232448, 4, 256, 256
TILE_D = 64
H100_SMS = 132


class Plan(NamedTuple):
    """How the kernel cuts one call: the padded depth ``kp`` and rows a
    TMA box ``kb``; the padded bins of a half ``bp``; the basis columns
    a block holds ``n`` (``2 bp``, or ``bp`` with ``passes`` = 2); the
    consumer warpgroups a block ``wgs`` (64 d columns each); x ring
    ``stages``; windows a block ``run``; dynamic shared memory."""

    kp: int
    kb: int
    bp: int
    n: int
    passes: int
    wgs: int
    stages: int
    run: int
    smem: int


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def plan(b: int, d: int, nfft: int, nblk: int, bins: int, sms: int = H100_SMS,
         wgs: int | None = None, run: int | None = None) -> Plan:
    """The kernel's plan for one call; raises ``ValueError`` on a shape
    it cannot take.  Two warpgroups (128 d a block) and one pass where
    shared memory allows, else one warpgroup, else two passes; as many
    ring stages (<= 4) as fit; runs of windows short enough that the
    blocks fill ``sms`` SMs.  ``wgs`` and ``run`` force those choices
    (the probe's variants)."""
    kp = _ceil(nfft, 16)
    if kp > 2 * MAX_BOX:
        raise ValueError(f"nfft {nfft}: the kernel takes nfft <= {2 * MAX_BOX}")
    kb = kp if kp <= MAX_BOX else kp // 2
    if 2 * _ceil(bins, 16) <= MAX_N:
        bp, passes = _ceil(bins, 16), 1
        n = 2 * bp
    else:
        bp, passes = _ceil(bins, 32), 2
        n = bp
    if bp > MAX_N:
        raise ValueError(f"bins {bins}: the kernel takes at most {MAX_N} bins")
    slabs = -(-kp // 64)
    for w in (wgs,) if wgs else ((2, 1) if d > TILE_D else (1,)):
        fixed = 1024 + slabs * n * 128 + 2 * w * n * 128 + 8 * (2 * MAX_STAGES + 1)
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (w * kp * 128))
        if stages >= 2:
            break
    else:
        raise ValueError(f"nfft {nfft}, bins {bins}: no plan fits {SMEM_LIMIT} bytes of "
                         f"shared memory")
    if run is None:
        pairs = b * -(-d // (TILE_D * w)) * passes
        run = -(-nblk // max(1, min(nblk, sms // max(pairs, 1))))
    smem = fixed + stages * w * kp * 128
    return Plan(kp, kb, bp, n, passes, w, stages, run, smem)


def padded_basis(g: torch.Tensor, nfft: int, bp: int, kp: int) -> torch.Tensor:
    """g [nfft, 2 bins] -> gt [2 bp, kp] in g's dtype: xr's columns
    transposed into rows [0, bins), xi's into [bp, bp + bins), exact
    zeros elsewhere (the kernel's K-major basis)."""
    bins = g.shape[1] // 2
    gt = g.new_zeros((2 * bp, kp))
    gt[:bins, :nfft] = g[:, :bins].t()
    gt[bp : bp + bins, :nfft] = g[:, bins:].t()
    return gt


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


def fft_block_dft_tiled(x, g, nfft: int, hop: int, nblk: int, sms: int = H100_SMS,
                        wgs: int | None = None, run: int | None = None):
    """The kernel's schedule in plain PyTorch (float32 sums), for the
    tests.  Blocks (b, d tile, run of windows, pass) as ``plan`` cuts
    them; each window of a run is one [Kp, 64] box per warpgroup, rows
    i*hop .. i*hop + Kp - 1 of this utterance with zeros past T and
    columns past D (TMA's zero fill), times the pass's resident columns
    of ``padded_basis``; the [64, N] tile goes to its staging rows and
    from there to xr (rows [0, BP)) and xi (rows [BP, 2 BP)), bins past
    ``bins`` and d past D clipped.  Unwritten outputs stay NaN."""
    b, t, d = x.shape
    _check_extent(t, nfft, hop, nblk)
    bins = g.shape[1] // 2
    p = plan(b, d, nfft, nblk, bins, sms, wgs, run)
    gt = padded_basis(g.to(torch.float32), nfft, p.bp, p.kp)
    xf = x.to(torch.float32)
    xr = torch.full((bins, b, nblk, d), float("nan"))
    xi = torch.full_like(xr, float("nan"))
    n_dt, n_runs = -(-d // (TILE_D * p.wgs)), -(-nblk // p.run)
    for blk in range(b * n_dt * n_runs * p.passes):
        pas, rest = blk % p.passes, blk // p.passes
        ri, rest = rest % n_runs, rest // n_runs
        dt, bi = rest % n_dt, rest // n_dt
        basis = gt[pas * p.n : (pas + 1) * p.n]                      # [N, Kp]
        for i in range(ri * p.run, min(nblk, (ri + 1) * p.run)):
            for c in range(p.wgs):
                dw = (dt * p.wgs + c) * TILE_D
                win = torch.zeros((p.kp, TILE_D))
                for r in range(0, p.kp, p.kb):
                    box = xf[bi, i * hop + r : min(t, i * hop + r + p.kb), dw : dw + TILE_D]
                    win[r : r + box.shape[0], : box.shape[1]] = box
                stage = (win.t() @ basis.t()).t().to(x.dtype)        # [N, 64]
                wd = min(TILE_D, d - dw)
                if wd <= 0:
                    continue
                dests = ((xr, 0), (xi, p.bp)) if p.passes == 1 else (((xr, xi)[pas], 0),)
                for out, r0 in dests:
                    out[:, bi, i, dw : dw + wd] = stage[r0 : r0 + bins, :wd]
    return xr.to(x.dtype), xi.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the last padded basis and the basis tensor it was made from (the same
# object at the same version counter means the same values)
_BASIS: list = [None]


def _basis_for(g: torch.Tensor, nfft: int, p: Plan) -> torch.Tensor:
    hit = _BASIS[0]
    key = (g._version, nfft, p.bp, p.kp)
    if hit is not None and hit[0]() is g and hit[1] == key:
        return hit[2]
    gt = padded_basis(g, nfft, p.bp, p.kp)
    _BASIS[0] = (weakref.ref(g), key, gt)
    return gt


def fft_block_dft(x, g, nfft: int, hop: int, nblk: int):
    """x [B, T, D] x g [nfft, 2*bins] -> xr, xi [bins, B, nblk, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 only) or raise on a shape it cannot take."""
    if _cuda.on_cpu(x, g):
        return fft_block_dft_plain(x, g, nfft, hop, nblk)
    _cuda.require(x, "x", torch.bfloat16, 3)
    _cuda.require(g, "g", torch.bfloat16, 2)
    b, t, d = x.shape
    _check_extent(t, nfft, hop, nblk)
    if g.shape[0] != nfft or g.shape[1] % 2 or d % 8 or b == 0 or x.data_ptr() % 16:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, g {tuple(g.shape)}, nfft {nfft}: "
                         f"D a multiple of 8, B > 0, a 16-byte aligned base")
    bins = g.shape[1] // 2
    p = plan(b, d, nfft, nblk, bins, _sm_count(str(x.device)))
    gt = _basis_for(g, nfft, p)
    xr = torch.empty((bins, b, nblk, d), dtype=torch.bfloat16, device=x.device)
    xi = torch.empty_like(xr)
    lib = _cuda.load("fft_block_dft")
    fn = _cuda.declare(lib, "tsr_fft_block_dft", 4, 14)
    err = fn(
        _cuda.ptr(x), _cuda.ptr(gt), _cuda.ptr(xr), _cuda.ptr(xi),
        b, t, d, hop, nblk, bins, p.kp, p.kb, p.bp, p.n, p.passes, p.wgs, p.stages, p.run,
        _cuda.stream_ptr(x.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return xr, xi
