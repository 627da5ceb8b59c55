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
nfft rounded up to 16, BP = bins rounded up to 16 where xr's and xi's
columns share one pass, else to a multiple of the pass width; exact
zeros in the padding).  Each consumer warpgroup multiplies the 64 d
columns of one window, read by TMA through a 3-D map over [B, T, D]
whose zero fill past T completes the tail windows of each utterance,
by the N basis columns of its block's pass: all 2 BP in one pass where
they fit, else passes of N <= 256 columns that each hold part of xr's
bins or part of xi's, each a block of its own.  Where Kp <= 512 and one
pass, or one pass a half (xr's, then xi's), fits shared memory beside
a ring of whole windows, the pass's basis stays resident for the whole
block and a window arrives in one box of Kp rows or two of Kp / 2;
else the basis streams along tau with the window: each ring stage
holds a chunk of ``kc`` = 128 rows of x and of the basis, a pass holds
at most 128 columns, and the products of a window's chunks accumulate
in registers.  A block walks a run of consecutive
windows of one (b, 64 or 128 d) tile; ``plan`` picks the pass width,
the tile width, the ring depth and the run length that fill the card.
The epilogue writes each window's tile transposed into shared memory
and stores it by TMA.  TMA takes rows of 16 bytes from a 16-byte aligned
base: any other D or base runs on a zero-padded copy of D8 columns
(``_cuda.aligned_rows``; the wrapper returns views of the first D).  ``fft_block_dft_tiled`` walks the same schedule
in PyTorch, for the tests.

What bounds it on the H100: bytes at the scan's shape, operations at
long templates.  The map in once and the spectra out once (101 + 126 MB
at B=8, T_pad=3072, D=2048, bins=80, nblk=24) take 0.068 ms; the 20
GFLOP of bf16 take 0.02 ms at 989 TFLOP/s.  At L 80 (nfft 399, hop 320,
bins 200, nblk 10): 101 + 131 MB, 0.069 ms; 52 GFLOP, 0.053 ms.  At L 256
and K >= 4096 (nfft 1791, hop 1536, bins 896, nblk 2): 101 + 59 MB,
0.048 ms; 210 GFLOP, 0.21 ms: compute-bound.
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
# x ring stages, wgmma N, TMA box rows; d columns of a consumer warpgroup;
# tau rows a ring stage holds where the basis streams
SMEM_LIMIT, MAX_STAGES, MAX_N, MAX_BOX = 232448, 4, 256, 256
TILE_D = 64
STREAM_KC, STREAM_N = 128, 128
H100_SMS = 132
_BARS = 8 * (2 * MAX_STAGES + 1)


class Plan(NamedTuple):
    """How the kernel cuts one call: the padded depth ``kp`` and rows a
    TMA box of x ``kb``; the padded bins of a half ``bp``; the basis
    columns a pass ``n``; ``passes`` (1: xr's and xi's columns together,
    n = 2 bp; else 2 bp / n, each a slice of xr's bins or of xi's); the
    consumer warpgroups a block ``wgs`` (64 d columns each); ring
    ``stages``; windows a block ``run``; dynamic shared memory; the tau
    rows a ring stage holds ``kc`` (= kp where the pass's basis stays
    resident; a chunk of x and basis rows where it streams)."""

    kp: int
    kb: int
    bp: int
    n: int
    passes: int
    wgs: int
    stages: int
    run: int
    smem: int
    kc: int

    @property
    def streamed(self) -> bool:
        return self.kc < self.kp


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def _resident_passes(bins: int):
    """(bp, n, passes) of the resident plans in the order ``plan`` tries
    them: xr's and xi's columns in one pass where 2 bp <= 256, then one
    pass a half of n = bins rounded up to 32 columns where n <= 256."""
    bp16, bp32 = _ceil(bins, 16), _ceil(bins, 32)
    if 2 * bp16 <= MAX_N:
        yield bp16, 2 * bp16, 1
    if bp32 <= MAX_N:
        yield bp32, bp32, 2


def _stages(fixed: int, stage: int) -> int:
    return min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)


def plan(b: int, d: int, nfft: int, nblk: int, bins: int, sms: int = H100_SMS,
         wgs: int | None = None, run: int | None = None, stream: bool = False) -> Plan:
    """The kernel's plan for one call; raises ``ValueError`` only on
    arguments that are not a block DFT (nfft < 2, bins not nfft // 2 +
    1, an empty call).  The basis resident in shared memory where Kp <=
    512 (a window in one box, or two of Kp / 2 rows) and one pass, or
    one pass a half, fits: one pass before two, two warpgroups (128 d a
    block) before one, as many ring stages (<= 4) as fit, at least 2.
    Else the basis streams in chunks of ``STREAM_KC`` rows with the
    window, in passes of at most ``STREAM_N`` columns (on the H100 that
    beat resident plans of 6 and 10 narrower passes at nfft 399, 447 and
    518: ``probe_fft_block_dft.py``).  Runs of
    windows short enough that the blocks fill ``sms`` SMs.  ``wgs``,
    ``run`` and ``stream`` (the streamed basis wherever Kp > ``STREAM_KC``)
    force those choices (the probe's variants)."""
    if nfft < 2 or bins != nfft // 2 + 1:
        raise ValueError(f"nfft {nfft}, bins {bins}: a block DFT of nfft >= 2 has "
                         f"nfft // 2 + 1 bins")
    if b < 1 or d < 1 or nblk < 1:
        raise ValueError(f"B {b}, D {d}, nblk {nblk}: an empty call")
    kp = _ceil(nfft, 16)
    kb = kp if kp <= MAX_BOX else kp // 2
    widths = (wgs,) if wgs else ((2, 1) if d > TILE_D else (1,))
    chosen = None
    resident = kp <= 2 * MAX_BOX and not (stream and kp > STREAM_KC)
    for bp, n, passes in _resident_passes(bins) if resident else ():
        slabs = -(-kp // 64)
        for w in widths:
            fixed = 1024 + slabs * n * 128 + 2 * w * n * 128 + _BARS
            stages = _stages(fixed, w * kp * 128)
            if stages >= 2:
                chosen = (kp, kb, bp, n, passes, w, stages, fixed + stages * w * kp * 128, kp)
                break
        if chosen:
            break
    if chosen is None:
        # the basis streams: a pass of STREAM_N columns or fewer
        h = -(-bins // STREAM_N)
        n = _ceil(-(-bins // h), 32)
        for w in widths:
            fixed = 1024 + 2 * w * n * 128 + _BARS
            stage = w * STREAM_KC * 128 + STREAM_KC // 64 * n * 128
            stages = _stages(fixed, stage)
            if stages >= 2:
                chosen = (kp, STREAM_KC, h * n, n, 2 * h, w, stages,
                          fixed + stages * stage, STREAM_KC)
                break
    kp, kb, bp, n, passes, w, stages, smem, kc = chosen
    if run is None:
        pairs = b * -(-d // (TILE_D * w)) * passes
        run = -(-nblk // max(1, min(nblk, sms // max(pairs, 1))))
    return Plan(kp, kb, bp, n, passes, w, stages, run, smem, kc)


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
    them; each window of a run, per warpgroup, is read in chunks of
    ``kc`` rows (one chunk of Kp rows where the basis is resident), each
    chunk in boxes of ``kb`` rows, rows i*hop + r of this utterance with
    zeros past T and columns past D (TMA's zero fill), times the pass's
    columns of ``padded_basis`` over the chunk's rows before Kp; the
    chunks' products summed in order into the [64, N] tile.  The tile
    goes to its staging rows and from there to xr (rows [0, BP)) and xi
    (rows [BP, 2 BP)) where one pass holds both, else to the pass's
    slice of xr's or xi's bins; bins past ``bins`` and d past D clipped.
    Unwritten outputs stay NaN."""
    b, t, d = x.shape
    _check_extent(t, nfft, hop, nblk)
    bins = g.shape[1] // 2
    p = plan(b, d, nfft, nblk, bins, sms, wgs, run)
    gt = padded_basis(g.to(torch.float32), nfft, p.bp, p.kp)
    xf = x.to(torch.float32)
    xr = torch.full((bins, b, nblk, d), float("nan"))
    xi = torch.full_like(xr, float("nan"))
    n_dt, n_runs = -(-d // (TILE_D * p.wgs)), -(-nblk // p.run)
    per_half = max(1, p.passes // 2)
    for blk in range(b * n_dt * n_runs * p.passes):
        pas, rest = blk % p.passes, blk // p.passes
        ri, rest = rest % n_runs, rest // n_runs
        dt, bi = rest % n_dt, rest // n_dt
        basis = gt[pas * p.n : (pas + 1) * p.n]                      # [N, Kp]
        for i in range(ri * p.run, min(nblk, (ri + 1) * p.run)):
            for c in range(p.wgs):
                dw = (dt * p.wgs + c) * TILE_D
                acc = torch.zeros((TILE_D, p.n))
                for k0 in range(0, p.kp, p.kc):
                    win = torch.zeros((p.kc, TILE_D))
                    for r in range(0, p.kc, p.kb):
                        lo = i * hop + k0 + r
                        box = xf[bi, lo : min(t, lo + p.kb), dw : dw + TILE_D]
                        win[r : r + box.shape[0], : box.shape[1]] = box
                    nk = min(p.kc, p.kp - k0)
                    acc += win[:nk].t() @ basis[:, k0 : k0 + nk].t()
                stage = acc.t().to(x.dtype)                          # [N, 64]
                wd = min(TILE_D, d - dw)
                if wd <= 0:
                    continue
                if p.passes == 1:
                    dests = ((xr, 0, 0, bins), (xi, p.bp, 0, bins))
                else:
                    half, q = divmod(pas, per_half)
                    f0 = q * p.n
                    dests = (((xr, xi)[half], 0, f0, min(bins, f0 + p.n)),)
                for out, r0, f0, f1 in dests:
                    if f1 > f0:
                        out[f0:f1, bi, i, dw : dw + wd] = stage[r0 : r0 + f1 - f0, :wd]
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
    (bf16 only) or raise on arguments that are not a block DFT.  Where
    D % 8 != 0 or x's base is not 16-byte aligned, the kernel runs on x
    zero-padded to D8 = ceil(D/8)*8 columns, and xr, xi are views of its
    [bins, B, nblk, D8] outputs (the padded columns are zeros);
    ``detect.fft_scorer`` pads the map once itself, so the scan gets
    whole outputs."""
    if _cuda.on_cpu(x, g):
        return fft_block_dft_plain(x, g, nfft, hop, nblk)
    _cuda.require(x, "x", torch.bfloat16, 3)
    _cuda.require(g, "g", torch.bfloat16, 2)
    b, t, d_in = x.shape
    _check_extent(t, nfft, hop, nblk)
    if g.shape[0] != nfft or g.shape[1] % 2 or b == 0:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, g {tuple(g.shape)}, nfft {nfft}: "
                         f"B > 0, g [nfft, 2 bins]")
    # TMA's 16-byte rows: D8 columns from an aligned base, zero-padded
    # in a fresh buffer where D % 8 != 0 or the base is off
    x = _cuda.aligned_rows(x)
    d = x.shape[2]
    bins = g.shape[1] // 2
    p = plan(b, d, nfft, nblk, bins, _sm_count(str(x.device)))
    gt = _basis_for(g, nfft, p)
    xr = torch.empty((bins, b, nblk, d), dtype=torch.bfloat16, device=x.device)
    xi = torch.empty_like(xr)
    lib = _cuda.load("fft_block_dft")
    fn = _cuda.declare(lib, "tsr_fft_block_dft", 4, 15)
    err = fn(
        _cuda.ptr(x), _cuda.ptr(gt), _cuda.ptr(xr), _cuda.ptr(xi),
        b, t, d, hop, nblk, bins, p.kp, p.kb, p.bp, p.n, p.passes, p.wgs, p.stages, p.run,
        p.kc, _cuda.stream_ptr(x.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    if d != d_in:
        return xr[..., :d_in], xi[..., :d_in]
    return xr, xi
