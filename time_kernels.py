"""Times kernel 1 (log-magnitude and mel mode), kernel 2 (select +
binarize + spread), kernel 3 (the block DFT), kernel 4 (the bf16 bin
matmul), kernel 5 (the iDFT),
kernel 6 (the int8 bin matmul), kernel 9 (binarize + spread), kernel 10
(the direct correlation), kernel 11 (the pair-LLR tiles), kernels 12
and 13 (the banded DTW) with the DTW stage around them, and the
layered frontend's whole radix select (kernel 8 and what surrounds it)
of the port in one or more checkouts, at the streaming scan's bench shape, by one method:
``chip_smoke.time_ms`` over loops of 100 launches (device time; kernel
10, milliseconds a launch, over loops of 10) and over one launch (the
wrapper's host time included).  Kernel 2 takes random normal planes [4,
8, 3072, 256] with 2998 valid frames (30 s), q 0.98, rf = rt = 1.
Kernel 3 takes random binary bf16 maps [8, 3072, D] at 0.15 density
and the scorer's DFT basis at nfft 159 (hop 128, 24 windows), at D =
2048 and at the log-mel D = 504.  Kernel 4 takes random normal bf16
spectra and W2 at the scan's shape (bins 80, m 192, K 1024) at D = 2048
and 504 (``fft_binmm``, ``fft_binmm_d504``) and writes the planes its
scan takes (hi and lo, or in an older checkout one).  Kernel 5 takes a
random bf16 ``ycat`` and basis of 160 rows (2 x 80 bins) for each of
those planes (``binmm_planes`` in the output), hop 128, m 192, K 1024.
Kernel 6 takes uniform int8 spectra at the scan's shape (bins 80, m 192,
K 1024) at D = 2048 and at the log-mel D = 504: a checkout whose int8
bin matmul reads the bank's K-major copy gets it and rows padded to 16
bytes, as its scan passes them; an older one gets the contiguous
operands its scan passed.  Kernel 10 takes the reference's bench shape
(B 8, T 3000, K 1024, L 32, D 2048) and one utterance of it (B 1):
random binary bf16 maps at 0.2 density, a random bf16 bank.  The
layered select is ``plane_order_statistics`` as the log-mel scan calls
it: a [B, P] view of random normal plane-major planes [4, 8, 3072, 63],
2997 valid frames (30 s), q 0.98; a checkout with the 11-launch select
makes its keys, 11 counting launches and the digit picks on the host's
enqueue (over loops of 100, its time is then the host's where that is
longer than the device's), one with ``radix_select`` one call.  Kernel
9 takes those planes and the select's statistics, rf = 1: the kernel
at rt = 0 (``binspread``), and the layered frontend's whole call
``binarize_spread_flat`` at rt = 1 (``binarize_spread_flat``: a
checkout whose kernel does not take the time spread runs it at rt = 0
and then its time dilation, row mask and cast to bool).  Kernel 11
takes the verify-the-winner rescore's pairs at the smoke test's shape
(8 x 123 windows of 40 frames at random starts below 2998 in maps of
8 x 3072 frames at 0.15 density, random ids of 1024 random bf16
filters of L = 32) at D = 2048 and 504 (``pair_llr``,
``pair_llr_d504``), through the wrapper.  Kernels 12 and 13 take the
same pairs' random LLR tiles [984, 32, 40] (seg_len = min(2998 - t,
38)) and [984, 96, 104] (seg_len in [51, 102]), band 6, with c rows of
1024 templates and the winner ids: ``banded_dtw`` and
``banded_dtw_l96`` time the kernel on the cost tile -(llr + c) (terminals,
the entry both checkouts have); ``dtw_stage`` and ``dtw_stage_l96`` the
stage from LLR tile to scores as the checkout's map route runs it (one
launch of ``banded_dtw_scores``, or the cost prologue, the kernel and the
score's elementwise ops), and ``dtw_stage_exhaustive`` one chunk of the
exhaustive rescore (53 segments of 38 frames x 1024 templates: the
fp32 GEMM's [53, 38, 1024, 32] output, 264 MB, read in place, or
permuted, offset, negated and copied first), over loops of 10;
``dtw_stage_classify`` the same stage at classification's shape (4031
segments of 15 frames x 8 templates of L 8, seg_len in [8, 15], the
GEMM's [4031, 15, 8, 8] output read through its strides: the ring
route), over loops of 100.
Inputs come from seed 0.

    python3 time_kernels.py ROOT [ROOT ...]

Each ROOT is the root of a checkout: its package is imported from
there, in a process of its own, and builds its kernels into its own
``_build/``.  Give two commits as A B B A to compare them on one card.
Prints the card's name and power limit, then one JSON line a ROOT.
Needs a CUDA device."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from chip_smoke import card_line, time_ms

N_ROWS, FL, NFFT, SR, N_MELS = 8 * 3072, 400, 512, 16000, 64   # B 8 x T_pad 3072 frames
TWO_BINS, HOP, NBLK, B, K = 160, 128, 24, 8, 1024              # nfft 159, L 32
T_PAD, F, VALID, QUANTILE = 3072, 256, 2998, 0.98              # kernel 2
T_CORR, L_CORR, D_CORR, DENSITY = 3000, 32, 2048, 0.2         # kernel 10
BINS, NFFT_S = 80, 159                                         # kernels 3, 6: m = B x NBLK
F_MEL, VALID_MEL = 63, 2997                                    # the layered select, k9
TOP_K, M_LLR, VALID_LLR, DENSITY_LLR = 123, 40, 2998, 0.15     # kernel 11
BAND_DTW, NB_EX, M_EX = 6, 53, 38                              # kernels 12, 13
NB_CL, M_CL, K_CL, L_CL = 4031, 15, 8, 8                       # classification's DTW


def dtw_stage(torch, k12, llr, lens, c_rows, ids):
    """The map route's stage from LLR tile to scores in the checkout:
    one fused launch, or the cost prologue, the kernel on the cost tile
    and the score's elementwise ops."""
    if hasattr(k12, "banded_dtw_scores"):
        return lambda: k12.banded_dtw_scores(llr, lens, c_rows, BAND_DTW, ids)

    def stage():
        total = k12.banded_dtw(-(llr + c_rows[ids.long()][:, :, None]), lens, BAND_DTW)
        scores = -total / (llr.shape[1] + lens).to(torch.float32)
        return torch.where(total > 1e37, float("-inf"), scores)
    return stage


def exhaustive_stage(torch, k12, gemm, lens, c_rows):
    """One chunk of the exhaustive rescore from the GEMM's [nb, M, K, L]
    output to the scores [nb, K], as the checkout runs it."""
    nb, m, k, length = gemm.shape
    view = gemm.permute(0, 2, 3, 1)
    if hasattr(k12, "banded_dtw_scores"):
        return lambda: k12.banded_dtw_scores(view, lens, c_rows, BAND_DTW)

    def stage():
        cost = -(view + c_rows[None, :, :, None])
        total = k12.banded_dtw(cost.reshape(nb * k, length, m).contiguous(),
                               lens.repeat_interleave(k), BAND_DTW).reshape(nb, k)
        scores = -total / (length + lens[:, None]).to(torch.float32)
        return torch.where(total > 1e37, float("-inf"), scores)
    return stage


def one(root: str) -> dict:
    """The times of ``root``'s kernels (run in a process of its own)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from template_speech_recognition_tpu_torch.detect.fft_scorer import _dft_mats
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.frontend.planes import _dual_ranks
    from template_speech_recognition_tpu_torch.ops import correlation_kernel as k10
    from template_speech_recognition_tpu_torch.ops import fft_binmm_kernel as k6
    from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3
    from template_speech_recognition_tpu_torch.ops import fft_idft_kernel as k5
    from template_speech_recognition_tpu_torch.ops import frontend_kernel as k1
    from template_speech_recognition_tpu_torch.ops import selbin_kernel as k2

    if not k1.__file__.startswith(root):
        raise RuntimeError(f"imported {k1.__file__}, not from {root}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn(N_ROWS, FL, device=dev, generator=g)
    ycat = torch.randn(TWO_BINS, B * NBLK * K, device=dev, generator=g).to(torch.bfloat16)
    imat = torch.randn(TWO_BINS, HOP, device=dev, generator=g).to(torch.bfloat16)
    # kernel 5 takes one 2-bins block of rows for each bf16 plane the
    # checkout's kernel 4 writes (hi and lo, or one), as its scan does
    x1 = torch.zeros(1, 1, 8, dtype=torch.bfloat16, device=dev)
    n_planes = k6.fft_binmm(x1, x1, torch.zeros(1, 16, 8, dtype=torch.bfloat16,
                                              device=dev)).numel() // 16
    ycat, imat = ycat.repeat(n_planes, 1), imat.repeat(n_planes, 1)
    c = torch.randn(K, device=dev, generator=g)
    planes = torch.randn(4, B, T_PAD, F, device=dev, generator=g)
    valid = torch.full((B,), VALID, dtype=torch.int32, device=dev)
    need = _dual_ranks(valid, F, QUANTILE)
    maps = (torch.rand(B, T_CORR, D_CORR, device=dev, generator=g) < DENSITY).to(torch.bfloat16)
    w = torch.randn(K, L_CORR, D_CORR, device=dev, generator=g).to(torch.bfloat16)
    map1 = maps[:1].contiguous()
    planes8 = torch.randn(4, B, T_PAD, F_MEL, device=dev, generator=g).transpose(0, 1)
    valid8 = torch.full((B,), VALID_MEL, dtype=torch.int32, device=dev)
    from template_speech_recognition_tpu_torch.ops import binspread_kernel as k9
    from template_speech_recognition_tpu_torch.ops import pair_llr_kernel as k11

    hi8, lo8 = fp.plane_order_statistics(planes8, valid8, QUANTILE)
    hi8, lo8 = hi8.contiguous(), lo8.contiguous()
    calls = {
        "frontend_planes": lambda: k1.edge_response_planes(frames, NFFT),
        "frontend_planes_mel": lambda: k1.edge_response_planes(frames, NFFT, SR, N_MELS),
        "select_binspread": lambda: k2.select_binspread(planes, need, valid, 1, 1),
        "fft_idft": lambda: k5.fft_idft(ycat, imat, c, NBLK),
        "layered_select": lambda: fp.plane_order_statistics(planes8, valid8, QUANTILE),
        "binspread": lambda: k9.binarize_freqspread(planes8, hi8, lo8, valid8, 1),
        "binarize_spread_flat": lambda: fp.binarize_spread_flat(planes8, hi8, lo8, valid8, 1, 1),
    }
    rng = np.random.default_rng(0)
    times = torch.from_numpy(rng.integers(0, VALID_LLR, (B, TOP_K))).to(dev)
    ids = torch.from_numpy(rng.integers(0, K, B * TOP_K).astype(np.int32)).to(dev)
    rowstart = (torch.arange(B, device=dev)[:, None] * T_PAD + times).reshape(-1).to(torch.int32)
    for d in (2048, 504):
        fmap = torch.rand(B, T_PAD, d, device=dev, generator=g) < DENSITY_LLR
        w16 = torch.randn(K, L_CORR, d, device=dev, generator=g).to(torch.bfloat16)
        calls["pair_llr" if d == 2048 else "pair_llr_d504"] = (
            lambda fmap=fmap, w16=w16: k11.pair_llr(fmap, w16, rowstart, ids, M_LLR))
    from template_speech_recognition_tpu_torch.ops import dtw_kernel as k12

    ids_l = ids.long()
    for tag, length, m in (("", 32, 40), ("_l96", 96, 104)):
        llr = torch.randn(B * TOP_K, length, m, device=dev, generator=g) - 2.0
        if length == 32:
            lens = torch.clamp(VALID_LLR - times.reshape(-1), 1, 38).to(torch.int32)
        else:
            lens = torch.from_numpy(rng.integers(51, 103, B * TOP_K).astype(np.int32)).to(dev)
        c_rows = torch.randn(K, length, device=dev, generator=g)
        cost = -(llr + c_rows[ids_l][:, :, None])
        calls["banded_dtw" + tag] = (
            lambda cost=cost, lens=lens: k12.banded_dtw(cost, lens, BAND_DTW))
        calls["dtw_stage" + tag] = dtw_stage(torch, k12, llr, lens, c_rows, ids)
    for d in (2048, 504):
        dp = -(-d // 16) * 16
        buf = torch.zeros((2, BINS, B * NBLK, dp), dtype=torch.int8, device=dev)
        buf[..., :d] = torch.randint(-127, 128, (2, BINS, B * NBLK, d), dtype=torch.int8,
                                     device=dev, generator=g)
        w2 = torch.randint(-127, 128, (BINS, 2 * d, K), dtype=torch.int8, device=dev,
                           generator=g)
        sc = torch.rand(BINS, K, device=dev, generator=g) * 1e-4
        if hasattr(k6, "kmajor_spectra"):
            xr, xi, w2t = buf[0, ..., :d], buf[1, ..., :d], k6.kmajor_spectra(w2)
            fn = lambda xr=xr, xi=xi, w2=w2, sc=sc, w2t=w2t: k6.fft_binmm_int8(  # noqa: E731
                xr, xi, w2, sc, w2_kmajor=w2t)
        else:
            xr, xi = buf[0, ..., :d].contiguous(), buf[1, ..., :d].contiguous()
            fn = lambda xr=xr, xi=xi, w2=w2, sc=sc: k6.fft_binmm_int8(xr, xi, w2, sc)  # noqa: E731
        calls["fft_binmm_int8" if d == 2048 else "fft_binmm_int8_d504"] = fn
    for d in (2048, 504):
        xr, xi = (torch.randn(BINS, B * NBLK, d, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))
        w2 = torch.randn(BINS, 2 * d, K, device=dev, generator=g).to(torch.bfloat16)
        calls["fft_binmm" if d == 2048 else "fft_binmm_d504"] = (
            lambda xr=xr, xi=xi, w2=w2: k6.fft_binmm(xr, xi, w2))
    cm, sm = _dft_mats(NFFT_S, torch.bfloat16, dev)
    g_dft = torch.cat([cm, -sm], dim=1).contiguous()
    for d in (2048, 504):
        x = (torch.rand(B, T_PAD, d, device=dev, generator=g) < 0.15).to(torch.bfloat16)
        calls["fft_block_dft" if d == 2048 else "fft_block_dft_d504"] = (
            lambda x=x: k3.fft_block_dft(x, g_dft, NFFT_S, HOP, NBLK))
    out = {"root": root, "binmm_planes": n_planes}
    for name, fn in calls.items():
        out[name] = {"loop100_ms": time_ms(torch, fn, loop=100), "one_launch_ms": time_ms(torch, fn)}
    gemm = torch.randn(NB_EX, M_EX, K, L_CORR, device=dev, generator=g) - 2.0
    lens_ex = torch.from_numpy(rng.integers(1, M_EX + 1, NB_EX).astype(np.int32)).to(dev)
    c_ex = torch.randn(K, L_CORR, device=dev, generator=g)
    fn = exhaustive_stage(torch, k12, gemm, lens_ex, c_ex)
    out["dtw_stage_exhaustive"] = {"loop10_ms": time_ms(torch, fn, loop=10),
                                   "one_launch_ms": time_ms(torch, fn)}
    del gemm
    gemm = torch.randn(NB_CL, M_CL, K_CL, L_CL, device=dev, generator=g) - 2.0
    lens_cl = torch.from_numpy(rng.integers(L_CL, M_CL + 1, NB_CL).astype(np.int32)).to(dev)
    c_cl = torch.randn(K_CL, L_CL, device=dev, generator=g)
    fn = exhaustive_stage(torch, k12, gemm, lens_cl, c_cl)
    out["dtw_stage_classify"] = {"loop100_ms": time_ms(torch, fn, loop=100),
                                 "one_launch_ms": time_ms(torch, fn)}
    del gemm
    for name, x in (("correlation", maps), ("correlation_b1", map1)):
        fn = lambda x=x: k10.correlation_scores(x, w, c)      # noqa: E731
        out[name] = {"loop10_ms": time_ms(torch, fn, loop=10), "one_launch_ms": time_ms(torch, fn)}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
