#!/usr/bin/env python3
"""On-card parity gate of the PyTorch/CUDA port against the NumPy oracle.

    python3 verify_cuda.py [--device cpu] [--out DIR] [--only NAME ...]

``verify_tpu.py``'s 15 checks on the card: each keeps the reference
check's seeds, shapes, oracle function and gate, and goes through the
port entry that reaches the CUDA kernel (table below).  The yardstick is
the independent NumPy ``oracle/`` wherever the reference's is; elsewhere
the plain version on the same device (the reference's "XLA twin on
device") or float64.

==========================  =========================================  ==========
check                       yardstick and gate                         kernels
==========================  =========================================  ==========
frontend_fused              ``oracle.frontend``, binary agreement      1, 2
                            > 0.999
frontend_mel_fused          float64 log-mel edges, scaled < 1e-3       1 (mel)
edge_responses              the plain version on the device, scaled    7
                            < 1e-3
correlation                 ``oracle.score.sliding_score``, scaled     10
                            < 2e-3 (bf16 operands)
dtw                         ``oracle.dtw.banded_dtw``, rtol 1e-4; out  13
                            of band > 1e38; and the M 512 segments
dtw_packed_layout           the same at (n 13, L 9, m 20, band 4); the 12
                            plain version at rtol 1e-6 (the
                            reference's full layout)
pair_llr_fused              the pairwise rescore of gathered bf16      11, 12
                            segments, rtol / atol 1e-3
fft_fused_4d, fft_binmm_3d  the oracle (scaled 2e-2) and the plain     3, 4, 5
                            path (5e-3)
fft_binmm_int8              the f32 plain path, scaled < 4e-2, argmax  3, 6, 5
                            agreement > 0.9
int32_bit_parity            ``oracle.score.sliding_score_int``,        none
                            bit-identical
radix_select                NumPy's order statistics of the same       8
                            planes, exact
binspread_kernel            the plain ``binarize_spread_flat``,        9
                            bitwise
selbin_fused                the plain layered select + binarize,       2
                            bitwise (map and keys)
frontend_flat_oracle        ``oracle.frontend``'s flat map, agreement  1, 2
                            > 0.999
==========================  =========================================  ==========

The reference's lane-packed DTW layout and its counting-pass radix
kernel have no counterpart: the port's DTW kernel takes every shape in
one layout (``dtw_packed_layout`` holds it at the packed shape), and its
kernel 8 computes the whole dual-rank select, so ``radix_select`` holds
the select's order statistics where the reference held one counting
level.

On the card each check runs its call once under ``torch.profiler`` with
the launch counts set to 0 just before: it fails unless every kernel of
its row launched (``ops._cuda.launch_counts``) and its CUDA function is
among the traced device operations, so a plain fallback cannot pass.  An
exception in a check fails that check.

Writes ``PARITY_CUDA.json`` into ``--out`` (default: the directory of
this script) with ``PARITY_TPU.json``'s keys: ``backend`` ("cuda", or
"cpu" under ``--device cpu``), ``device`` (the card's ``nvidia-smi``
name and power limit), ``compiled``, ``all_ok`` and ``kernels`` (each
check's ``kernel``, ``ok``, error measures and ``seconds``; on the card
also ``launches`` and ``cuda_functions``).  Prints one JSON line last;
exits 1 if a check failed, and 2 without a CUDA device unless
``--device cpu`` is given (then every wrapper runs its plain version on
the CPU, for the tests).  Imports the port and ``oracle/``, nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# each kernel's launch-count name -> a substring of its CUDA function's name
CUDA_FUNCTIONS = {
    "frontend_planes": "planes_kernel", "frontend_planes_mel": "planes_kernel",
    "select_binspread": "selbin_cluster", "fft_block_dft": "block_dft_kernel",
    "fft_binmm": "binmm_kernel", "fft_binmm_int8": "binmm_int8_kernel",
    "fft_idft": "idft_kernel", "radix_select": "radix_hist_kernel",
    "binspread": "binspread_kernel", "correlation": "correlation_kernel",
    "pair_llr": "pair_llr_kernel", "banded_dtw": "banded_dtw",
}
OUT_NAME = "PARITY_CUDA.json"


def _scaled_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_traced(dev, fn, kernels):
    """``fn()`` once -> (its result, proof).  On the card the launch
    counts are set to 0 just before and the call is traced
    (``card_checks.device_op_names``): ``proof`` holds each kernel's
    launches, the CUDA functions found among the device operations and
    ``ok``, true when every kernel launched and its function ran.  On
    the CPU (plain versions) the proof is empty."""
    if dev.type != "cuda":
        return fn(), {}
    import torch

    from card_checks import device_op_names
    from template_speech_recognition_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    held = []
    names = device_op_names(torch, lambda: held.append(fn())) or []
    counts = _cuda.launch_counts()
    launches = {k: int(counts.get(k, 0)) for k in kernels}
    want = {CUDA_FUNCTIONS[k] for k in kernels}
    found = sorted(f for f in want if any(f in n for n in names))
    return held[0], {"launches": launches, "cuda_functions": found,
                     "ok": all(launches.values()) and len(found) == len(want)}


def _verdict(name, ok, proof, **measures) -> dict:
    out = {"kernel": name, "ok": bool(ok and proof.get("ok", True))}
    out.update(measures)
    if proof:
        out["launches"], out["cuda_functions"] = proof["launches"], proof["cuda_functions"]
    return out


def _test_wave():
    rng = np.random.default_rng(0)
    t = np.arange(16384) / 16000.0
    return (np.sin(2 * np.pi * 700 * t) + 0.5 * np.sin(2 * np.pi * 2300 * t)
            + 0.1 * rng.standard_normal(t.size)).astype(np.float32)


def check_frontend_fused(torch, dev) -> dict:
    from oracle.frontend import FrontendParams, frontend as oracle_frontend
    from template_speech_recognition_tpu_torch.config import FrontendConfig
    from template_speech_recognition_tpu_torch.frontend import frontend

    wav, nv = _test_wave(), 15000
    fm, proof = run_traced(dev, lambda: frontend(torch.from_numpy(wav).to(dev), nv,
                                                 FrontendConfig()),
                           ("frontend_planes", "select_binspread"))
    want = oracle_frontend(wav[:nv], FrontendParams())
    got = _np(fm.binary)[: want.shape[0]]
    agree = float((got == want).mean())
    return _verdict("frontend_fused", agree > 0.999 and int(fm.valid_frames) >= want.shape[0],
                    proof, binary_agreement=agree)


def _frames(seed, t, fl):
    return np.random.default_rng(seed).standard_normal((t, fl)).astype(np.float32)


def check_frontend_mel_fused(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.ops.frontend_kernel import (
        edge_responses,
        planes64,
    )

    t, fl, nfft, sr, n_mels = 256, 400, 512, 16000, 64
    frames = torch.from_numpy(_frames(5, t, fl)).to(dev)
    got, proof = run_traced(dev, lambda: edge_responses(frames, nfft, sr, n_mels),
                            ("frontend_planes_mel",))
    p64 = planes64(frames, nfft, sr, n_mels)[0]
    want = torch.stack([s * p for p in p64 for s in (1.0, -1.0)], dim=-1)
    err = _scaled_err(_np(got)[: t - 1], _np(want)[: t - 1])
    return _verdict("frontend_mel_fused", err < 1e-3, proof, scaled_err=err)


def check_edge_responses(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.ops import edges
    from template_speech_recognition_tpu_torch.ops.dft import log_magnitude_spectrogram
    from template_speech_recognition_tpu_torch.ops.frontend_kernel import edge_responses

    t, fl, nfft = 256, 64, 256
    frames = torch.from_numpy(_frames(1, t, fl)).to(dev)
    got, proof = run_traced(dev, lambda: edge_responses(frames, nfft), ("frontend_planes",))
    want = edges.edge_responses(log_magnitude_spectrogram(frames, nfft))
    err = _scaled_err(_np(got)[: t - 1], _np(want))
    return _verdict("edge_responses", err < 1e-3, proof, scaled_err=err)


def check_correlation(torch, dev) -> dict:
    """bf16 operands, as the kernel takes them; the oracle gets the f32
    filters (the reference's gate covers that rounding)."""
    from oracle.score import sliding_score
    from template_speech_recognition_tpu_torch.ops.correlation_kernel import (
        correlation_scores,
    )

    rng = np.random.default_rng(2)
    t, d, k, length, f, e = 256, 256, 128, 16, 32, 8
    feats = (rng.random((t, f, e)) < 0.2).astype(np.float32)
    w = rng.standard_normal((k, length, f, e)).astype(np.float32)
    c = rng.standard_normal((k,)).astype(np.float32)
    x = torch.from_numpy(feats.reshape(1, t, d)).to(dev, torch.bfloat16)
    wt = torch.from_numpy(w.reshape(k, length, d)).to(dev, torch.bfloat16)
    ct = torch.from_numpy(c).to(dev)
    out, proof = run_traced(dev, lambda: correlation_scores(x, wt, ct), ("correlation",))
    err = _scaled_err(_np(out)[0], sliding_score(feats, w, c))
    return _verdict("correlation", err < 2e-3, proof, scaled_err=err)


def _dtw_case(torch, dev, rng, n, length, m, band, lo, rtol, atol):
    """n pairs of [L, m] costs (normal + 2) and lengths in [lo, m] -> (ok,
    max error on the reachable terminals, the kernel's terminals, the
    costs, the lengths, proof)."""
    from oracle.dtw import banded_dtw as oracle_dtw
    from template_speech_recognition_tpu_torch.ops.dtw_kernel import banded_dtw

    cost = (rng.standard_normal((n, length, m)) + 2.0).astype(np.float32)
    lens = rng.integers(lo, m + 1, size=n).astype(np.int32)
    ct, lt = torch.from_numpy(cost).to(dev), torch.from_numpy(lens).to(dev)
    got, proof = run_traced(dev, lambda: banded_dtw(ct, lt, band), ("banded_dtw",))
    got = _np(got)
    want = np.array([oracle_dtw(cost[i, :, : lens[i]], band) for i in range(n)], np.float32)
    fin = np.isfinite(want)
    ok = bool(fin.any() and np.allclose(got[fin], want[fin], rtol=rtol, atol=atol)
              and np.all(got[~fin] > 1e38))
    err = float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else -1.0
    return ok, err, got, ct, lt, proof


def check_dtw(torch, dev) -> dict:
    """Then the long segments (M 512 >> L 64): the reference streamed them
    in diagonal chunks; the port's kernel takes them in one launch."""
    rng = np.random.default_rng(3)
    ok1, err1, _g, _c, _l, proof1 = _dtw_case(torch, dev, rng, 16, 32, 64, 6, 20, 1e-4, 1e-4)
    ok2, err2, _g, _c, _l, proof2 = _dtw_case(torch, dev, rng, 8, 64, 512, 12, 440, 1e-4, 1e-3)
    proof = proof1 and {"launches": proof2["launches"], "cuda_functions":
                        proof2["cuda_functions"], "ok": proof1["ok"] and proof2["ok"]}
    return _verdict("dtw", ok1 and ok2, proof, max_abs_err=err1, long_seg_max_abs_err=err2)


def check_dtw_packed_layouts(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.ops.dtw_kernel import banded_dtw_plain

    rng = np.random.default_rng(11)
    band = 4
    ok, err, got, ct, lt, proof = _dtw_case(torch, dev, rng, 13, 9, 20, band, 6, 1e-4, 1e-4)
    plain = _np(banded_dtw_plain(ct, lt, band))
    fin = plain < 1e37
    ok = ok and bool(np.allclose(got[fin], plain[fin], rtol=1e-6, atol=1e-6))
    return _verdict("dtw_packed_layout", ok, proof, max_abs_err=err)


def check_pair_llr_fused(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.align.dtw import (
        dtw_pairwise_scores,
        dtw_pairwise_scores_from_map,
    )

    rng = np.random.default_rng(13)
    b, t, k, length, d = 2, 96, 7, 8, 256
    m_seg, band, p = 12, 3, 5
    binary = rng.random((b, t, d)) < 0.3
    times = rng.integers(0, t - 1, (b, p)).astype(np.int32)
    ids = rng.integers(0, k, (b, p)).astype(np.int32)
    w = rng.normal(size=(k, length, d)).astype(np.float32)
    c_rows = rng.normal(size=(k, length)).astype(np.float32)
    vf = np.asarray([t, t - 9], np.int32)

    def on(a):
        return torch.from_numpy(a).to(dev)

    got, proof = run_traced(dev, lambda: dtw_pairwise_scores_from_map(
        on(binary), on(times), on(ids), on(w), on(c_rows), on(vf), m_seg, band),
        ("pair_llr", "banded_dtw"))
    got = _np(got)
    idx = np.clip(times[:, :, None] + np.arange(m_seg)[None, None], 0, t - 1)
    segs = np.stack([binary[i][idx[i]] for i in range(b)]).astype(np.float32)
    lens = np.clip(vf[:, None] - times, 1, m_seg).astype(np.int32)
    want = _np(dtw_pairwise_scores(
        on(segs.reshape(b * p, m_seg, d)).to(torch.bfloat16), on(lens.reshape(-1)),
        on(w[ids.reshape(-1)]).to(torch.bfloat16), on(c_rows[ids.reshape(-1)]), band,
    )).reshape(b, p)
    fin = np.isfinite(want)
    err = float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0
    ok = bool(np.allclose(got[fin], want[fin], rtol=1e-3, atol=1e-3)
              and (np.isfinite(got) == fin).all())
    return _verdict("pair_llr_fused", ok, proof, max_abs_err=err)


def _fft_case(torch, dev, b, t, k, length, f, e, nfft, seed, kernels, mm_dtype=None):
    """The FFT scorer on binary maps [B, T, F, E] and normal filters: (the
    kernels' scores, the plain path's with the same bank, the oracle's,
    proof); ``mm_dtype`` picks the bank's spectra (bf16 on the card)."""
    from oracle.score import sliding_score
    from template_speech_recognition_tpu_torch.detect.fft_scorer import (
        build_fft_bank,
        fft_sliding_scores,
    )

    rng = np.random.default_rng(seed)
    feats = (rng.random((b, t, f, e)) < 0.2).astype(np.float32)
    w = rng.normal(size=(k, length, f, e)).astype(np.float32)
    c = rng.normal(size=(k,)).astype(np.float32)
    x, wt, ct = (torch.from_numpy(a).to(dev) for a in (feats, w, c))
    bank = build_fft_bank(wt, ct, nfft=nfft, mm_dtype=mm_dtype)
    got, proof = run_traced(dev, lambda: fft_sliding_scores(x, bank), kernels)
    plain = fft_sliding_scores(x, bank, plain=True)
    ref = np.stack([sliding_score(fm, w, c) for fm in feats])
    return _np(got), _np(plain), ref, proof, (x, wt, ct)


def _fft_check(torch, dev, name, **case) -> dict:
    got, plain, ref, proof, _ = _fft_case(torch, dev, **case,
                                          kernels=("fft_block_dft", "fft_binmm", "fft_idft"))
    err_x, err_o = _scaled_err(got, plain), _scaled_err(got, ref)
    return _verdict(name, err_x < 5e-3 and err_o < 2e-2, proof,
                    scaled_err_vs_plain=err_x, scaled_err_vs_oracle=err_o)


def check_fft_fused_4d(torch, dev) -> dict:
    """One utterance of 1,936 frames, D 128, K 128: the reference's fully
    fused 4-D chain; here kernels 3, 4 and 5."""
    return _fft_check(torch, dev, "fft_dft+binmm4d+idft_fused", b=1, t=1936, k=128,
                      length=17, f=16, e=8, nfft=256, seed=4)


def check_fft_binmm_3d(torch, dev) -> dict:
    """B 3, K 5 and D 51: K padded to 8 by zero templates, D to 56."""
    return _fft_check(torch, dev, "fft_binmm_3d_padded", b=3, t=260, k=5, length=12,
                      f=17, e=3, nfft=127, seed=5)


def check_int8_binmm(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.detect.fft_scorer import (
        build_fft_bank,
        fft_sliding_scores,
    )

    got, _plain, _ref, proof, (x, wt, ct) = _fft_case(
        torch, dev, b=2, t=200, k=128, length=16, f=16, e=8, nfft=None, seed=12,
        kernels=("fft_block_dft", "fft_binmm_int8", "fft_idft"), mm_dtype=torch.int8)
    ref = _np(fft_sliding_scores(x, build_fft_bank(wt, ct, mm_dtype=torch.float32),
                                 plain=True))
    err = _scaled_err(got, ref)
    agree = float((got.argmax(axis=1) == ref.argmax(axis=1)).mean())
    return _verdict("fft_binmm_int8", err < 4e-2 and agree > 0.9, proof,
                    scaled_err_vs_f32=err, argmax_agreement=agree)


def check_int32_bit_parity(torch, dev) -> dict:
    """No kernel: the reference computes it outside Pallas, the port in
    PyTorch on the device (float64 sums, exact)."""
    from oracle.score import llr_filter, quantize_filter, sliding_score_int
    from template_speech_recognition_tpu_torch.detect.scorer import sliding_scores_int

    rng = np.random.default_rng(6)
    t, k, length, f, e = 300, 16, 20, 24, 8
    feats = (rng.random((t, f, e)) < 0.2).astype(np.float32)
    p = np.clip(rng.random((k, length, f, e)), 0.05, 0.95).astype(np.float32)
    q = np.clip(rng.random((f, e)), 0.05, 0.95).astype(np.float32)
    w_int, c_int = quantize_filter(*llr_filter(p, q))
    got = _np(sliding_scores_int(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                   for a in (feats, w_int, c_int))))
    want = sliding_score_int(feats, w_int, c_int)
    same = bool(np.array_equal(got, want))
    return _verdict("int32_sliding_scores", same, {}, bit_identical=same,
                    mismatches=int(np.sum(got != want)))


def check_radix_counts(torch, dev) -> dict:
    """The whole dual-rank select of kernel 8 on 8 planes of ~5,000 cells
    (the reference's 8 rows of 5,000 keys), ties included, at the
    frontend's quantile 0.9 and 0.98: its order statistics equal NumPy's
    sorted valid cells at ranks k and n-1-k."""
    from template_speech_recognition_tpu_torch.frontend.planes import _dual_ranks
    from template_speech_recognition_tpu_torch.ops.radix_kernel import radix_select

    rng = np.random.default_rng(7)
    p, b, t, f = 4, 2, 80, 63
    planes = rng.standard_normal((p, b, t, f)).astype(np.float32)
    planes[:, :, : t // 3] = np.round(planes[:, :, : t // 3] * 4) / 4      # ties
    valid = np.asarray([t, t // 2 + 1], np.int32)
    pt, vt = torch.from_numpy(planes).to(dev), torch.from_numpy(valid).to(dev)
    mismatches, proof = 0, {}
    for q in (0.9, 0.98):
        need = _dual_ranks(vt, f, q)
        (os_hi, os_lo), pr = run_traced(dev, lambda: radix_select(pt, vt, need),
                                        ("radix_select",))
        proof = pr if not proof else {**pr, "ok": proof["ok"] and pr["ok"]}
        need_np = _np(need)
        for bi in range(b):
            for pi in range(p):
                cells = np.sort(planes[pi, bi, : valid[bi]].ravel())
                want = cells[need_np[bi] - 1]
                mismatches += int(_np(os_hi)[bi, pi] != want[0])
                mismatches += int(_np(os_lo)[bi, pi] != want[1])
    return _verdict("radix_select", mismatches == 0, proof, mismatches=mismatches)


def check_binspread_kernel(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops.binspread_kernel import (
        binarize_freqspread,
    )

    rng = np.random.default_rng(8)
    b, p, t, f = 2, 4, 256, 128
    planes = torch.from_numpy(rng.standard_normal((b, p, t, f)).astype(np.float32)).to(dev)
    valid = torch.tensor([t, t // 2], dtype=torch.int32, device=dev)
    os_hi, os_lo = fp.plane_order_statistics(planes, valid, 0.9, plain=True)
    got, proof = run_traced(dev, lambda: binarize_freqspread(planes, os_hi, os_lo, valid, 1),
                            ("binspread",))
    want = fp.binarize_spread_flat(planes, os_hi, os_lo, valid, 0, 1, plain=True)
    n_bad = int((got.to(torch.bool) != want).sum())
    return _verdict("binarize_freqspread", n_bad == 0, proof, mismatches=n_bad)


def check_selbin_fused(torch, dev) -> dict:
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import edges
    from template_speech_recognition_tpu_torch.ops.selbin_kernel import select_binspread

    rng = np.random.default_rng(9)
    p, b, t, f = 4, 3, 256, 128
    x = rng.standard_normal((p, b, t, f)).astype(np.float32)
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4            # ties
    planes = torch.from_numpy(x).to(dev)
    valid = torch.tensor([t, t // 2, 9], dtype=torch.int32, device=dev)
    need = fp._dual_ranks(valid, f, 0.98)
    (flat, keys), proof = run_traced(dev, lambda: select_binspread(planes, need, valid, 1),
                                     ("select_binspread",))
    bptf = planes.transpose(0, 1)
    os_hi, os_lo = fp.plane_order_statistics(bptf, valid, 0.98, plain=True)
    want = fp.binarize_spread_flat(bptf, os_hi, os_lo, valid, 0, 1, plain=True)
    flat_ok = bool(torch.equal(flat.to(torch.bool), want))
    keys_ok = bool(torch.equal(edges.key_to_float(keys[..., 0]), os_hi)
                   and torch.equal(edges.key_to_float(keys[..., 1]), os_lo))
    return _verdict("selbin_fused", flat_ok and keys_ok, proof, flat_bitwise=flat_ok,
                    keys_bitwise=keys_ok)


def check_frontend_flat_oracle(torch, dev) -> dict:
    from oracle.frontend import FrontendParams, frontend as oracle_frontend
    from template_speech_recognition_tpu_torch.config import FrontendConfig
    from template_speech_recognition_tpu_torch.frontend.planes import frontend_batch_flat
    from template_speech_recognition_tpu_torch.ops.layout import channels_to_flat

    wav, nv = _test_wave(), 15000
    fm, proof = run_traced(dev, lambda: frontend_batch_flat(
        torch.from_numpy(wav).to(dev)[None], torch.tensor([nv], dtype=torch.int32, device=dev),
        FrontendConfig()), ("frontend_planes", "select_binspread"))
    want = _np(channels_to_flat(torch.from_numpy(oracle_frontend(wav[:nv], FrontendParams()))))
    got = _np(fm.binary[0])[: want.shape[0]]
    agree = float((got == want).mean())
    return _verdict("frontend_flat_fused", agree > 0.999, proof, binary_agreement=agree)


CHECKS = [
    check_frontend_fused,
    check_frontend_mel_fused,
    check_edge_responses,
    check_correlation,
    check_dtw,
    check_dtw_packed_layouts,
    check_pair_llr_fused,
    check_fft_fused_4d,
    check_fft_binmm_3d,
    check_int8_binmm,
    check_int32_bit_parity,
    check_radix_counts,
    check_binspread_kernel,
    check_selbin_fused,
    check_frontend_flat_oracle,
]


def run_checks(torch, dev, only=None, say=None) -> list[dict]:
    """Every check (or those whose function name ends with one of
    ``only``) on ``dev``, each timed; an exception fails its check."""
    results = []
    for fn in CHECKS:
        if only and not any(fn.__name__.endswith(o) for o in only):
            continue
        t0 = time.perf_counter()
        try:
            r = fn(torch, dev)
        except Exception as exc:
            r = {"kernel": fn.__name__.removeprefix("check_"), "ok": False,
                 "error": repr(exc)[:500]}
        r["seconds"] = round(time.perf_counter() - t0, 3)
        results.append(r)
        if say is not None:
            say(f"verify {r['kernel']}: {'PASS' if r['ok'] else 'FAIL'} {json.dumps(r)}")
    return results


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; exits 2 without a GPU) or cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    p.add_argument("--out", default=here, help=f"directory of {OUT_NAME}")
    p.add_argument("--only", nargs="*", default=None,
                   help="run the checks whose names end with these")
    args = p.parse_args(argv)
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch

    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("verify_cuda: no CUDA device (--device cpu runs the plain versions on the "
              "CPU)", file=sys.stderr)
        return 2
    card = None
    if dev.type == "cuda":
        from card_checks import card_line
        from template_speech_recognition_tpu_torch.utils.compile_cache import (
            enable_compile_cache,
        )

        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        enable_compile_cache()

    def say(msg):
        print(f"[{card or 'cpu'}] {msg}", file=sys.stderr, flush=True)

    results = run_checks(torch, dev, args.only, say)
    out = {"backend": "cuda" if card else "cpu", "device": card or "cpu",
           "compiled": card is not None, "all_ok": all(r["ok"] for r in results),
           "kernels": results}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, OUT_NAME), "w") as fh:
        json.dump(out, fh, indent=1)
    if card:
        print(card)
    print(json.dumps({"parity_cuda_all_ok": out["all_ok"], "n_kernels": len(results),
                      "failed": [r["kernel"] for r in results if not r["ok"]]}), flush=True)
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
