#!/usr/bin/env python3
"""Where the bf16 FFT scorer's error comes from with the soak's K 10,000
bank (GPU).

    python3 probe_bank10k.py

One batch of the soak corpus (``soak_cuda.build_corpus(75)``: the first
8 utterances of its longest length bucket) through the frontend's
kernels, scored with the aa / iy bank trained on the corpus and
inflated to 10,000 templates (``soak_bank10k_cuda.inflate_bank``):

* the scorer (``fft_sliding_scores``: kernel 4's product in bf16 hi
  and lo planes) three ways: the kernels on bf16 spectra, the plain versions
  on the same bf16 spectra, and the plain versions on f32 spectra (the
  f32 reference); each pair's largest difference over the valid
  windows, and over each window's best template, as a share of
  max|score| of the f32 scores;
* kernel 4 alone on kernel 3's spectra against its plain version, the
  product read "unsplit" (the hi plane alone: the one bf16 plane of the
  reference) and "split" (hi and lo planes): the largest |Y| of each bin
  (f32), the hi outputs of each bin that the two round differently, and
  the scores of each (the plain iDFT) kernel against plain and plain
  against the f32 scores; unsplit also with both bin-0 rows replaced by
  the f32 product's: how much of the kernel-to-plain difference the DC
  bin carries.

Prints one JSON line with the card's ``nvidia-smi`` name and power
limit.  Imports the port and ``oracle/``, nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

BATCH, K_TOTAL = 8, 10_000


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("probe_bank10k: no CUDA device", file=sys.stderr)
        return 2
    from card_checks import TRAIN_PHONES, card_line
    from soak_bank10k_cuda import inflate_bank
    from soak_cuda import build_corpus, scan_config
    from template_speech_recognition_tpu_torch.detect import fft_scorer as fs
    from template_speech_recognition_tpu_torch.frontend.planes import frontend_batch_flat
    from template_speech_recognition_tpu_torch.ops import fft_binmm_kernel as k4
    from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3
    from template_speech_recognition_tpu_torch.ops import fft_idft_kernel as k5
    from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat
    from template_speech_recognition_tpu_torch.pipeline import train_bank
    from template_speech_recognition_tpu_torch.scan import bucket_length
    from template_speech_recognition_tpu_torch.utils.compile_cache import enable_compile_cache

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    enable_compile_cache()
    cfg = scan_config(BATCH)
    fcfg = cfg.frontend
    corpus = build_corpus(75)
    bank = inflate_bank(train_bank(corpus, list(TRAIN_PHONES), cfg, device=dev), K_TOTAL)
    wavs = [w for _u, w, _p in corpus.iter_utterances()]
    pad = max(bucket_length(len(w)) for w in wavs)
    rows = [w for w in wavs if bucket_length(len(w)) == pad][:BATCH]
    x = torch.zeros((len(rows), pad), dtype=torch.float32)
    for i, w in enumerate(rows):
        x[i, : len(w)] = torch.from_numpy(w)
    nv = torch.tensor([len(w) for w in rows], dtype=torch.int32)
    fm = frontend_batch_flat(x.to(dev), nv.to(dev), fcfg)
    t = fcfg.num_feature_frames(pad)
    feats = fm.binary[:, :t]
    wf, cf = bank.llr()
    wflat = filters_to_flat(wf)
    length = wflat.shape[1]
    b16 = fs.build_fft_bank(wflat, cf)
    b32 = fs.build_fft_bank(wflat, cf, mm_dtype=torch.float32)
    s_k = fs.fft_sliding_scores(feats, b16, time_major=True)
    s_p = fs.fft_sliding_scores(feats, b16, time_major=True, plain=True)
    s_f = fs.fft_sliding_scores(feats, b32, time_major=True, plain=True)
    tv = (fm.valid_frames - length + 1).clamp(min=0)
    valid = torch.arange(s_f.shape[1], device=dev)[None, :] < tv[:, None]     # [B, T'']
    top = float(s_f[valid].abs().max())

    def share(a, b):
        cells = float((a - b).abs()[valid].max()) / top
        best = float((a.max(dim=-1).values - b.max(dim=-1).values).abs()[valid].max()) / top
        return cells, best

    out = {"card": card_line(), "k": K_TOTAL, "L": length, "nfft": b16.nfft, "B": len(rows),
           "T": t, "max_abs_score_f32": top}
    for name, (a, b) in {"kernels_vs_plain_bf16": (s_k, s_p), "kernels_vs_f32": (s_k, s_f),
                         "plain_bf16_vs_f32": (s_p, s_f)}.items():
        out[name] = dict(zip(("cells", "best_template"), share(a, b)))
    del s_k, s_p

    # kernel 4 alone, on kernel 3's spectra
    nfft, hop = b16.nfft, b16.nfft - length + 1
    nblk = -(-(t - length + 1) // hop)
    xb = feats.to(torch.bfloat16).contiguous()
    xr, xi = k3.fft_block_dft(xb, fs._dft_basis(nfft, torch.bfloat16, dev), nfft, hop, nblk)
    bins = xr.shape[0]
    xr3, xi3 = (a.reshape(bins, -1, a.shape[-1]).float() for a in (xr, xi))
    x2 = torch.cat([torch.cat([xr3, xi3], 2), torch.cat([xi3, -xr3], 2)], 1)
    y32 = torch.bmm(x2, b16.w2.float())                                       # [bins, 2m, K]
    m = xr3.shape[1]
    y32 = torch.stack([y32[:, :m], y32[:, m:]])                               # [2, bins, m, K]
    del x2, xr3, xi3
    out["max_abs_Y_by_bin"] = [float(v) for v in y32.abs().amax(dim=(0, 2, 3))]

    def scores(y, copies):
        imat = fs._idft_basis(nfft, hop, torch.bfloat16, dev, copies)
        return k5.fft_idft_plain(y.reshape(imat.shape[0], -1), imat, b16.c,
                                 nblk)[:, : t - length + 1]

    def gap(a, b):
        return float((a - b).abs()[valid].max()) / top

    def dc_f32(y):
        y = y.float().clone()
        y[:, 0] = y32[:, 0]
        return y

    y_k, y_p = k4.fft_binmm(xr, xi, b16.w2), k4.fft_binmm_plain(xr, xi, b16.w2)
    hi_k, hi_p = y_k[0], y_p[0]
    out["rounded_apart_by_bin"] = [int(v) for v in (hi_k != hi_p).sum(dim=(0, 2, 3))]
    sp = scores(hi_p, 1)
    out["unsplit"] = {"kernel_vs_plain": gap(scores(hi_k, 1), sp), "plain_vs_f32": gap(sp, s_f),
                      "kernel_vs_plain_dc_in_f32": gap(scores(dc_f32(hi_k), 1),
                                                       scores(dc_f32(hi_p), 1))}
    sp = scores(y_p, 2)
    out["split"] = {"kernel_vs_plain": gap(scores(y_k, 2), sp), "plain_vs_f32": gap(sp, s_f)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
