#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. builds the eleven CUDA kernels of the port from the ten sources in
   ``template_speech_recognition_tpu_torch/csrc`` (one nvcc per source,
   all started together);
2. calls each kernel's wrapper on the card at the shapes the scan gives
   it (8 utterances of 30 s: T_pad = 3072, F = 256, D = 2048, K = 1024
   templates of L = 32, nfft = 159; for the DTW rescore 8 x 123 peaks,
   windows of m = 40 frames) and holds the result against its plain
   PyTorch version on the same inputs, with the tolerance stated beside
   each check; times kernel, plain version and one library call with
   CUDA events (median of 10 after 2 warm-ups; the two short DTW
   kernels and their library call over loops of 100 launches) and
   computes each kernel's bound (the larger of the least bytes / 3.35
   TB/s and operations / the peak rate of their type).  The log-mel
   scan's kernels (n_mels 64: F = 63, D = 504) follow: kernel 1 in mel
   mode (also at n_mels 129, where the two-kernel path takes it), the
   radix counting pass at every level's real candidates (timed over 100
   launches queued behind a device sleep, so the events time the device,
   not the enqueue; the yardstick is ``torch.kthvalue`` for both ranks,
   which stands for the whole 11-launch select), binarize + spread, the
   layered path against the two-kernel path at the default shape
   (bitwise), and pair LLR and the int8 and bf16 bin matmuls at D = 504
   (the bf16 one on the log-mel scan's own spectra and bank, a second
   ``fft_binmm`` entry in the kernels line, tagged by ``shape``).  The
   direct correlation kernel runs at the reference's bench shape (8
   maps of T = 3000 frames of the scan's frontend, K = 1024, L = 32,
   D = 2048; its yardstick is ``conv1d`` in bf16).
   It also runs every kernel once at small ragged shapes (partial
   tiles, odd nfft, an utterance with no valid row, ties and -0.0,
   DTW at L = 32, 48, 96, 128 and 200 with ragged segment lengths and band
   1, LLR windows past the map's end, F = 39 and 63, unaligned radix
   rows, correlation at K = 3, D = 40 and 504, L = 1, 9, 48 and T, the
   TMA + wgmma bin matmul at m = 1, 63, 64, 65, 96 x D = 8, 40, 504 x
   K = 8, 136 x bins = 1, 3, the 4-D input, and a misaligned base
   pointer that must raise) and holds it against its plain version.
   Kernel 1 is also held, everywhere, to the float64 planes within an
   fp32 error bound; how far kernel and plain version are from float64
   is printed, and kernel 1's rows of the kernels line carry the bound
   of three TF32 passes on the tensor cores (``tf32_bound_ms``) beside
   the fp32 one.  Printed only: the share of the default scan's
   first-batch map cells that differ from its plain run's;
3. drives the scan itself, ``detect_corpus_stream``, at full width over
   19 utterances of 30 s (two batches of 8 and a tail of 3 padded to
   4, whose padding row has no valid frame), with every launch count
   set to 0 just before and read just after, and holds its detections
   against the same scan on the plain versions: first the default scan
   (bf16 spectra), then the scan with DTW rescoring (config 4,
   verify-the-winner) on int8 template spectra (config 5);
4. runs the exhaustive DTW rescore (``DTWConfig.top_r = 0``: every peak
   against all 1024 templates) on one batch of 8 against the plain
   versions;
5. drives the log-mel scan (``FrontendConfig(use_mel=True)``: the
   layered frontend) at full width over the same 19 utterances with a
   random bank of 1024 log-mel templates, then the log-mel scan with DTW
   rescoring on int8 spectra, each against its plain run, with the
   launch counts set to 0 just before each and read just after;
6. drives the backend-selectable scorer,
   ``sliding_scores_backend(backend="pallas")``, on the 8 maps one
   utterance at a time (the correlation kernel's path), against
   ``backend="fft"``; the streaming scan with ``score_backend="conv"``
   (the f32 conv, as in the reference), whose agreement with the default
   scan is printed, and on one batch against the per-utterance conv loop
   (identical peaks); ``pipeline.detect_corpus(exact_scores=True)`` on
   one batch, whose int32 scores of one utterance are held bitwise
   against the same function on the CPU; and the same loop with DTW
   rescoring (verify-the-winner, f32 filters), whose DTW scores are held
   against the CPU's rescore of the same peaks within 1e-5 x max|score|.

The default and the log-mel scan are each run once more under
``torch.profiler``: the union of the device intervals in the scan loop,
set against the untraced loop's wall time, is the device's busy share.

Any failed check exits non-zero without printing the result line.  The
last three lines are the kernels JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

SEED = 0
B, SECONDS, N_UTT = 8, 30.0, 19
K, L = 1024, 32
T_BENCH = 3000             # frames per utterance of the reference's bench.py
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
BF16_FLOPS = 989e12        # bf16 tensor cores, dense
TF32_FLOPS = 495e12        # TF32 tensor cores, dense
INT8_OPS = 1979e12         # int8 tensor cores, dense
STEMS = ("frontend_planes", "select_binspread", "fft_gemm", "fft_binmm", "banded_dtw",
         "pair_llr", "fft_binmm_int8", "radix_counts", "binspread", "correlation")
# kernels each scan must launch (launch-count names)
SCAN_KERNELS = ("frontend_planes", "select_binspread", "fft_block_dft", "fft_binmm",
                "fft_idft")
MEL_KERNELS = ("frontend_planes_mel", "radix_counts", "binspread", "fft_block_dft",
               "fft_binmm", "fft_idft")
# the two shapes at which the kernels line reports fft_binmm
BINMM_BENCH = "bench: bins 80, m 192, D 2048, K 1024"
BINMM_MEL = "log-mel: bins 80, m 192, D 504, K 1024"


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10, warm=2, loop=1) -> float:
    """Median over ``reps`` of the event time of ``loop`` back-to-back
    calls, divided by ``loop``.  Kernels of tens of microseconds take
    ``loop=100``: the loop is then queued behind a device sleep longer
    than its enqueue, so the device runs the launches back to back and
    the events time them, not the wrapper's host work."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if loop > 1:
            torch.cuda._sleep(50_000_000)      # ~25 ms at the H100's clocks
        a.record()
        for _ in range(loop):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / loop)
    return float(np.median(times))


def host_us(torch, fn, loop=100) -> float:
    """Host time per call of ``fn`` (the enqueue), in microseconds: a
    looped event time above it is the device's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(loop):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / loop * 1e6


def time_once(torch, fn):
    """(result, event ms) of one call: for the full-width plain versions
    that run once."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def device_ms_traced(torch, fn):
    """Device time of ``fn`` from a ``torch.profiler`` trace: the union of
    its device intervals (kernels, copies, memsets) in ms, and the device
    ms by name; (None, {}) if the trace holds no device event.  Unlike
    events around a stage, the union leaves out the gaps in which the
    device waits for the host to enqueue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        return None, {}
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return busy / 1e3, by_name


def report_busy(torch, say, label, run, build, ctr):
    """The scan loop's device time (a traced run of the whole scan less a
    traced bank build) against the loop wall of the untraced run, and the
    five names with the most device time in the loop."""
    total, names = device_ms_traced(torch, run)
    built, built_names = device_ms_traced(torch, build)
    if total is None or built is None:
        say(f"{label}: device busy share not measured (the trace holds no device event)")
        return
    loop_ms = ctr["time_scan_s"] * 1e3
    scan_ms = total - built
    for name, ms in built_names.items():
        names[name] = names.get(name, 0.0) - ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    say(f"{label}: device time in the scan loop {scan_ms:.3f} ms ({scan_ms / ctr['batches']:.3f} "
        f"ms a batch; torch.profiler, the bank build's {built:.3f} ms left out) = "
        f"{scan_ms / loop_ms:.3f} of the untraced loop's {loop_ms:.3f} ms; most device time: "
        + ", ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in top))


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / rate * 1e3 if ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Corpus:
    """N_UTT utterances of exactly SECONDS s cut from the synthetic
    fixture corpus (oracle/fixtures.py), so every one lands in the
    491,520-sample bucket (T_pad = 3072)."""

    def __init__(self, seed: int):
        from oracle.fixtures import make_synthetic_corpus

        self.sample_rate = 16000
        n = int(SECONDS * self.sample_rate)
        base = make_synthetic_corpus(
            num_utterances=N_UTT, phones_per_utterance=180, seed=seed
        )
        self.utts = []
        for u in base.utterances:
            check(len(u.waveform) >= n, "synthetic utterance shorter than 30 s")
            phones = [(p, s, e) for (p, s, e) in u.phones if e <= n]
            self.utts.append((u.utt_id, np.ascontiguousarray(u.waveform[:n]), phones))

    def iter_utterances(self):
        yield from self.utts

    def head(self, n: int) -> "Corpus":
        out = object.__new__(Corpus)
        out.sample_rate, out.utts = self.sample_rate, self.utts[:n]
        return out


def planes_metrics(torch, frames, nfft, got, want, sample_rate=0, n_mels=0, split=False):
    """Kernel 1's planes ``got`` against its plain version's ``want`` and
    the float64 planes of ``planes64``, as a dict.  ``scaled``: max
    |got - want| / max |want| on the well-conditioned cells, those whose
    four spectrum inputs have a power (log-mel: a mel energy) >= 1e-2,
    four decades above LOG_EPS (``share`` of the cells); ``err``: max
    |got - want| on all cells; ``scaled64`` and ``plain_scaled64``: the
    scaled error of ``got`` and of ``want`` against float64; ``head`` and
    ``plain_head``: the largest |error against float64| / the fp32 error
    bound, on all cells (``split``: the kernel's bound has the term of a
    3-pass TF32 split)."""
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices, mel_filterbank
    from template_speech_recognition_tpu_torch.ops.frontend_kernel import planes64

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
        scaled=scaled(got, want), err=float((got - want).abs().max()),
        share=float(ok.double().mean()), scaled64=scaled(got64, ref),
        plain_scaled64=scaled(want64, ref),
        head=float(((got64 - ref).abs() / bound_k).max()),
        plain_head=float(((want64 - ref).abs() / bound).max()),
    )


def check_planes(torch, frames, nfft, got, want, name, sample_rate=0, n_mels=0):
    """Kernel 1 against its plain version (``planes_metrics``): scaled
    error <= 1e-5 on the well-conditioned cells, and on every cell kernel
    and plain version alike within the fp32 error bound of the float64
    planes (next to the floor the log amplifies the summation order, so
    the two fp32 versions may differ there by more than any fixed
    tolerance).  Returns the metrics."""
    m = planes_metrics(torch, frames, nfft, got, want, sample_rate, n_mels)
    check(m["share"] > 0.5, f"{name}: too few well-conditioned cells ({m['share']})")
    check(m["scaled"] <= 1e-5, f"{name}: scaled error {m['scaled']} > 1e-5")
    for label, key in (("kernel", "head"), ("plain", "plain_head")):
        check(m[key] <= 1.0, f"{name}: {label} off the float64 planes by {m[key]:.3g} x "
                             "the fp32 error bound")
    return m


def float64_text(m) -> str:
    """The float64 side of ``planes_metrics``, for a log line."""
    return (f"against float64: kernel scaled {m['scaled64']:.3g}, {m['head']:.4g} of its "
            f"fp32 error bound; plain {m['plain_scaled64']:.3g}, {m['plain_head']:.4g}")


def check_terminals(torch, got, ref, name):
    """DTW terminals: bitwise where the plain version is finite, both
    > 1e38 (unreachable) elsewhere."""
    finite = ref < 1e37
    check(bool(finite.any()), f"{name}: no reachable terminal")
    check(bool(torch.equal(got[finite], ref[finite])), f"{name}: finite terminals not bitwise")
    check(bool((got[~finite] > 1e38).all()), f"{name}: unreachable terminals differ")
    return int((~finite).sum())


def band_cells(torch, length, m, lens, band) -> int:
    """In-band DTW cells before each pair's seg_len: the cost cells the
    recurrence reads (the integer band test of ops/dtw_kernel.py)."""
    dev = lens.device
    i = torch.arange(length, device=dev)[None, :, None]
    j = torch.arange(m, device=dev)[None, None, :]
    ln = lens.long()[:, None, None]
    lm1 = max(length - 1, 1)
    return int(((j < ln) & ((j * lm1 - i * (ln - 1).clamp(min=1)).abs()
                            <= band * lm1)).sum())


def match_detections(got, want):
    """Peaks of two scans matched on (utterance, time) -> (matched share
    of the larger set, same-template share of the matched, max |score
    difference| over same-template matches, max |score| of ``want``)."""
    matched = same = 0
    diff = 0.0
    for ui in np.unique(np.concatenate([got.utterance_ids, want.utterance_ids])):
        a = {t: (k, s) for s, t, k in zip(got.scores[got.utterance_ids == ui].tolist(),
                                          got.times[got.utterance_ids == ui].tolist(),
                                          got.template_ids[got.utterance_ids == ui].tolist())}
        b = {t: (k, s) for s, t, k in zip(want.scores[want.utterance_ids == ui].tolist(),
                                          want.times[want.utterance_ids == ui].tolist(),
                                          want.template_ids[want.utterance_ids == ui].tolist())}
        for t in set(a) & set(b):
            matched += 1
            if a[t][0] == b[t][0]:
                same += 1
                diff = max(diff, abs(a[t][1] - b[t][1]))
    frac = matched / max(len(got.scores), len(want.scores), 1)
    return frac, same / max(matched, 1), diff, float(np.max(np.abs(want.scores)))


def correlation_bench(torch, kc, flat, wflat, cf, record, say):
    """Kernel 10 at the reference's bench shape (bench.py: B = 8 maps of
    T = 3000 frames, K = 1024, L = 32, D = 2048, bf16): the scan's
    frontend maps cut to T frames (their real sparsity), the random
    bank's flat LLR filter.  Held against the plain f32 version on the
    same bf16 operands within 1e-5 x max|score|: both sum the same exact
    products (binary x bf16) in float32, in different orders.  Returns
    the bf16 maps [B, T, D]."""
    b, d = flat.shape[0], flat.shape[2]
    x = flat[:, :T_BENCH].to(torch.bfloat16).contiguous()
    w16 = wflat.to(torch.bfloat16).contiguous()
    k, length = w16.shape[0], w16.shape[1]
    tv = T_BENCH - length + 1
    got = kc.correlation_scores(x, w16, cf)
    want, plain_ms = time_once(torch, lambda: kc.correlation_scores_plain(x, w16, cf))
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    check(bool(torch.isfinite(got).all()), "correlation: scores not finite")
    check(err <= 1e-5 * top, f"correlation: {err} > 1e-5 * {top}")
    del got, want
    xt = x.transpose(1, 2).contiguous()                          # conv1d's [B, D, T]
    wt = w16.transpose(1, 2).contiguous()                        # [K, D, L]
    record(
        kc, err, "1e-5 * max|plain|",
        time_ms(torch, lambda: kc.correlation_scores(x, w16, cf)),
        plain_ms,
        time_ms(torch, lambda: torch.nn.functional.conv1d(xt, wt)),   # bf16 out
        x.numel() * 2 + w16.numel() * 2 + k * 4 + b * k * tv * 4,
        2 * b * k * tv * length * d, BF16_FLOPS,
    )
    say(f"correlation at the bench shape (B {b}, T {T_BENCH}, K {k}, L {length}, D {d}; "
        f"{float(x.float().mean()):.4f} of the map set): max|score| {top:.6g}; plain "
        "timed once")
    return x


def small_shape_checks(torch, dev, audio, k1, k2, k3, k4, k5, kp, kd, k8, k9, kc, fp, fs,
                       say):
    """Each kernel once at small ragged shapes (the CPU tests' sizes:
    nfft 256 -> F = 128, D = 1024, K = 128, L = 8 -> nfft 39, hop 32;
    the log-mel widths F = 39 and 63, D = 504), against its plain
    version on the same inputs."""
    from template_speech_recognition_tpu_torch.ops.edges import order_keys32

    rng = np.random.default_rng(SEED + 1)
    frames = torch.from_numpy(
        rng.standard_normal((4 * 128, 400)).astype(np.float32)).to(dev)
    check_planes(torch, frames, 256, k1.edge_response_planes(frames, 256),
                 k1.edge_response_planes_plain(frames, 256), "frontend_planes (small)")

    planes = rng.standard_normal((4, 4, 256, 128)).astype(np.float32)
    planes[:, :, :85] = np.round(planes[:, :, :85] * 4) / 4     # ties
    planes[:, :, 5, :7] = -0.0
    planes = torch.from_numpy(planes).to(dev)
    valid = torch.tensor([256, 128, 7, 0], dtype=torch.int32, device=dev)
    for q, rf, rt in ((0.98, 1, 1), (0.3, 2, 0)):
        need = fp._dual_ranks(valid, 128, q)
        fk, kk = k2.select_binspread(planes, need, valid, rf, rt)
        fr, kr = k2.select_binspread_plain(planes, need, valid, rf, rt)
        check(bool(torch.equal(fk, fr)) and bool(torch.equal(kk, kr)),
              f"select_binspread (small, q={q}): not bitwise")

    b, t, d, k, nfft, hop = 2, 250, 1024, 128, 39, 32
    nblk = -(-(t - 8 + 1) // hop)
    x = torch.from_numpy(rng.random((b, t, d)) < 0.15).to(dev, torch.bfloat16)
    cm, sm = fs._dft_mats(nfft, torch.bfloat16, dev)
    g = torch.cat([cm, -sm], dim=1).contiguous()
    tol = 2.0 ** -7

    def close(a, r, rel, name):
        err = float((a.float() - r.float()).abs().max())
        check(err <= rel * float(r.float().abs().max()), f"{name} (small): {err}")

    for a, r in zip(k3.fft_block_dft(x, g, nfft, hop, nblk),
                    k3.fft_block_dft_plain(x, g, nfft, hop, nblk)):
        close(a, r, tol, "fft_block_dft")
    bins, m = nfft // 2 + 1, b * nblk
    xr = torch.randn(bins, b, nblk, d, device=dev).to(torch.bfloat16)
    xi = torch.randn(bins, b, nblk, d, device=dev).to(torch.bfloat16)
    w2 = torch.randn(bins, 2 * d, k, device=dev).to(torch.bfloat16)
    close(k4.fft_binmm(xr, xi, w2), k4.fft_binmm_plain(xr, xi, w2), tol, "fft_binmm")

    # the TMA + wgmma bin matmul at ragged shapes: m around the 64-row
    # slab and the tail batch's 96, D short of or past a 64-wide k tile
    # (8, 40, 504), K short of a 256-wide tile, one and three bins (rows
    # past m must read zeros, not the next bin); the 4-D [bins, B, nblk,
    # D] input; a base pointer 2 bytes off, which TMA cannot take
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)

    for nb in (1, 3):
        for mm in (1, 63, 64, 65, 96):
            for dd in (8, 40, 504):
                for kk in (8, 136):
                    a_r, a_i, w_s = rnd(nb, mm, dd), rnd(nb, mm, dd), rnd(nb, 2 * dd, kk)
                    close(k4.fft_binmm(a_r, a_i, w_s), k4.fft_binmm_plain(a_r, a_i, w_s), tol,
                          f"fft_binmm (bins={nb}, m={mm}, D={dd}, K={kk})")
    a_r, a_i, w_s = rnd(3, 3, 32, 504), rnd(3, 3, 32, 504), rnd(3, 1008, 136)
    close(k4.fft_binmm(a_r, a_i, w_s), k4.fft_binmm_plain(a_r, a_i, w_s), tol,
          "fft_binmm (4-D input, B=3)")
    off = rnd(3 * 96 * 40 + 8)[1 : 1 + 3 * 96 * 40].view(3, 96, 40)
    check(off.data_ptr() % 16 == 2, "the misaligned view is not misaligned")
    try:
        k4.fft_binmm(off, rnd(3, 96, 40), rnd(3, 80, 136))
        check(False, "fft_binmm took a base pointer that is not 16-byte aligned")
    except ValueError:
        pass
    ycat = torch.randn(2 * bins, m * k, device=dev).to(torch.bfloat16)
    icm, ism = fs._idft_mats(nfft, hop, torch.bfloat16, dev)
    imat = torch.cat([icm, -ism], dim=0).contiguous()
    c = torch.randn(k, device=dev)
    close(k5.fft_idft(ycat, imat, c, nblk), k5.fft_idft_plain(ycat, imat, c, nblk),
          1e-5, "fft_idft")

    # int8 bin matmul, bitwise: K, 2m and 2D not multiples of the tile
    for shape in ((3, 50, 48), (3, 2, 25, 48)):
        xq_r = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        xq_i = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        w28 = torch.randint(-127, 128, (3, 96, 132), dtype=torch.int8, device=dev)
        sc8 = torch.rand(3, 132, device=dev) * 1e-3
        check(bool(torch.equal(k4.fft_binmm_int8(xq_r, xq_i, w28, sc8),
                               k4.fft_binmm_int8_plain(xq_r, xq_i, w28, sc8))),
              f"fft_binmm_int8 (small, {shape}): not bitwise")

    # ... and at the log-mel width D = 504 (rows only 8-byte aligned)
    for shape in ((3, 50, 504), (3, 2, 25, 504)):
        xq_r = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        xq_i = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        w28 = torch.randint(-127, 128, (3, 1008, 132), dtype=torch.int8, device=dev)
        sc8 = torch.rand(3, 132, device=dev) * 1e-3
        check(bool(torch.equal(k4.fft_binmm_int8(xq_r, xq_i, w28, sc8),
                               k4.fft_binmm_int8_plain(xq_r, xq_i, w28, sc8))),
              f"fft_binmm_int8 (small, {shape}): not bitwise")

    # kernel 1, log-mel mode: F = 39, 63 and 128 (n_mels 129), over a row
    # count that is not a multiple of the 32-row tile; and a DFT width
    # that is not a multiple of 32 (nfft 400 -> 200 columns).  Windowed
    # audio frames: white noise puts deep cancellations into single DFT
    # bins, which the few-bin low mel filters pass on to the log.
    fr = audio[1000 : 1000 + 4 * 128 - 11]
    worst = {}
    for nfft_s, nm in ((512, 40), (512, 64), (512, 129), (400, 0)):
        m = check_planes(torch, fr, nfft_s, k1.edge_response_planes(fr, nfft_s, 16000, nm),
                         k1.edge_response_planes_plain(fr, nfft_s, 16000, nm),
                         f"frontend_planes (small, nfft {nfft_s}, n_mels {nm})", 16000, nm)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in m.items()}
    say(f"frontend_planes at 4 small shapes: scaled error at most {worst['scaled']:.3g} "
        f"(tolerance 1e-5); {float64_text(worst)}")

    # radix counting pass: ragged rows (N % 4 != 0: unaligned, key by
    # key), NC 3, 8, 16, masked keys, candidates in the digit's range
    for n, nc, shift in ((2500, 16, 29), (2501, 3, 0), (9000, 8, 24), (7, 16, 5)):
        keys = order_keys32(torch.randn(5, n, device=dev))
        keys[:, ::7] = -1
        cand = rng.integers(0, 1 << (32 - shift), (5, nc), dtype=np.uint64)
        cand = torch.from_numpy(cand.astype(np.uint32).view(np.int32)).to(dev)
        check(bool(torch.equal(k8.radix_level_counts(keys, cand, shift),
                               k8.radix_level_counts_plain(keys, cand, shift))),
              f"radix_counts (small, N={n}, NC={nc}, shift={shift}): not bitwise")

    # order statistics and binarize + spread at F = 39 and 63, T not a
    # multiple of the 32-row tile, an utterance with no valid row, a
    # strided [B, P] view of plane-major planes, rf 0, 1 and 2
    for f_s, t_s, rf, rt in ((39, 250, 0, 0), (63, 250, 2, 1), (63, 77, 1, 1)):
        x = rng.standard_normal((4, 3, t_s, f_s)).astype(np.float32)
        x[:, :, : t_s // 3] = np.round(x[:, :, : t_s // 3] * 4) / 4
        x[:, :, 5, :7] = -0.0
        pl = torch.from_numpy(x).to(dev).transpose(0, 1)              # [B, P, T, F]
        vs = torch.tensor([t_s, t_s // 3, 0], dtype=torch.int32, device=dev)
        hi, lo = fp.plane_order_statistics(pl, vs, 0.9)
        hi_r, lo_r = fp.plane_order_statistics(pl, vs, 0.9, plain=True)
        check(bool(torch.equal(hi.view(torch.int32), hi_r.view(torch.int32)))
              and bool(torch.equal(lo.view(torch.int32), lo_r.view(torch.int32))),
              f"plane_order_statistics (small, F={f_s}): not bitwise")
        args9 = (pl, hi.contiguous(), lo.contiguous(), vs, rf)
        check(bool(torch.equal(k9.binarize_freqspread(*args9),
                               k9.binarize_freqspread_plain(*args9))),
              f"binspread (small, F={f_s}, T={t_s}, rf={rf}): not bitwise")
        check(bool(torch.equal(
            fp.binarize_spread_flat(pl, hi, lo, vs, rt, rf),
            fp.binarize_spread_flat(pl, hi, lo, vs, rt, rf, plain=True))),
            f"binarize_spread_flat (small, F={f_s}): not bitwise")

    # pair LLR: windows into the next utterance and past the map's end,
    # L and m not multiples of the 32 x 40 output tile; D = 504 leaves
    # the last 32-wide contraction chunk a quarter empty
    for bb, tt, dd, kk, length, mm in ((2, 50, 64, 5, 6, 16), (3, 40, 96, 4, 40, 48),
                                       (2, 40, 504, 4, 32, 40)):
        fmap = torch.from_numpy(rng.random((bb, tt, dd)) < 0.3).to(dev)
        wq = torch.randn(kk, length, dd, device=dev).to(torch.bfloat16)
        rs = torch.tensor([0, 3, tt - 4, tt + 5, bb * tt - 9, bb * tt - 2, bb * tt - 1],
                          dtype=torch.int32, device=dev)
        ids = torch.tensor([0, kk - 1, 1, 2, 3, 0, 1], dtype=torch.int32, device=dev) % kk
        close(kp.pair_llr(fmap, wq, rs, ids, mm), kp.pair_llr_plain(fmap, wq, rs, ids, mm),
              1e-5, f"pair_llr (L={length}, m={mm})")

    # direct correlation: T not a multiple of the 128-row tile, K = 3
    # and 129, D = 40, 504 and 2048, L = 1, 9, 32, 48 and L = T, B = 1,
    # and an all-zero utterance, whose scores are c exactly
    for bb, tt, dd, kk, length in ((1, 77, 40, 3, 9), (2, 300, 504, 5, 48),
                                   (3, 130, 504, 130, 1), (1, 48, 16, 7, 48),
                                   (2, 257, 2048, 129, 32)):
        xc = torch.from_numpy(rng.random((bb, tt, dd)) < 0.2).to(dev, torch.bfloat16)
        if bb > 1:
            xc[-1] = 0
        wc = torch.randn(kk, length, dd, device=dev).to(torch.bfloat16)
        cc = torch.randn(kk, device=dev)
        got = kc.correlation_scores(xc, wc, cc)
        close(got, kc.correlation_scores_plain(xc, wc, cc), 1e-5,
              f"correlation (B={bb}, T={tt}, D={dd}, K={kk}, L={length})")
        if bb > 1:
            check(bool(torch.equal(got[-1], cc[:, None].expand(kk, tt - length + 1))),
                  "correlation: an all-zero utterance does not score c")

    # banded DTW: the TPU's packed (L 32), band (L 96) and full (L 128)
    # regimes, and L 48 and 200 (2 and 8 rows a lane); ragged seg_lens
    # from 1 to M, pair counts that are not multiples of a block; band 1
    # leaves terminals unreachable
    for length, m, band, n in ((32, 40, 6, 37), (32, 40, 1, 37), (48, 56, 6, 21),
                               (96, 104, 6, 19), (128, 136, 64, 13), (200, 40, 3, 5)):
        cost = torch.from_numpy(
            (rng.standard_normal((n, length, m)) + 2.0).astype(np.float32)).to(dev)
        lens_np = rng.integers(1, m + 1, n).astype(np.int32)
        lens_np[0], lens_np[1], lens_np[-1] = 1, m + 5, m     # m + 5: no terminal cell
        lens = torch.from_numpy(lens_np).to(dev)
        check_terminals(torch, kd.banded_dtw(cost, lens, band),
                        kd.banded_dtw_plain(cost, lens, band),
                        f"banded_dtw (small, L={length}, band={band})")


def take_launches(rows, names, counts, shape=None):
    """Each listed kernel's row (only the row of ``shape``, if given)
    takes its launch count from this run."""
    for row in rows:
        if row["name"] in names and (shape is None or row.get("shape") == shape):
            row["launches"] = int(counts.get(row["name"], 0))


def mel_kernel_checks(torch, M, dev, wavs, nvalid, valid, frames2, bank_mel, record, say):
    """The log-mel scan's kernels at its shapes (B = 8, T_pad = 3072,
    n_mels 64 -> F = 63, D = 504), each against its plain version."""
    C, fp, fs, k1, k3, k4, kp, k8, k9 = (M.C, M.fp, M.fs, M.k1, M.k3, M.k4, M.kp, M.k8,
                                          M.k9)
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices, mel_filterbank
    from template_speech_recognition_tpu_torch.ops.edges import key_to_float, order_keys32
    from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat
    from template_speech_recognition_tpu_torch.ops.radix_kernel import as_uint32, to_bits32

    mcfg = C.FrontendConfig(use_mel=True)
    nfft, sr, nm, f = mcfg.nfft, mcfg.sample_rate, mcfg.n_mels, mcfg.feature_freqs
    check(f == 63 and not fp._fused_ok(mcfg), "n_mels 64 must take the layered path")
    check(fp._fused_ok(C.FrontendConfig(use_mel=True, n_mels=129)),
          "n_mels 129 must take the two-kernel path")
    n_rows, fl = frames2.shape
    t_pad = n_rows // B
    bins = nfft // 2 + 1
    cos_m, sin_m = dft_matrices(fl, nfft, dev)
    cs = torch.cat([cos_m, sin_m], dim=1).contiguous()
    pw = torch.rand(n_rows, bins, device=dev)

    # kernel 1, log-mel mode: TPU row 7 (the layered path's four-output
    # kernel); row 1's mel mode is the same launch, timed at n_mels 129
    def planes_row(n_mels):
        got = k1.edge_response_planes(frames2, nfft, sr, n_mels)
        ref = k1.edge_response_planes_plain(frames2, nfft, sr, n_mels)
        m = check_planes(torch, frames2, nfft, got, ref, f"frontend_planes (n_mels {n_mels})",
                         sr, n_mels)
        fb = mel_filterbank(sr, nfft, n_mels, dev)
        _fbt, mr = k1._mel_on(sr, nfft, n_mels, str(dev))
        nnz = int((mr[:, 1] - mr[:, 0]).sum())
        times = (
            time_ms(torch, lambda: k1.edge_response_planes(frames2, nfft, sr, n_mels)),
            time_ms(torch, lambda: k1.edge_response_planes_plain(frames2, nfft, sr, n_mels)),
            time_ms(torch, lambda: (torch.matmul(frames2, cs), torch.matmul(pw, fb))),
        )
        nbytes = (n_rows * fl * 4 + 2 * fl * bins * 4 + fb.numel() * 4
                  + 4 * n_rows * (n_mels - 1) * 4)
        ops = 2 * 2 * n_rows * fl * bins + 2 * n_rows * nnz
        say(f"frontend_planes (n_mels {n_mels}): scaled error {m['scaled']:.3g} on "
            f"{m['share']:.3f} of the cells (tolerance 1e-5); {float64_text(m)}; the mel "
            f"product over {nnz} nonzero filter weights of {fb.numel()}")
        return got, m["err"], times, nbytes, ops

    pm, err7, times7, bytes7, ops7 = planes_row(nm)
    record(SimpleNamespace(NAME=k1.MEL_NAME, SOURCE=k1.SOURCE, REPLACES=k1.MEL_REPLACES),
           err7, "scaled 1e-5; fp32 error bound", *times7, bytes7, ops7, FP32_FLOPS, tf32=True)
    _p129, err1, times1, bytes1, ops1 = planes_row(129)
    b1, by1 = bound_ms(bytes1, ops1, FP32_FLOPS)
    bt1, byt1 = bound_ms(bytes1, 3 * ops1, TF32_FLOPS)
    say(f"frontend_planes mel mode at n_mels 129 (TPU row 1's mel mode; the two-kernel "
        f"path): max_abs_err {err1:.6g} kernel {times1[0]:.4f} ms plain {times1[1]:.4f} ms "
        f"library {times1[2]:.4f} ms bound {b1:.4f} ms ({by1}; three TF32 passes "
        f"{bt1:.4f} ms, {byt1})")
    del _p129

    # kernel 8 at every level's real candidates: the layered select of
    # plane_order_statistics, one launch per level, each bitwise
    planes = pm.reshape(4, B, t_pad, f).transpose(0, 1)            # [B, 4, T, F] view
    q = mcfg.edge_quantile
    rv = torch.arange(t_pad, device=dev)[None, :] < valid[:, None]
    keys = order_keys32(planes.transpose(0, 1)).masked_fill(~rv[None, :, :, None], -1)
    keys = keys.reshape(4 * B, t_pad * f)
    need = fp._dual_ranks(valid, f, q).to(torch.int64)[None, :, :, None]
    prefix = torch.zeros((4, B, 2), dtype=torch.int64, device=dev)
    bits_done, levels = 0, []
    for w in fp.RADIX_WIDTHS:
        bits_done += w
        base = prefix << w
        cand = to_bits32((base[..., None] + torch.arange(1 << w, device=dev)).reshape(4 * B, -1))
        shift = 32 - bits_done
        cnt = k8.radix_level_counts(keys, cand, shift)
        check(bool(torch.equal(cnt, k8.radix_level_counts_plain(keys, cand, shift))),
              f"radix_counts (level shift {shift}): not bitwise")
        levels.append((cand, shift))
        # the reference's digit pick: the first candidate reaching the rank
        ok = (cnt.reshape(4, B, 2, 1 << w) >= need).to(torch.int32)
        prefix = base + torch.argmax(ok, dim=-1)
    os_hi, os_lo = fp.plane_order_statistics(planes, valid, q)
    hi_r, lo_r = fp.plane_order_statistics(planes, valid, q, plain=True)
    sel = key_to_float(prefix).transpose(0, 1)                      # [B, 4, 2]
    check(bool(torch.equal(os_hi.view(torch.int32), sel[..., 0].view(torch.int32)))
          and bool(torch.equal(os_lo.view(torch.int32), sel[..., 1].view(torch.int32))),
          "plane_order_statistics does not select what its launches count")
    check(bool(torch.equal(os_hi.view(torch.int32), hi_r.view(torch.int32)))
          and bool(torch.equal(os_lo.view(torch.int32), lo_r.view(torch.int32))),
          "plane_order_statistics: kernel and plain selects differ")
    # timed at the second level's real candidates (NC = 16, as every
    # level after the first)
    cand2, shift2 = levels[1]
    keys64 = as_uint32(keys)
    check(bool((valid == valid[0]).all()), "the timed batch has one valid length")
    ka, kb = int(need[0, 0, 0, 0]), int(need[0, 0, 1, 0])
    record(
        k8, 0.0, "bitwise",
        time_ms(torch, lambda: k8.radix_level_counts(keys, cand2, shift2), loop=100),
        time_ms(torch, lambda: k8.radix_level_counts_plain(keys, cand2, shift2)),
        # the yardstick stands for the whole 11-launch select (both ranks)
        time_ms(torch, lambda: (torch.kthvalue(keys64, ka, dim=1),
                                torch.kthvalue(keys64, kb, dim=1))),
        keys.numel() * 4 + cand2.numel() * 8,
        keys.numel() * cand2.shape[1], FP32_FLOPS,      # one 32-bit compare a key a candidate
    )
    sel_ms = time_ms(torch, lambda: fp.plane_order_statistics(planes, valid, q))
    say(f"radix_counts: {keys.shape[0]} rows x {keys.shape[1]} keys, {len(fp.RADIX_WIDTHS)} "
        f"launches a select, every level bitwise; the whole layered select "
        f"(plane_order_statistics: keys, 11 launches, digit picks) {sel_ms:.4f} ms; host "
        f"{host_us(torch, lambda: k8.radix_level_counts(keys, cand2, shift2)):.1f} us a launch")
    del keys, keys64

    # kernel 9 on the kernel-1 planes (a strided [B, P] view) with the
    # selected statistics; bitwise
    args9 = (planes, os_hi.contiguous(), os_lo.contiguous(), valid, mcfg.spread_freq)
    m9 = k9.binarize_freqspread(*args9)
    check(bool(torch.equal(m9, k9.binarize_freqspread_plain(*args9))), "binspread: not bitwise")
    record(
        k9, 0.0, "bitwise",
        time_ms(torch, lambda: k9.binarize_freqspread(*args9), loop=100),
        time_ms(torch, lambda: k9.binarize_freqspread_plain(*args9)),
        None,      # no single PyTorch call binarizes and dilates
        # only rows below valid are read; the whole map is written
        4 * int(valid.sum()) * f * 4 + m9.numel() + 2 * os_hi.numel() * 4 + B * 4,
        0, 1.0,
    )
    del m9, pm, planes

    # the layered path against the two-kernel path at the default
    # scan's shape (F = 256): bitwise
    dcfg = C.FrontendConfig()
    lay = fp.frontend_batch_flat(wavs, nvalid, dcfg, layered=True)
    fus = fp.frontend_batch_flat(wavs, nvalid, dcfg, layered=False)
    check(bool(torch.equal(lay.binary, fus.binary)), "layered and fused maps differ")
    ms_lay = time_ms(torch, lambda: fp.frontend_batch_flat(wavs, nvalid, dcfg, layered=True))
    ms_fus = time_ms(torch, lambda: fp.frontend_batch_flat(wavs, nvalid, dcfg, layered=False))
    say(f"layered == two-kernel frontend at the default shape: bitwise "
        f"({int(lay.binary.sum())} set cells); layered {ms_lay:.4f} ms, two-kernel "
        f"{ms_fus:.4f} ms a batch")
    del lay, fus

    # pair LLR and the int8 bin matmul at D = 504 on the log-mel map
    fm = fp.frontend_batch_flat(wavs, nvalid, mcfg)
    d = 8 * f
    check(tuple(fm.binary.shape) == (B, t_pad, d), f"mel map {tuple(fm.binary.shape)}")
    w_rows, _c_rows = bank_mel.llr_rows()
    w16 = filters_to_flat(w_rows).to(torch.bfloat16).contiguous()          # [K, L, 504]
    rng = np.random.default_rng(SEED + 2)
    top_k, m_llr = 123, 40
    times = torch.from_numpy(rng.integers(0, int(valid.min()), (B, top_k))).to(dev)
    ids = torch.from_numpy(rng.integers(0, K, B * top_k).astype(np.int32)).to(dev)
    rowstart = (torch.arange(B, device=dev)[:, None] * t_pad + times).reshape(-1)
    args_p = (fm.binary, w16, rowstart.to(torch.int32), ids, m_llr)
    llr = kp.pair_llr(*args_p)
    llr_ref = kp.pair_llr_plain(*args_p)
    err_p = float((llr - llr_ref).abs().max())
    ref_p = float(llr_ref.abs().max())
    check(err_p <= 1e-5 * ref_p, f"pair_llr (D=504): {err_p} > 1e-5 * {ref_p}")
    ms_p = time_ms(torch, lambda: kp.pair_llr(*args_p), loop=100)
    wf_m, cf_m = bank_mel.llr()
    fbank8 = fs.build_fft_bank(filters_to_flat(wf_m), cf_m, mm_dtype=torch.int8)
    nfft_s, length = fbank8.nfft, fbank8.length
    hop = nfft_s - length + 1
    nblk = -(-(t_pad - length + 1) // hop)
    cmat, smat = fs._dft_mats(nfft_s, torch.bfloat16, dev)
    g = torch.cat([cmat, -smat], dim=1).contiguous()
    xr, xi = k3.fft_block_dft(fm.binary.to(torch.bfloat16), g, nfft_s, hop, nblk)
    xq_r, xq_i, sc8 = fs.quantize_block_spectra(xr, xi, fbank8.w2_scale)
    y8 = k4.fft_binmm_int8(xq_r, xq_i, fbank8.w2, sc8)
    check(bool(torch.equal(y8, k4.fft_binmm_int8_plain(xq_r, xq_i, fbank8.w2, sc8))),
          "fft_binmm_int8 (D=504): not bitwise")
    ms_8 = time_ms(torch, lambda: k4.fft_binmm_int8(xq_r, xq_i, fbank8.w2, sc8))
    m = B * nblk

    # the bf16 bin matmul at D = 504 on the log-mel scan's own block
    # spectra and bf16 bank: the last k tile of each half is partial
    # (504 = 7 x 64 + 56) and TMA's zero fill completes it
    bins_m = nfft_s // 2 + 1
    fbank16 = fs.build_fft_bank(filters_to_flat(wf_m), cf_m, mm_dtype=torch.bfloat16)
    check(tuple(fbank16.w2.shape) == (bins_m, 2 * d, K) and m == 192,
          f"log-mel bin matmul shape {tuple(fbank16.w2.shape)}, m {m}")
    y4 = k4.fft_binmm(xr, xi, fbank16.w2)
    y4_ref = k4.fft_binmm_plain(xr, xi, fbank16.w2)
    err4 = float((y4.float() - y4_ref.float()).abs().max())
    ref4 = float(y4_ref.float().abs().max())
    check(err4 <= 2.0 ** -7 * ref4, f"fft_binmm (D=504): {err4} > 2^-7 * {ref4}")
    xr3, xi3 = xr.reshape(bins_m, m, d), xi.reshape(bins_m, m, d)
    x2 = torch.cat([torch.cat([xr3, xi3], 2), torch.cat([xi3, -xr3], 2)], 1)
    record(
        k4, err4, "2^-7 * max|ref|",
        time_ms(torch, lambda: k4.fft_binmm(xr, xi, fbank16.w2)),
        time_ms(torch, lambda: k4.fft_binmm_plain(xr, xi, fbank16.w2)),
        time_ms(torch, lambda: torch.bmm(x2, fbank16.w2)),
        2 * bins_m * m * d * 2 + fbank16.w2.numel() * 2 + 2 * bins_m * m * K * 2,
        2 * (2 * m) * (2 * d) * K * bins_m, BF16_FLOPS, shape=BINMM_MEL,
    )
    del y4, y4_ref, x2, fbank16
    b8, _ = bound_ms(2 * (nfft_s // 2 + 1) * m * d + fbank8.w2.numel() + sc8.numel() * 4
                     + 2 * (nfft_s // 2 + 1) * m * K * 2,
                     2 * (2 * m) * (2 * d) * K * (nfft_s // 2 + 1), INT8_OPS)
    say(f"at D = 504: pair_llr max error {err_p:.3g} (1e-5 x {ref_p:.4g} allowed) "
        f"{ms_p:.4f} ms (100 launches); fft_binmm_int8 bitwise {ms_8:.4f} ms (bound "
        f"{b8:.4f} ms)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import template_speech_recognition_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.convert import bank_from_numpy
    from template_speech_recognition_tpu_torch.detect import fft_scorer as fs
    from template_speech_recognition_tpu_torch.detect import scorer as ts
    from template_speech_recognition_tpu_torch.detect.nms import top_detections
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import (
        dtw_kernel as kd,
        fft_binmm_kernel as k4,
        fft_dft_kernel as k3,
        fft_idft_kernel as k5,
        frontend_kernel as k1,
        binspread_kernel as k9,
        correlation_kernel as kc,
        pair_llr_kernel as kp,
        radix_kernel as k8,
        selbin_kernel as k2,
    )
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices
    from template_speech_recognition_tpu_torch.ops.layout import (
        filters_to_flat,
        flat_to_channels,
    )
    from template_speech_recognition_tpu_torch.pipeline import (
        _detect_corpus_loop,
        detect_corpus,
        dtw_rescore_detections,
    )
    from template_speech_recognition_tpu_torch.scan import (
        bucket_length,
        detect_corpus_stream,
    )

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _cuda.build(STEMS)
    say(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                say(f"ptxas {stem}: {line.strip()}")

    # ---- inputs at the scan's shapes ------------------------------------
    cfg = C.PipelineConfig()
    fcfg = cfg.frontend
    corpus = Corpus(SEED)
    rng = np.random.default_rng(SEED)
    templates = rng.uniform(0.01, 0.99, (K, L, fcfg.feature_freqs, 8)).astype(np.float32)
    background = rng.uniform(0.01, 0.99, (fcfg.feature_freqs, 8)).astype(np.float32)
    bank = bank_from_numpy(templates, background, [f"k{i}" for i in range(K)], dev)
    wf, cf = bank.llr()
    fbank = fs.build_fft_bank(filters_to_flat(wf), cf, mm_dtype=torch.bfloat16)
    fbank32 = fs.build_fft_bank(filters_to_flat(wf), cf, mm_dtype=torch.float32)
    check(fbank.nfft == fs.pick_nfft(L, K) == 159, f"nfft {fbank.nfft}")

    pad = bucket_length(int(SECONDS * corpus.sample_rate))
    wavs = torch.zeros((B, pad), dtype=torch.float32)
    for i, (_u, w, _p) in enumerate(corpus.utts[:B]):
        wavs[i, : len(w)] = torch.from_numpy(w)
    wavs = wavs.to(dev)
    nvalid = torch.full((B,), int(SECONDS * corpus.sample_rate), dtype=torch.int32,
                        device=dev)
    frames = fp._windowed_frames(wavs, fcfg)
    t = frames.shape[1]
    t_pad = ((t + 127) // 128) * 128
    check(t_pad == 3072, f"T_pad {t_pad}")
    fpad = torch.zeros((B, t_pad, fcfg.frame_length), device=dev)
    fpad[:, :t] = frames
    frames2 = fpad.reshape(B * t_pad, fcfg.frame_length).contiguous()
    valid = torch.where(
        nvalid >= fcfg.frame_length,
        torch.div(nvalid - fcfg.frame_length, fcfg.hop_length, rounding_mode="floor"),
        torch.zeros_like(nvalid),
    ).to(torch.int32)
    f = fcfg.feature_freqs
    n_rows, fl = frames2.shape
    d = 8 * f
    nfft, length = fbank.nfft, fbank.length
    hop, bins = nfft - length + 1, nfft // 2 + 1
    nblk = -(-(t_pad - length + 1) // hop)
    m = B * nblk
    rows = []

    def record(mod, err, tol, ms, plain_ms, lib_ms, nbytes, ops, rate, shape=None, tf32=False):
        """One row of the kernels line.  ``tf32``: the kernel runs the
        fp32 ``ops`` as three TF32 passes on the tensor cores; the row
        also gives that bound (``tf32_bound_ms``), beside the fp32 one."""
        bms, by = bound_ms(nbytes, ops, rate)
        rows.append(dict(
            name=mod.NAME, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
            launches=0, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
        ))
        extra = ""
        if tf32:
            rows[-1]["tf32_bound_ms"], tby = bound_ms(nbytes, 3 * ops, TF32_FLOPS)
            extra = f"; three TF32 passes {rows[-1]['tf32_bound_ms']:.4f} ms, {tby}"
        if shape is not None:
            rows[-1]["shape"] = shape
        say(f"{mod.NAME}{f' ({shape})' if shape else ''}: max_abs_err {err:.6g} "
            f"(tolerance {tol}) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms library {lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"ms bound {bms:.4f} ms ({by}{extra})")

    # kernel 1: response planes (tolerances: check_planes)
    planes = k1.edge_response_planes(frames2, fcfg.nfft)
    planes_ref = k1.edge_response_planes_plain(frames2, fcfg.nfft)
    m1 = check_planes(torch, frames2, fcfg.nfft, planes, planes_ref, "frontend_planes")
    err1 = m1["err"]
    say(f"frontend_planes: scaled error {m1['scaled']:.3g} on {m1['share']:.3f} of the cells "
        f"(tolerance 1e-5); {float64_text(m1)}")
    cos_m, sin_m = dft_matrices(fl, fcfg.nfft, dev)
    cs = torch.cat([cos_m, sin_m], dim=1).contiguous()
    record(
        k1, err1, "scaled 1e-5; fp32 error bound",
        time_ms(torch, lambda: k1.edge_response_planes(frames2, fcfg.nfft)),
        time_ms(torch, lambda: k1.edge_response_planes_plain(frames2, fcfg.nfft)),
        time_ms(torch, lambda: torch.matmul(frames2, cs)),
        n_rows * fl * 4 + 2 * fl * (f + 1) * 4 + 4 * n_rows * f * 4,
        2 * 2 * n_rows * fl * (f + 1), FP32_FLOPS, tf32=True,
    )

    # kernel 2: select + binarize + spread; bitwise
    planes4 = planes.reshape(4, B, t_pad, f)
    need = fp._dual_ranks(valid, f, fcfg.edge_quantile)
    args2 = (planes4, need, valid, fcfg.spread_freq, fcfg.spread_time)
    flat, keys = k2.select_binspread(*args2)
    flat_ref, keys_ref = k2.select_binspread_plain(*args2)
    torch.cuda.synchronize()
    n_bad = int((flat != flat_ref).sum()) + int((keys != keys_ref).sum())
    check(n_bad == 0, f"select_binspread: {n_bad} cells or keys differ (bitwise)")
    kth = int(need[0, 0])
    pv = planes4.permute(1, 0, 2, 3).reshape(B * 4, t_pad * f)
    record(
        k2, 0.0, "bitwise",
        time_ms(torch, lambda: k2.select_binspread(*args2)),
        time_ms(torch, lambda: k2.select_binspread_plain(*args2)),
        time_ms(torch, lambda: torch.kthvalue(pv, kth, dim=1)),
        # only rows below valid are read; the whole map is written
        4 * int(valid.sum()) * f * 4 + B * t_pad * 8 * f + need.numel() * 4
        + valid.numel() * 4 + keys.numel() * 4,
        0, 1.0,
    )

    # printed only: how many cells of the default scan's first batch (these
    # 8 utterances) the kernels' map sets otherwise than the plain run's
    # (the scans are held to their plain runs by their detections below)
    map_k = fp.frontend_batch_flat(wavs, nvalid, fcfg).binary
    map_p = fp.frontend_batch_flat(wavs, nvalid, fcfg, plain=True).binary
    n_map_diff = int((map_k != map_p).sum())
    say(f"default scan, first batch: {n_map_diff} of {map_k.numel()} binary-map cells "
        f"({n_map_diff / map_k.numel():.3g}) differ from the plain run's (printed only)")
    del map_k, map_p

    # kernel 3: block DFT; bf16 output -> one bf16 step (2^-7) of max|ref|
    bf16_tol = 2.0 ** -7
    x = flat.reshape(B, t_pad, d).to(torch.bfloat16)
    cmat, smat = fs._dft_mats(nfft, torch.bfloat16, dev)
    g = torch.cat([cmat, -smat], dim=1).contiguous()
    xr, xi = k3.fft_block_dft(x, g, nfft, hop, nblk)
    xr_ref, xi_ref = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
    err3 = max(float((xr.float() - xr_ref.float()).abs().max()),
               float((xi.float() - xi_ref.float()).abs().max()))
    ref3 = max(float(xr_ref.float().abs().max()), float(xi_ref.float().abs().max()))
    check(err3 <= bf16_tol * ref3, f"fft_block_dft: {err3} > 2^-7 * {ref3}")
    blocks = torch.nn.functional.pad(x, (0, 0, 0, nblk * hop + nfft - hop - t_pad))
    blocks = blocks.unfold(1, nfft, hop).permute(3, 0, 1, 2).reshape(nfft, m * d).contiguous()
    g_t = g.t().contiguous()
    record(
        k3, err3, "2^-7 * max|ref|",
        time_ms(torch, lambda: k3.fft_block_dft(x, g, nfft, hop, nblk)),
        time_ms(torch, lambda: k3.fft_block_dft_plain(x, g, nfft, hop, nblk)),
        time_ms(torch, lambda: torch.matmul(g_t, blocks)),
        B * t_pad * d * 2 + g.numel() * 2 + 2 * bins * m * d * 2,
        2 * (2 * bins) * nfft * m * d, BF16_FLOPS,
    )
    del blocks

    # kernel 4: bin matmul; bf16 output
    check((bins, m, d, K) == (80, 192, 2048, 1024), f"bin matmul shape {(bins, m, d, K)}")
    ycat = k4.fft_binmm(xr, xi, fbank.w2)
    ycat_ref = k4.fft_binmm_plain(xr, xi, fbank.w2)
    err4 = float((ycat.float() - ycat_ref.float()).abs().max())
    ref4 = float(ycat_ref.float().abs().max())
    check(err4 <= bf16_tol * ref4, f"fft_binmm: {err4} > 2^-7 * {ref4}")
    xr3, xi3 = xr.reshape(bins, m, d), xi.reshape(bins, m, d)
    x2 = torch.cat([torch.cat([xr3, xi3], 2), torch.cat([xi3, -xr3], 2)], 1)
    record(
        k4, err4, "2^-7 * max|ref|",
        time_ms(torch, lambda: k4.fft_binmm(xr, xi, fbank.w2)),
        time_ms(torch, lambda: k4.fft_binmm_plain(xr, xi, fbank.w2)),
        time_ms(torch, lambda: torch.bmm(x2, fbank.w2)),
        2 * bins * m * d * 2 + fbank.w2.numel() * 2 + 2 * bins * m * K * 2,
        2 * (2 * m) * (2 * d) * K * bins, BF16_FLOPS, shape=BINMM_BENCH,
    )
    del x2

    # kernel 5: iDFT epilogue; fp32 output, fp32 summation order only
    icm, ism = fs._idft_mats(nfft, hop, torch.bfloat16, dev)
    imat = torch.cat([icm, -ism], dim=0).contiguous()
    y2 = ycat.reshape(2 * bins, m * K)
    sc = k5.fft_idft(y2, imat, fbank.c, nblk)
    sc_ref = k5.fft_idft_plain(y2, imat, fbank.c, nblk)
    err5 = float((sc - sc_ref).abs().max())
    ref5 = float(sc_ref.abs().max())
    check(err5 <= 1e-5 * ref5, f"fft_idft: {err5} > 1e-5 * {ref5}")
    imat_t = imat.t().contiguous()
    record(
        k5, err5, "1e-5 * max|ref|",
        time_ms(torch, lambda: k5.fft_idft(y2, imat, fbank.c, nblk)),
        time_ms(torch, lambda: k5.fft_idft_plain(y2, imat, fbank.c, nblk)),
        time_ms(torch, lambda: torch.matmul(imat_t, y2)),
        y2.numel() * 2 + imat.numel() * 2 + K * 4 + m * hop * K * 4,
        2 * (2 * bins) * hop * m * K, BF16_FLOPS,
    )

    # whole scorer: bf16 kernels vs the f32 plain path on the same map
    s_k = fs.fft_sliding_scores(flat.reshape(B, t_pad, d), fbank, time_major=True)
    s_p = fs.fft_sliding_scores(flat.reshape(B, t_pad, d), fbank32, time_major=True,
                                plain=True)
    err_s = float((s_k - s_p).abs().max())
    ref_s = float(s_p.abs().max())
    check(bool(torch.isfinite(s_k).all()), "scores not finite")
    check(err_s <= 4e-3 * ref_s, f"scores: {err_s} > 4e-3 * {ref_s}")
    say(f"scores (bf16 kernels vs f32 plain): max err {err_s:.6g} = "
        f"{err_s / ref_s:.3g} of max|score| {ref_s:.6g} (tolerance 4e-3)")
    del planes, planes_ref, s_k, s_p
    torch.cuda.empty_cache()

    # ---- kernel 10, the direct correlation, at the bench shape ---------
    xb = correlation_bench(torch, kc, flat.reshape(B, t_pad, d), filters_to_flat(wf), cf,
                           record, say)
    torch.cuda.empty_cache()

    # ---- the DTW + int8 scan's kernels ---------------------------------
    # int8 bin matmul on the block spectra of kernel 3, quantized as the
    # scorer does; bitwise (exact int32 sums, same f32 flush and bf16
    # rounding)
    fbank8 = fs.build_fft_bank(filters_to_flat(wf), cf, mm_dtype=torch.int8)
    xq_r, xq_i, sc8 = fs.quantize_block_spectra(xr, xi, fbank8.w2_scale)
    y8 = k4.fft_binmm_int8(xq_r, xq_i, fbank8.w2, sc8)
    y8_ref = k4.fft_binmm_int8_plain(xq_r, xq_i, fbank8.w2, sc8)
    check(bool(torch.equal(y8, y8_ref)), "fft_binmm_int8: not bitwise")
    record(
        SimpleNamespace(NAME=k4.INT8_NAME, SOURCE=k4.INT8_SOURCE, REPLACES=k4.INT8_REPLACES),
        float((y8.float() - y8_ref.float()).abs().max()), "bitwise",
        time_ms(torch, lambda: k4.fft_binmm_int8(xq_r, xq_i, fbank8.w2, sc8)),
        time_ms(torch, lambda: k4.fft_binmm_int8_plain(xq_r, xq_i, fbank8.w2, sc8)),
        None,      # PyTorch has no batched int8 x int8 -> int32 product
        2 * bins * m * d + fbank8.w2.numel() + sc8.numel() * 4 + 2 * bins * m * K * 2,
        2 * (2 * m) * (2 * d) * K * bins, INT8_OPS,
    )
    del y8, y8_ref, xq_r, xq_i

    # pair LLR tiles of the verify-the-winner rescore: B x top-K peaks,
    # windows of m_seg = L + band frames rounded up to 8
    top_k = cfg.detect.effective_top_k(pad, corpus.sample_rate)
    band = cfg.dtw.band
    m_seg = L + band
    m_llr = -(-m_seg // 8) * 8
    n_pairs = B * top_k
    check((top_k, m_llr) == (123, 40), f"top_k {top_k}, m {m_llr}")
    w_rows, c_rows = bank.llr_rows()
    w16 = filters_to_flat(w_rows).to(torch.bfloat16).contiguous()        # [K, L, D]
    fmap = flat.reshape(B, t_pad, d).to(torch.bool)
    times = torch.from_numpy(rng.integers(0, int(valid.min()), (B, top_k))).to(dev)
    ids = torch.from_numpy(rng.integers(0, K, n_pairs).astype(np.int32)).to(dev)
    rowstart = (torch.arange(B, device=dev)[:, None] * t_pad + times).reshape(-1).to(torch.int32)
    args_p = (fmap, w16, rowstart, ids, m_llr)
    llr = kp.pair_llr(*args_p)
    llr_ref = kp.pair_llr_plain(*args_p)
    err_p = float((llr - llr_ref).abs().max())
    ref_p = float(llr_ref.abs().max())
    check(err_p <= 1e-5 * ref_p, f"pair_llr: {err_p} > 1e-5 * {ref_p}")
    rows_g = rowstart.long()[:, None] + torch.arange(m_llr, device=dev)
    seg_g = fmap.reshape(B * t_pad, d)[rows_g.clamp(max=B * t_pad - 1)].to(torch.bfloat16)
    wk_g = w16[ids.long()]
    # least bytes: each distinct map row the windows cover and each
    # distinct filter the ids name, read once (rows past the map's end
    # read as zero and need no read), plus rowstart, ids and the tiles
    covered = torch.zeros(B * t_pad, dtype=torch.bool, device=dev)
    covered[rows_g[rows_g < B * t_pad]] = True
    n_rows_p, n_ids_p = int(covered.sum()), int(torch.unique(ids).numel())
    bytes_p = n_rows_p * d + n_ids_p * L * d * 2 + n_pairs * 8 + llr.numel() * 4
    record(
        kp, err_p, "1e-5 * max|ref|",
        time_ms(torch, lambda: kp.pair_llr(*args_p), loop=100),
        time_ms(torch, lambda: kp.pair_llr_plain(*args_p)),
        time_ms(torch, lambda: torch.bmm(wk_g, seg_g.transpose(1, 2)), loop=100),
        bytes_p, 2 * n_pairs * L * m_llr * d, BF16_FLOPS,
    )
    host_p = host_us(torch, lambda: kp.pair_llr(*args_p))
    say(f"pair_llr: {n_rows_p} distinct map rows, {n_ids_p} distinct templates, "
        f"{bytes_p / 1e6:.1f} MB least bytes; host {host_p:.1f} us a call (the looped "
        f"event time is the device's where it is larger)")
    del seg_g, wk_g, covered

    # banded DTW on those tiles as the rescore makes them; bitwise on
    # finite terminals
    cost = -(llr + c_rows[ids.long()][:, :, None])
    lens = torch.clamp(valid.long()[:, None] - times, 1, m_seg).reshape(-1).to(torch.int32)
    tot = kd.banded_dtw(cost, lens, band)
    tot_ref = kd.banded_dtw_plain(cost, lens, band)
    n_unreach = check_terminals(torch, tot, tot_ref, "banded_dtw")
    cells = band_cells(torch, L, m_llr, lens, band)
    record(
        kd, 0.0, "bitwise on finite terminals",
        time_ms(torch, lambda: kd.banded_dtw(cost, lens, band), loop=100),
        time_ms(torch, lambda: kd.banded_dtw_plain(cost, lens, band)),
        None,      # no single PyTorch call computes a banded DTW
        # least bytes: the in-band cost cells before seg_len, lens, out
        cells * 4 + lens.numel() * 4 + tot.numel() * 4,
        4 * cells, FP32_FLOPS,     # one add and three minimums per in-band cell
    )
    host_d = host_us(torch, lambda: kd.banded_dtw(cost, lens, band))
    say(f"banded_dtw: {n_pairs} pairs, {cells} in-band cells, {n_unreach} unreachable; "
        f"host {host_d:.1f} us a call; the bound above counts bytes and operations, the kernel is held by its "
        f"chain of L + seg_len - 1 = {L + m_seg - 1} dependent diagonals a pair")
    # the same kernel in the TPU's "band"/"full" regime (L > 64): 984
    # pairs of L = 96 templates, band 6 -> windows of 102 frames
    l96, m96 = 96, 104
    cost96 = torch.from_numpy(
        (rng.standard_normal((n_pairs, l96, m96)) + 2.0).astype(np.float32)).to(dev)
    lens96 = torch.from_numpy(
        rng.integers((l96 + band) // 2, l96 + band + 1, n_pairs).astype(np.int32)).to(dev)
    check_terminals(torch, kd.banded_dtw(cost96, lens96, band),
                    kd.banded_dtw_plain(cost96, lens96, band), "banded_dtw (L=96)")
    ms96 = time_ms(torch, lambda: kd.banded_dtw(cost96, lens96, band), loop=100)
    plain96 = time_ms(torch, lambda: kd.banded_dtw_plain(cost96, lens96, band))
    cells96 = band_cells(torch, l96, m96, lens96, band)
    b96, _by = bound_ms(cells96 * 4 + n_pairs * 8, 4 * cells96, FP32_FLOPS)
    say(f"banded_dtw at L = {l96} ({n_pairs} pairs, band {band}, M = {m96}): bitwise; "
        f"kernel {ms96:.4f} ms plain {plain96:.4f} ms bound {b96:.4f} ms (bytes; the "
        f"chain is up to {l96 + l96 + band - 1} diagonals)")
    del llr, llr_ref, cost, cost96, fbank8
    torch.cuda.empty_cache()

    # ---- the log-mel scan's kernels ------------------------------------
    mf = C.FrontendConfig(use_mel=True).feature_freqs
    templates_mel = rng.uniform(0.01, 0.99, (K, L, mf, 8)).astype(np.float32)
    background_mel = rng.uniform(0.01, 0.99, (mf, 8)).astype(np.float32)
    bank_mel = bank_from_numpy(templates_mel, background_mel, [f"k{i}" for i in range(K)], dev)
    mods = SimpleNamespace(C=C, fp=fp, fs=fs, k1=k1, k3=k3, k4=k4, kp=kp, k8=k8, k9=k9)
    mel_kernel_checks(torch, mods, dev, wavs, nvalid, valid, frames2, bank_mel, record, say)
    torch.cuda.empty_cache()

    small_shape_checks(torch, dev, frames2, k1, k2, k3, k4, k5, kp, kd, k8, k9, kc, fp, fs,
                       say)
    say("small ragged shapes: all eleven kernels agree with their plain versions")

    # ---- the scan at full width ---------------------------------------
    scan_cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B))
    # one warm-up batch: first calls of PyTorch's own kernels (masking,
    # NMS, top-K) load their modules lazily
    detect_corpus_stream(corpus.head(B), bank, scan_cfg, target_phone="aa")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in SCAN_KERNELS:
        check(counts.get(name, 0) > 0, f"{name} was not launched by the scan")
    take_launches(rows, SCAN_KERNELS, counts)
    ctr = res.counters
    stages = " ".join(
        f"{s} {ctr.get(f'device_ms_{s}', 0.0) / ctr['batches']:.3f} ms"
        for s in ("frontend", "score", "nms")
    )
    check(ctr["batches"] == 3, f"expected 3 batches, got {ctr['batches']}")
    say(f"scan: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} audio-s, "
        f"{ctr['audio_s_per_s']:.1f} audio-s/s (scan loop {ctr['time_scan_s']:.4f} s; "
        f"with the bank build {wall:.4f} s); mean device time per batch "
        f"({ctr['batches']:.0f} batches): {stages} (CUDA events); launches {counts}")

    def bank_build(b):
        """What ``detect_corpus_stream`` does before its loop (bf16 bank)."""
        def build():
            w_, c_ = b.llr()
            return fs.build_fft_bank(filters_to_flat(w_), c_, mm_dtype=None)
        return build

    report_busy(torch, say, "scan",
                lambda: detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa"),
                bank_build(bank), ctr)
    ref = detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa", plain=True)
    dk, dp = res.detections, ref.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no detections")
    frac, id_frac, _diff, _top = match_detections(dk, dp)
    say(f"scan vs plain scan: {len(dk.scores)} vs {len(dp.scores)} detections, "
        f"{frac:.4f} matched peaks, {id_frac:.4f} same template on matched")
    check(frac >= 0.99, f"matched peaks {frac} < 0.99")
    check(id_frac >= 0.99, f"template ids agree on {id_frac} < 0.99 of matched")
    fft_dets = dk
    del res, ref

    # ---- the DTW + int8 scan at full width (configs 4 and 5) -----------
    dtw_cfg = C.PipelineConfig(detect=C.DetectConfig(
        batch_size=B, dtw_rescore=True, int8_spectra=True))
    check(dtw_cfg.dtw.top_r == 1, "verify-the-winner is the default")
    detect_corpus_stream(corpus.head(B), bank, dtw_cfg, target_phone="aa")   # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus_stream(corpus, bank, dtw_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in ("frontend_planes", "select_binspread", "fft_block_dft", "fft_binmm_int8",
                 "fft_idft", "pair_llr", "banded_dtw"):
        check(counts.get(name, 0) > 0, f"{name} was not launched by the DTW + int8 scan")
    check(counts.get("fft_binmm", 0) == 0, "the int8 scan launched the bf16 bin matmul")
    take_launches(rows, ("fft_binmm_int8", "pair_llr", "banded_dtw"), counts)
    ctr = res.counters
    stages = " ".join(
        f"{s} {ctr.get(f'device_ms_{s}', 0.0) / ctr['batches']:.3f} ms"
        for s in ("frontend", "score", "nms", "dtw")
    )
    say(f"DTW + int8 scan: {ctr['utterances']:.0f} utterances, "
        f"{ctr['audio_seconds']:.1f} audio-s, {ctr['audio_s_per_s']:.1f} audio-s/s (scan "
        f"loop {ctr['time_scan_s']:.4f} s; with the bank build {wall:.4f} s); mean device "
        f"time per batch ({ctr['batches']:.0f} batches): {stages} (CUDA events); "
        f"launches {counts}")
    ref = detect_corpus_stream(corpus, bank, dtw_cfg, target_phone="aa", plain=True)
    dk, dp = res.detections, ref.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no DTW detections")
    frac, id_frac, diff, top = match_detections(dk, dp)
    say(f"DTW + int8 scan vs plain scan: {len(dk.scores)} vs {len(dp.scores)} detections, "
        f"{frac:.4f} matched peaks, {id_frac:.4f} same template on matched, DTW score "
        f"max diff {diff:.6g} = {diff / top:.3g} of max|score| {top:.6g} (tolerance 1e-4)")
    check(frac >= 0.99, f"DTW + int8: matched peaks {frac} < 0.99")
    check(id_frac >= 0.99, f"DTW + int8: template ids agree on {id_frac} < 0.99")
    check(diff <= 1e-4 * top, f"DTW + int8: scores differ by {diff} > 1e-4 * {top}")
    del res, ref

    # ---- exhaustive rescoring (top_r = 0) on one batch -----------------
    ex_cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B, dtw_rescore=True),
                              dtw=C.DTWConfig(top_r=0))
    head = corpus.head(B)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus_stream(head, bank, ex_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(counts.get("banded_dtw", 0) > 0, "exhaustive rescore did not launch banded_dtw")
    ctr = res.counters
    ref = detect_corpus_stream(head, bank, ex_cfg, target_phone="aa", plain=True)
    dk, dp = res.detections, ref.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no exhaustive detections")
    frac, id_frac, diff, top = match_detections(dk, dp)
    say(f"exhaustive rescore (top_r 0, {B} x {top_k} peaks x {K} templates): {wall:.3f} s, "
        f"dtw stage {ctr.get('device_ms_dtw', 0.0):.3f} ms (CUDA events), launches {counts}; "
        f"vs plain: {frac:.4f} matched peaks, {id_frac:.4f} same template, score max diff "
        f"{diff:.6g} = {diff / top:.3g} of max|score| (tolerance 1e-4)")
    check(frac >= 0.99, f"exhaustive: matched peaks {frac} < 0.99")
    check(id_frac >= 0.99, f"exhaustive: (time, id) agree on {id_frac} < 0.99")
    check(diff <= 1e-4 * top, f"exhaustive: scores differ by {diff} > 1e-4 * {top}")
    del res, ref

    # ---- the log-mel scan at full width, then with DTW + int8 ----------
    mel_fcfg = C.FrontendConfig(use_mel=True)
    for label, dkw, expect in (
        ("log-mel scan", {}, MEL_KERNELS),
        ("log-mel DTW + int8 scan", {"dtw_rescore": True, "int8_spectra": True},
         MEL_KERNELS[:4] + ("fft_binmm_int8", "fft_idft", "pair_llr", "banded_dtw")),
    ):
        mcfg = C.PipelineConfig(frontend=mel_fcfg, detect=C.DetectConfig(batch_size=B, **dkw))
        detect_corpus_stream(corpus.head(B), bank_mel, mcfg, target_phone="aa")   # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = detect_corpus_stream(corpus, bank_mel, mcfg, target_phone="aa")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        ctr = res.counters
        for name in expect:
            check(counts.get(name, 0) > 0, f"{name} was not launched by the {label}")
        for name in ("frontend_planes", "select_binspread"):
            check(counts.get(name, 0) == 0, f"the {label} launched {name}")
        check(counts.get("radix_counts", 0) == len(fp.RADIX_WIDTHS) * ctr["batches"],
              f"{label}: {counts.get('radix_counts', 0)} radix launches")
        if not dkw:
            take_launches(rows, ("frontend_planes_mel", "radix_counts", "binspread"), counts)
            take_launches(rows, ("fft_binmm",), counts, shape=BINMM_MEL)
        stages = " ".join(
            f"{s_} {ctr.get(f'device_ms_{s_}', 0.0) / ctr['batches']:.3f} ms"
            for s_ in ("frontend", "score", "nms", "dtw") if f"device_ms_{s_}" in ctr
        )
        say(f"{label}: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} "
            f"audio-s, {ctr['audio_s_per_s']:.1f} audio-s/s (scan loop "
            f"{ctr['time_scan_s']:.4f} s; with the bank build {wall:.4f} s); mean device "
            f"time per batch ({ctr['batches']:.0f} batches): {stages} (CUDA events); "
            f"launches {counts}")
        if not dkw:
            report_busy(torch, say, label,
                        lambda: detect_corpus_stream(corpus, bank_mel, mcfg, target_phone="aa"),
                        bank_build(bank_mel), ctr)
        ref = detect_corpus_stream(corpus, bank_mel, mcfg, target_phone="aa", plain=True)
        dk, dp = res.detections, ref.detections
        check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()),
              f"{label}: no detections")
        frac, id_frac, diff, top = match_detections(dk, dp)
        say(f"{label} vs plain scan: {len(dk.scores)} vs {len(dp.scores)} detections, "
            f"{frac:.4f} matched peaks, {id_frac:.4f} same template on matched, score max "
            f"diff {diff:.6g} = {diff / top:.3g} of max|score| {top:.6g} (tolerance 4e-3)")
        check(frac >= 0.99, f"{label}: matched peaks {frac} < 0.99")
        check(id_frac >= 0.99, f"{label}: template ids agree on {id_frac} < 0.99")
        check(diff <= 4e-3 * top, f"{label}: scores differ by {diff} > 4e-3 * {top}")
        del res, ref

    # ---- the backend-selectable scorer: the correlation kernel's path ---
    # one utterance a call, in the reference's [T', F, E] / [K, L, F, E]
    # signature, on the 8 bench-shape maps
    maps = [flat_to_channels(xb[i], fcfg.feature_freqs) for i in range(B)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    api = [ts.sliding_scores_backend(mp, wf, cf, backend="pallas") for mp in maps]
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(counts.get("correlation", 0) == B, f"pallas backend: launches {counts}")
    check(counts.get("fft_binmm", 0) == 0, "the pallas backend launched the FFT bin matmul")
    take_launches(rows, ("correlation",), counts)
    via_fft = [ts.sliding_scores_backend(mp, wf, cf, backend="fft") for mp in maps]
    err_api = max(float((a - r).abs().max()) for a, r in zip(api, via_fft))
    top_api = max(float(r.abs().max()) for r in via_fft)
    say(f"sliding_scores_backend(pallas): {B} utterances of {T_BENCH} frames in {api_s:.4f} s "
        f"(host clock), launches {counts}; vs backend fft: max diff {err_api:.6g} = "
        f"{err_api / top_api:.3g} of max|score| {top_api:.6g} (tolerance 4e-3)")
    check(all(a.shape == (K, T_BENCH - L + 1) for a in api), "pallas backend: shape")
    check(err_api <= 4e-3 * top_api, f"pallas vs fft backend: {err_api} > 4e-3 * {top_api}")
    del api, via_fft, maps, xb

    # ---- the streaming scan on the f32 conv (score_backend="conv") -----
    conv_cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B, score_backend="conv"))
    detect_corpus_stream(corpus.head(B), bank, conv_cfg, target_phone="aa")   # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus_stream(corpus, bank, conv_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in ("frontend_planes", "select_binspread"):
        check(counts.get(name, 0) > 0, f"{name} was not launched by the conv scan")
    for name in ("fft_block_dft", "fft_binmm", "fft_idft", "correlation"):
        check(counts.get(name, 0) == 0, f"the conv scan launched {name}")
    ctr = res.counters
    stages = " ".join(
        f"{s_} {ctr.get(f'device_ms_{s_}', 0.0) / ctr['batches']:.3f} ms"
        for s_ in ("frontend", "score", "nms")
    )
    dk = res.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no conv detections")
    # printed only: the bf16 FFT scorer moves borderline NMS peaks, so
    # this measures the fft scan's error, not the conv's
    frac, id_frac, diff, top = match_detections(dk, fft_dets)
    say(f"conv scan: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} audio-s, "
        f"{ctr['audio_s_per_s']:.1f} audio-s/s (scan loop {ctr['time_scan_s']:.4f} s; with the "
        f"bank build {wall:.4f} s); mean device time per batch ({ctr['batches']:.0f} "
        f"batches): {stages} (CUDA events); launches {counts}; vs the fft scan (not a "
        f"check): {len(dk.scores)} vs {len(fft_dets.scores)} detections, {frac:.4f} matched "
        f"peaks, {id_frac:.4f} same template, score max diff {diff:.6g} = {diff / top:.3g} of "
        f"max|score|")
    del res
    # the check: the conv scan on one batch against the per-utterance
    # conv loop on the same utterances (both the f32 conv, TF32 off):
    # identical (time, template) peaks, scores within 1e-5 x max|score|
    head = corpus.head(B)
    res = detect_corpus_stream(head, bank, conv_cfg, target_phone="aa")
    loop = _detect_corpus_loop(head, bank, conv_cfg, target_phone="aa")
    dk, dl = res.detections, loop.detections
    check(len(dk.scores) == len(dl.scores) > 0,
          f"conv scan vs conv loop: {len(dk.scores)} vs {len(dl.scores)} detections")
    diff_c, top_c = 0.0, float(np.max(np.abs(dl.scores)))
    for ui in range(B):
        a = sorted(zip(dk.times[dk.utterance_ids == ui].tolist(),
                       dk.template_ids[dk.utterance_ids == ui].tolist(),
                       dk.scores[dk.utterance_ids == ui].tolist()))
        b = sorted(zip(dl.times[dl.utterance_ids == ui].tolist(),
                       dl.template_ids[dl.utterance_ids == ui].tolist(),
                       dl.scores[dl.utterance_ids == ui].tolist()))
        check([x[:2] for x in a] == [x[:2] for x in b],
              f"conv scan vs conv loop: utterance {ui}'s (time, template) peaks differ")
        diff_c = max([diff_c] + [abs(x[2] - y[2]) for x, y in zip(a, b)])
    say(f"conv scan vs conv loop ({B} utterances): {len(dk.scores)} identical (time, "
        f"template) peaks, score max diff {diff_c:.6g} = {diff_c / top_c:.3g} of max|score| "
        f"{top_c:.6g} (tolerance 1e-5)")
    check(diff_c <= 1e-5 * top_c, f"conv scan vs conv loop: scores differ by {diff_c}")
    del res, loop

    # ---- exact int32 scores through pipeline.detect_corpus, one batch --
    ex_cfg = C.PipelineConfig(detect=C.DetectConfig(exact_scores=True))
    head = corpus.head(B)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus(head, bank, ex_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in ("frontend_planes", "select_binspread"):
        check(counts.get(name, 0) == B, f"exact loop: {name} launched {counts.get(name, 0)}x")
    dk = res.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no exact detections")
    # utterance 0 again, as the loop scores it: int32 on the card and on
    # the CPU, bitwise; its detections are NMS of those scores
    _u, wav0, _p = head.utts[0]
    pad0 = bucket_length(len(wav0))
    buf = torch.zeros((1, pad0), dtype=torch.float32)
    buf[0, : len(wav0)] = torch.from_numpy(wav0)
    fm0 = fp.frontend_batch_flat(buf.to(dev), torch.tensor([len(wav0)], dtype=torch.int32,
                                                           device=dev), fcfg)
    fmap0 = fm0.binary[0, : fcfg.num_feature_frames(pad0)]
    scale = ex_cfg.detect.quant_scale
    w_int, c_int = bank.llr_quantized(scale)
    w_int = filters_to_flat(w_int).contiguous()
    si_gpu = ts.sliding_scores_int(fmap0, w_int, c_int).cpu()
    t1 = time.perf_counter()
    si_cpu = ts.sliding_scores_int(fmap0.cpu(), w_int.cpu(), c_int.cpu())
    cpu_s = time.perf_counter() - t1
    n_diff = int((si_gpu != si_cpu).sum())
    check(n_diff == 0, f"exact: {n_diff} int32 scores differ between the card and the CPU")
    sc0 = ts.masked_scores(si_cpu.to(torch.float32) / float(scale),
                           fm0.valid_frames[0].cpu(), L)
    s0, t0_, k0 = top_detections(sc0, ex_cfg.detect.nms_radius,
                                 ex_cfg.detect.effective_top_k(pad0, corpus.sample_rate))
    keep = torch.isfinite(s0)
    sel = dk.utterance_ids == 0
    check(np.array_equal(dk.times[sel], t0_[keep].numpy())
          and np.array_equal(dk.template_ids[sel], k0[keep].numpy())
          and np.array_equal(np.asarray(dk.scores[sel], np.float32), s0[keep].numpy()),
          "exact: utterance 0's detections are not NMS of its int32 scores")
    say(f"exact detect_corpus ({B} utterances, per-utterance loop): {wall:.3f} s, "
        f"{res.counters['audio_s_per_s']:.1f} audio-s/s, {len(dk.scores)} detections, "
        f"launches {counts}; utterance 0: {si_cpu.numel()} int32 scores bitwise equal on "
        f"the card and on the CPU ({cpu_s:.2f} s there), its {int(sel.sum())} detections "
        f"equal to NMS of them")
    del si_gpu, si_cpu, w_int

    # ---- the exact loop with DTW rescoring (top_r 1) on f32 filters ----
    # the loop rescores on the gathered f32 route on every device (the
    # reference loop's): its DTW scores on the card against the same
    # rescore on the CPU, over the card's feature maps and the peaks of
    # the exact run above (the peaks this run rescores)
    exd_cfg = C.PipelineConfig(detect=C.DetectConfig(exact_scores=True, dtw_rescore=True))
    check(exd_cfg.dtw.top_r == 1, "verify-the-winner is the default")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    resd = detect_corpus(head, bank, exd_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(counts.get("banded_dtw", 0) == B, f"exact DTW loop: launches {counts}")
    check(counts.get("pair_llr", 0) == 0, "the exact loop's DTW took the bf16 map route")
    w_rows_c, c_rows_c = bank.llr_rows()
    w_rows_c, c_rows_c = filters_to_flat(w_rows_c).cpu(), c_rows_c.cpu()
    band_d = exd_cfg.dtw.band
    dd, dx = resd.detections, res.detections
    diff_d = top_d = 0.0
    for ui, (_u, wav, _p) in enumerate(head.utts):
        pad_u = bucket_length(len(wav))
        buf = torch.zeros((1, pad_u), dtype=torch.float32)
        buf[0, : len(wav)] = torch.from_numpy(wav)
        fm_u = fp.frontend_batch_flat(
            buf.to(dev), torch.tensor([len(wav)], dtype=torch.int32, device=dev), fcfg)
        sel = dx.utterance_ids == ui
        s_c, k_c = dtw_rescore_detections(
            fm_u.binary[0, : fcfg.num_feature_frames(pad_u)].cpu(),
            fm_u.valid_frames[0].cpu(),
            torch.from_numpy(np.asarray(dx.scores[sel], np.float32)),
            torch.from_numpy(np.asarray(dx.times[sel], np.int64)), w_rows_c, c_rows_c,
            L + band_d, band_d, ids=torch.from_numpy(np.asarray(dx.template_ids[sel], np.int64)),
            top_r=1,
        )
        fin = torch.isfinite(s_c).numpy()
        want = dict(zip(dx.times[sel][fin].tolist(), zip(k_c.numpy()[fin].tolist(),
                                                          s_c.numpy()[fin].tolist())))
        seld = dd.utterance_ids == ui
        got = dict(zip(dd.times[seld].tolist(), zip(dd.template_ids[seld].tolist(),
                                                    dd.scores[seld].tolist())))
        check(len(want) > 0 and set(got) == set(want),
              f"exact DTW loop: utterance {ui}'s peaks differ from the CPU rescore")
        for t_, (k_, s_) in got.items():
            check(k_ == want[t_][0], f"exact DTW loop: utterance {ui}, time {t_}: template "
                                     f"{k_} on the card, {want[t_][0]} on the CPU")
            diff_d = max(diff_d, abs(s_ - want[t_][1]))
            top_d = max(top_d, abs(want[t_][1]))
    say(f"exact detect_corpus with DTW (top_r 1, {B} utterances): {wall_d:.3f} s, "
        f"{resd.counters['audio_s_per_s']:.1f} audio-s/s, {len(dd.scores)} detections, "
        f"launches {counts}; vs the CPU rescore of the same peaks: identical template ids, "
        f"DTW score max diff {diff_d:.6g} = {diff_d / top_d:.3g} of max|score| {top_d:.6g} "
        f"(tolerance 1e-5)")
    check(diff_d <= 1e-5 * top_d, f"exact DTW loop: {diff_d} > 1e-5 * {top_d}")
    del res, resd

    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
