#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: audio-seconds a second on one
GPU for template-bank scoring, with ``bench.py``'s workload, knobs and
keys.

    python3 bench_cuda.py [--device cpu]
    python -m template_speech_recognition_tpu_torch bench [--device cpu]

Workload (``bench.py``'s): B utterances x T frames of binary edge
features ([T, F = 256, E = 8] -> D = 2048 channels, 15% ones), K
templates of length L (normal filters and offsets), all made on the
device from seed 0.  Knobs: ``BENCH_B`` (8), ``BENCH_T`` (3000),
``BENCH_K`` (1024), ``BENCH_L`` (32), ``BENCH_BACKEND``:

* ``fft`` (default): the FFT scorer (``detect.fft_scorer``: kernels 3,
  4 and 5 on bf16 operands) as the scan calls it, time-major with
  ``trim=False``; the bank's spectra are built once, outside the timing;
* ``conv``: ``detect.scorer.sliding_scores_batch`` on operands rounded
  to bf16, the float32 conv with TF32 off (the port's
  ``sliding_scores_backend(backend="conv")`` on the whole batch);
* ``pallas``: the direct correlation kernel (kernel 10,
  ``ops.correlation_kernel``) on the whole batch, its bf16 operands cast
  once, outside the timing.

Kernel time: CUDA events around a run of calls queued behind a device
sleep, so that the events time the device rather than the enqueue; the
median of ``REPS`` runs.  ``value`` is the B*T*10 ms of audio over that
time; ``h100_effective_tflops`` counts the direct correlation's
2*B*T*K*L*D operations whatever the backend, as ``bench.py`` does.

``BENCH_E2E`` (1; 0 skips both): the frontend alone
(``frontend_batch_flat`` on B random waveforms of T frames, CUDA events,
the median of ``REPS``) and end to end: ``scan.detect_corpus_stream``
with the default config (FFT scorer, batches of B) over ``E2E_UTTS``
(1024) utterances of T frames cut from the synthetic corpus of
``oracle.fixtures`` (``chip_smoke.Corpus``: ``POOL`` distinct ones,
repeated) with a random bank (``chip_smoke.random_bank``, seed 0), one
warm-up scan and then ``E2E_REPS`` (7) scans
(``chip_smoke.scan_rates``).  Each scan's ``audio_s_per_s`` (audio
seconds over the scan loop's wall, the bank build excluded) is printed
on a line of its own with their spread (max over min);
``e2e_audio_s_per_s`` is their median.

``vs_baseline``: ``value`` over the NumPy oracle's throughput on the
host (``oracle.score.sliding_score``, float32 BLAS) on a slice of one
utterance x 400 frames x 8 templates, extrapolated linearly in B*T*K,
as ``bench.py`` does.

Prints the card's name and power limit as ``nvidia-smi`` gives them on
a line of their own, then one JSON line, the last of its output:
``bench.py``'s keys with the ``tpu_*`` ones named for the card
(``h100_step_ms``, ``h100_effective_tflops``), ``card`` (the same
``nvidia-smi`` line, beside every number of the line), ``device``,
``e2e_audio_s_per_s_runs``, ``e2e_spread`` and ``launches`` (each
kernel's launches in the scorer's, the frontend's and the scan's
measurement).

Runs on the card.  Without a CUDA device it exits 2, unless ``--device
cpu`` is given: then the plain versions run on the CPU (for the tests),
the ``h100_*`` keys and ``card`` are null and the step time is
``cpu_step_ms``.  Imports the port and ``oracle/``, nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPS = 10                  # timed runs of the scorer and of the frontend
CPU_REPS = 3               # the same on the CPU, where the plain versions run for tests
POOL = 16                  # distinct synthetic utterances of the end-to-end corpus
E2E_UTTS = 1024            # utterances of the end-to-end corpus
E2E_REPS = 7               # timed end-to-end scans
HOP_SECONDS = 0.010        # bench.py's 10 ms hop


def time_ms(torch, fn, dev) -> float:
    """Median ms of one call of ``fn``.  On the card, ``chip_smoke.time_ms``
    over ``REPS`` runs, each a loop of calls (about 20 ms of them, 2 to
    100) between two CUDA events, queued behind a ~25 ms device sleep;
    on the CPU (tests only), the host clock around one call, ``CPU_REPS``
    times."""
    fn()
    if dev.type != "cuda":
        times = []
        for _ in range(CPU_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    from chip_smoke import time_ms as events_ms

    one = events_ms(torch, fn, reps=1, warm=1)
    loop = max(2, min(100, int(20.0 / max(one, 1e-3))))
    return events_ms(torch, fn, reps=REPS, warm=0, loop=loop)


def scorer_call(torch, backend: str, shape, dev):
    """The timed call of ``backend`` on the bench workload, its operands
    made on ``dev`` from seed 0 (the bank's spectra and the bf16 casts
    made here, once)."""
    from template_speech_recognition_tpu_torch.detect.fft_scorer import (
        build_fft_bank,
        fft_sliding_scores,
    )
    from template_speech_recognition_tpu_torch.detect.scorer import sliding_scores_batch
    from template_speech_recognition_tpu_torch.ops.correlation_kernel import (
        correlation_scores,
    )

    b, t, k, length, d = shape
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.rand((b, t, d), generator=g, device=dev) < 0.15
    w = torch.randn((k, length, d), generator=g, device=dev)
    c = torch.randn((k,), generator=g, device=dev)
    mm = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if backend == "fft":
        bank = build_fft_bank(w, c, mm_dtype=mm)
        x = feats.to(mm)
        return lambda: fft_sliding_scores(x, bank, time_major=True, trim=False)
    if backend == "conv":
        x = feats.to(torch.float32)
        return lambda: sliding_scores_batch(x, w, c, compute_dtype=torch.bfloat16)
    if backend == "pallas":
        x, w16 = feats.to(torch.bfloat16), w.to(torch.bfloat16)
        return lambda: correlation_scores(x, w16, c)
    raise SystemExit(f"BENCH_BACKEND {backend!r}: fft, conv or pallas")


def frontend_rate(torch, b: int, t: int, fcfg, dev) -> float:
    """Frontend audio-s/s: B random waveforms of T frames (padded to their
    bucket) -> flat binary maps, ``frontend_batch_flat`` as the scan's
    step calls it."""
    from template_speech_recognition_tpu_torch.frontend.planes import frontend_batch_flat
    from template_speech_recognition_tpu_torch.scan import bucket_length

    samples = t * fcfg.hop_length + fcfg.frame_length
    g = torch.Generator(device=dev).manual_seed(1)
    wavs = torch.randn((b, bucket_length(samples)), generator=g, device=dev)
    valid = torch.full((b,), samples, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: frontend_batch_flat(wavs, valid, fcfg), dev)
    return b * samples / fcfg.sample_rate / (ms / 1e3)


def e2e_rates(torch, b: int, t: int, k: int, length: int, fcfg, dev,
              n_utts: int, reps: int) -> list[float]:
    """Audio-s/s of ``reps`` scans (``detect_corpus_stream``, the
    default config, batches of B) of ``n_utts`` utterances of T frames
    with a random bank (seed 0), after one warm-up scan."""
    from chip_smoke import Corpus, random_bank, scan_rates
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.convert import bank_from_numpy

    templates, background = random_bank(fcfg, np.random.default_rng(0), k, length)
    bank = bank_from_numpy(templates, background, [f"k{i}" for i in range(k)], dev)
    cfg = C.PipelineConfig(frontend=fcfg, detect=C.DetectConfig(batch_size=b))
    samples = t * fcfg.hop_length + fcfg.frame_length
    corpus = Corpus(0, n_utts, samples, phones=samples // 2000 + 8, distinct=POOL)
    return scan_rates(torch, corpus, bank, cfg, reps, dev)


def cpu_oracle_seconds(b: int, t: int, k: int, length: int, f: int, e: int,
                       k_small: int = 8, t_small: int = 400, b_small: int = 1) -> float:
    """Seconds the NumPy oracle takes for the whole workload, timed on a
    slice and extrapolated linearly in B*T*K (``bench.py``'s method, on
    distribution-identical host data)."""
    from oracle.score import sliding_score

    k_small, t_small, b_small = min(k_small, k), min(t_small, t), min(b_small, b)
    rng = np.random.default_rng(0)
    feats = (rng.random((b_small, t_small, f, e)) < 0.15).astype(np.float32)
    w = rng.standard_normal((k_small, length, f, e)).astype(np.float32)
    c = rng.standard_normal((k_small,)).astype(np.float32)
    sliding_score(feats[0], w, c)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        for i in range(b_small):
            sliding_score(feats[i], w, c)
    dt_small = (time.perf_counter() - t0) / reps
    return dt_small * (b / b_small) * (t / t_small) * (k / k_small)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; exits 2 without a GPU) or cpu")
    args = p.parse_args(argv)
    # the port and oracle/ beside this script, from any working directory
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch

    from chip_smoke import card_line

    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_cuda: no CUDA device (--device cpu runs the plain versions on "
              "the CPU)", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.config import FrontendConfig
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.utils.compile_cache import enable_compile_cache

    cuda = dev.type == "cuda"
    card = card_line() if cuda else None
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        enable_compile_cache()
    b = int(os.environ.get("BENCH_B", 8))
    t = int(os.environ.get("BENCH_T", 3000))          # 30 s of audio each
    k = int(os.environ.get("BENCH_K", 1024))
    length = int(os.environ.get("BENCH_L", 32))
    backend = os.environ.get("BENCH_BACKEND", "fft")
    f, e = 256, 8
    audio_seconds = b * t * HOP_SECONDS

    launches = {}
    _cuda.reset_launches()
    step_ms = time_ms(torch, scorer_call(torch, backend, (b, t, k, length, f * e), dev), dev)
    launches["scorer"] = _cuda.launch_counts()
    throughput = audio_seconds / (step_ms / 1e3)

    frontend_tput = e2e = None
    if os.environ.get("BENCH_E2E", "1") != "0":
        fcfg = FrontendConfig()                       # nfft 512 -> F 256: the same D
        _cuda.reset_launches()
        frontend_tput = frontend_rate(torch, b, t, fcfg, dev)
        launches["frontend"] = _cuda.launch_counts()
        _cuda.reset_launches()
        e2e = e2e_rates(torch, b, t, k, length, fcfg, dev, E2E_UTTS, E2E_REPS)
        launches["e2e"] = _cuda.launch_counts()
        print(f"[{card or 'cpu'}] e2e audio-s/s of {len(e2e)} scans: "
              + ", ".join(f"{r:.1f}" for r in e2e)
              + f"; spread (max / min) {max(e2e) / min(e2e):.3f}", flush=True)

    cpu_throughput = audio_seconds / cpu_oracle_seconds(b, t, k, length, f, e)
    flops = 2.0 * b * t * k * length * f * e
    result = {
        "metric": "audio_seconds_per_s_per_chip_template_scoring",
        "value": round(throughput, 1),
        "unit": "audio_seconds_per_second",
        "vs_baseline": round(throughput / cpu_throughput, 1),
        "bank_k": k,
        "template_len": length,
        "batch_utts": b,
        "frames_per_utt": t,
        "h100_step_ms": round(step_ms, 4) if cuda else None,
        "h100_effective_tflops": round(flops / (step_ms / 1e3) / 1e12, 1) if cuda else None,
        "cpu_oracle_audio_s_per_s": round(cpu_throughput, 2),
        "backend": backend,
        "timing": (f"cuda_events(median of {REPS} runs behind a device sleep)" if cuda
                   else f"host_clock(median of {CPU_REPS})"),
        "card": card,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": torch.cuda.device_count() if cuda else 0},
        "launches": launches,
    }
    if not cuda:
        result["cpu_step_ms"] = round(step_ms, 4)
    if e2e is not None:
        e2e_tput = float(np.median(e2e))
        result["e2e_audio_s_per_s"] = round(e2e_tput, 1)
        result["e2e_frac_of_kernel"] = round(e2e_tput / throughput, 3)
        result["frontend_audio_s_per_s"] = round(frontend_tput, 1)
        result["e2e_audio_s_per_s_runs"] = [round(r, 1) for r in e2e]
        result["e2e_spread"] = round(max(e2e) / min(e2e), 3)
    if card:
        print(card)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
