#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--bench | --verify | --soak | --domain | --multichip]

1. builds the eleven CUDA kernels of the port from the eleven sources in
   ``template_speech_recognition_tpu_torch/csrc`` (one nvcc per source,
   all started together), then runs the port CLI's ``bench``
   (``python -m template_speech_recognition_tpu_torch bench``, which runs
   ``bench_cuda.py``) at ``bench.py``'s shape (B 8, T 3000, K 1024, L 32)
   once for each ``BENCH_BACKEND``, fft, conv and pallas, a process each:
   its last line must parse as JSON with every key of ``bench.py``
   (``h100_step_ms`` and ``h100_effective_tflops`` for the ``tpu_*``
   ones), ``value`` > 0 and this card's ``nvidia-smi`` line, and the
   kernels of its scorer, frontend and scan must each have launched in
   their own measurement (``python3 chip_smoke.py --bench`` runs the
   build and this phase alone);
2. calls each kernel's wrapper on the card at the shapes the scan gives
   it (8 utterances of 30 s: T_pad = 3072, F = 256, D = 2048, K = 1024
   templates of L = 32, nfft = 159; for the DTW rescore 8 x 123 peaks,
   windows of m = 40 frames) and holds the result against its plain
   PyTorch version on the same inputs, with the tolerance stated beside
   each check; times kernel, plain version and one library call with
   CUDA events (median of 10 after 2 warm-ups; the two short DTW
   kernels, kernels 1, 2, 3 and 5 and the library calls of 1, 3 and 5
   over loops of 100 launches, so the wrapper's host time is not timed) and
   computes each kernel's bound (the larger of the least bytes / 3.35
   TB/s and operations / the peak rate of their type; the H100's rates
   of ``utils/profiling.py``).  The log-mel
   scan's kernels (n_mels 64: F = 63, D = 504) follow: kernel 1 in mel
   mode (also at n_mels 129, where the two-kernel path takes it), the
   radix select (kernel 8: the whole dual-rank select in one call of at
   most four kernels and one memset, counted from a ``torch.profiler``
   trace; bitwise, two launches equal, timed over 100 calls queued behind
   a device sleep, so the events time the device, not the enqueue; the
   yardstick is ``torch.kthvalue`` for both ranks; the whole
   ``plane_order_statistics`` timed as one call, ``sel_ms``), binarize + spread
   (kernel 9, bitwise at rt 0 and at the scan's rt 1, and
   ``binarize_spread_flat`` as one launch against its plain path and
   against the kernel at rt 0 with the caller's old passes), the
   layered path against the two-kernel path at the default shape
   (bitwise), and the block DFT, pair LLR and the int8 and bf16 bin
   matmuls at D = 504 (on the log-mel scan's own map, spectra and banks,
   a second ``fft_block_dft``, ``fft_binmm`` and ``fft_binmm_int8``
   entry in the kernels line, tagged by ``shape``).  Kernel 3 (TMA +
   wgmma, the DFT basis resident in shared memory) is held within one
   bf16 step of its plain version with two launches bitwise equal at
   both widths; the map's cast to bf16 that feeds it is timed too.
   Kernel 6 (TMA + int8 wgmma) takes the bank's K-major
   copy of W2 and block spectra whose rows are padded to 16 bytes; it is
   held bitwise at both shapes (two launches bitwise equal) and timed
   over loops of 100 launches, and bitwise at 54 small shapes (2m not a
   multiple of 64, K not of 256, D = 8, 40, 504 and 2048, +-127 inputs
   at 2D = 4096), where operands TMA cannot take must raise.  The
   direct correlation kernel (TMA + wgmma, resident frame panels) runs at the
   reference's bench shape (8 maps of T = 3000 frames of the scan's
   frontend, K = 1024, L = 32, D = 2048) and at one of those maps (B =
   1, the pallas API path's launch), two rows tagged by ``shape``, each
   held to two launches bitwise equal; its yardstick is ``conv1d`` in
   bf16.
   The DTW kernel (kernels 12 and 13: the LLR tile in, the score out,
   one launch for every route) is held bitwise (finite scores, -inf
   alike) to its plain twin on the scan's pair-LLR tiles with the winner
   ids as c rows, and its raw mode (cost tile in, terminals out) to
   ``banded_dtw_plain``; the unfused stage (the cost prologue, the
   raw kernel, the score's ops) is timed beside the one launch, the map
   route's device ops are read from a trace (nothing may run between
   ``pair_llr``'s kernel and the DTW kernel), and rows 12 and 13 are
   printed beside their targets (0.006 and 0.012 ms).
   It also runs every kernel once at small ragged shapes (partial
   tiles, odd nfft, an utterance with no valid row, ties and -0.0,
   DTW at L = 1, 32, 48, 96, 128, 200 and 256 and m 1024 with ragged
   segment lengths and band 1, the DTW kernel's fused mode at L 96, m
   1024, band 100 at L 32, L 1, L 256, the gathered route's m 38 and the
   exhaustive route's strided view of a GEMM output, LLR windows past the
   map's end, F = 39 and 63, the radix select
   bitwise at 12 shapes (F 39, 63, 64, 511 and 512, valid 0, 1, T - 1
   and T, ties, one-value planes, an unaligned base) x 4 quantiles x 3
   schedules and at ``FrontendConfig(nfft=1024)``'s planes of all 8
   utterances (F 512, 201 MB), correlation at K = 1, 3 and 129, D = 40, 504 and 2048, T''
   not a multiple of its 192-start tile, L = 1, 9, 17, 32, 48 and T
   (two launches bitwise equal), the
   TMA + wgmma bin matmul at m = 1, 63, 64, 65, 96 x D = 8, 40, 504 x
   K = 8, 136 x bins = 1, 3, the 4-D input, the block DFT at three
   utterances whose last window overruns T x D = 504, 40, 8 x nfft =
   159, 39, 223, 319 (two launches bitwise equal; B 0 raises; D 500 and
   a misaligned base are padded to D8 and held as close), the TMA + wgmma iDFT at
   2 bins = 40, 160 x hop = 32, 128, 224 x K = 8, 136, 1024 x m = 1,
   3, 192 and at hop 30, and misaligned base pointers that must raise)
   and holds it against its plain version.  Kernel 2 (16-CTA clusters
   that walk the (plane, utterance) pairs, a pair's plane resident in
   distributed shared memory; a multipass variant for planes past its
   capacity) is
   held bitwise, map and keys, at 74 ragged shapes (T not a multiple of
   16, F not of 32, an utterance with no valid row, ranks 0 and past the
   valid count, ties and -0.0, rf and rt 0..2, T at the cluster
   variant's capacity and one row past it), each launch's variant held
   to the wrapper's shape rule and the kernel's own; its
   ``cudaOccupancyMaxActiveClusters`` and the multipass variant's time
   one row past the capacity are printed.  Kernel 1 (the DFT as three
   TF32 passes on the tensor cores) is held at 34 shapes (1 to 24,576
   rows, nfft 256 to 4096, frame lengths 398 and 400, n_mels 0 to 484)
   to the float64 planes: within 1e-5 scaled on the well-conditioned
   cells and within its error bound on every cell, the plain version
   within its fp32 bound (the kernel-to-plain scaled error is printed,
   not held: the plain GEMM is itself up to 1.4e-5 off float64 at a few
   hundred rows); its rows of the kernels line carry the bound of three
   TF32 passes (``tf32_bound_ms``) beside the fp32 one.
   ``FrontendConfig(nfft=1024)`` runs through both frontend paths to one
   map that differs from the plain run's in at most 1e-3 of its cells
   (the frontend's parity contract), and so do the maps of the whole
   corpus in both frontend modes; the whole scorer is held to the f32
   plain path and must enqueue behind a queued device sleep without
   waiting for the device;
3. drives the scan itself, ``detect_corpus_stream``, at full width over
   19 utterances of 30 s (two batches of 8 and a tail of 3 padded to
   4, whose padding row has no valid frame), with every launch count
   set to 0 just before and read just after, and holds its detections
   against the same scan on the plain versions (>= 99% matched peaks
   with the same template, scores within their class): first the
   default scan (bf16 spectra), then the scan with DTW rescoring
   (config 4, verify-the-winner) on int8 template spectra (config 5),
   whose traced device time a batch is printed.  The default scan is
   also run with a manifest (``checkpoint.ScanManifest``): recorded
   whole, reloaded whole with no step, and failed in ``compute`` after 2
   of its 3 batches, then resumed (one step, each scan kernel launched
   once), each bitwise the clean scan; and with the PCM16 upload
   (``SCAN_UPLOAD_INT16=1``) on the corpus snapped to the PCM16 grid,
   bitwise the float upload, the uploads' traced ms a batch of both.
   A map cell that ties its threshold may flip between two fp32
   evaluations of the planes and moves every score whose window holds
   it by a whole LLR term: such matches, at most ``MAX_EXEMPT`` of
   them, are left out of the score class;
4. runs the exhaustive DTW rescore (``DTWConfig.top_r = 0``: every peak
   against all 1024 templates) on one batch of 8 against the plain
   versions, and traces it once: the fp32 GEMM's share of the device
   time, the DTW kernel's and the elementwise kernels';
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
   against the CPU's rescore of the same peaks within 1e-5 x max|score|;
7. trains banks on the card (config 3) at the soak shape of ``soak.py``
   (``SOAK_UTTS`` utterances a group, 4 groups of 25/50/75/100 phones,
   seeds 100-103; the exemplars of aa and iy; F 256, E 8, K 4 components
   x R 4 restarts, 30 EM iterations) and scans with them: the exemplar
   maps (``pipeline._clip_feature_maps``, kernels 1 and 2 on 128 clips a
   call) against the plain run's (<= 1e-3 of cells; the last chunk's
   rows of no valid sample empty in both); ``bernoulli_mixture_em_restarts``
   with tol 0 on one registered stack on the card and on the CPU (the
   same winner, means within rtol 1e-4 / atol 1e-5, histories within
   rtol 1e-4 / atol 1e-3, never falling by more than 1e-3); ``train_bank``,
   ``TemplateBank.save`` and ``load``, and ``detect_corpus_stream`` of the
   19 utterances with the loaded bank against its plain run; a parts
   bank (``PartsConfig(enabled=True)``): the codes of the card and the
   CPU on one dictionary (< 1e-3 of locations apart), and
   ``detect_corpus`` routed to the per-utterance loop, against the plain
   loop; ``run_em_checkpointed`` (one fit, tol 0, chunks of 5) killed
   after its first chunk and resumed, bitwise the unbroken run and
   ``bernoulli_mixture_em`` on the card, and within the EM classes above
   of the CPU's; ``classify_segments`` with the trained bank over the
   corpus's labelled aa / iy spans, sliding against the CPU and DTW
   against its plain version (identical predictions, scores within
   1e-5 x max|score|), the DTW kernel held bitwise and timed at
   classification's shape (its own ``shape`` row in the kernels line),
   and the CLI's ``classify`` on the card, both routes.  It prints the
   exemplar-map rate, EM's ms an iteration beside its bytes bound,
   ``learn_parts``' wall, the coding rate, ``train_bank``'s wall with
   and without parts, checkpointed EM's ms and classification's
   segments a second on each route;
8. scans at template lengths past kernel 3's one-pass plans
   (``shapes_phase``): random banks of K 1024 at L 48 and L 80 and of K
   4096 at L 33 (nfft 239, 399 and 240: two resident passes of the
   basis, four streamed, two resident); kernel 3 on the scan's map at
   each (and alone at L 103, nfft 518, six streamed passes of 96
   columns, and at L 256 of K 4096, nfft 1791), kernels 4 and 5 on its spectra and kernel 6 on them
   quantized (rows tagged by ``shape``); ``detect_corpus_stream`` over
   the 19 utterances with each bank, the default scan, at K 4096 also on
   int8 spectra, at L 80 also DTW + int8, with the launch counts set to
   0 just before each and read just after, each against its plain run
   under ``check_scan_scores``' classes; the L 80 DTW scan's pair-LLR
   operands and DTW tiles (the ring route) held to their plain versions;
   the DTW kernel at L 300, band 6, raw and fused, bitwise;
9. inputs the kernels refused before and the reference scores
   (``domain_phase``; ``python3 chip_smoke.py --domain`` runs the build
   and this phase alone), each on its kernel with the launch counts
   set to 0 just before the call and read just after, against its plain
   version: kernel 1's mel mode at n_mels 485 (nfft 1024) and 968 (nfft
   2048), two and three launches a call, planes against float64 and
   the map of ``frontend_batch_flat`` (the two-kernel and the layered
   path) <= 1e-3 of cells unlike the plain run's, and n_mels 129 forced
   into chunks of 50 filters bitwise the one launch; the DTW kernel's
   wide route at windows 601 and 1101 (132 pairs), raw and fused
   bitwise, and with its state in scratch; kernels 10, 11, 3 and 4 at D
   500 and 36 and at a base one element off (their wrappers pad to D8;
   rows tagged by ``shape`` at D 500, the padding copy timed, none at D
   504), the FFT scorer with D 36 banks on bf16 and int8 spectra; kernel
   10 at B*T'' just past 2^31 (D 8, 34 GB of map, every utterance
   against the plain version) and at L*D past 2^31;
10. runs the port's TIMIT input on a synthetic TIMIT tree that
   ``io.fixtures.write_synthetic_timit`` writes (TIMIT's 1,680 TEST
   utterances; 1,024 TRAIN, cut from TIMIT's 4,620; 16 phones, ~3 s, an
   utterance): decodes it with the native and the Python readers
   (bitwise equal); trains an aa / iy bank on ``TimitAdapter(split=
   "TRAIN")`` (kernels 1, 2); scans the TEST split with that bank (K 2,
   carried as K 8 on the card) and with the random K 1024 bank, with the
   launch counts set to 0 just before and read just after, each scan
   bitwise the same scan over the decoded waveforms in memory, the
   ``SCAN_UPLOAD_INT16=1`` upload bitwise the float upload, and >= 99%
   matched peaks with the same template against the plain scan; prints
   audio-s/s with and without the decode and each scan's device busy
   share over its ~211 batches; traces the exact loop over 8 TEST
   utterances with ``utils.profiling.profile_trace`` (the Chrome trace
   must hold the loop's ``frontend``, ``score`` and ``nms`` ranges and
   kernels 1 and 2); runs ``python -m template_speech_recognition_tpu_torch``
   ``train`` -> ``evaluate --tensorboard DIR`` -> ``classify --dtw`` on
   ``timit:<root>`` (64 utterances), a process each, and ``classify
   --dtw`` once more in this process (the DTW kernel's launches); holds
   the classic per-map edge helpers of ``ops.edges`` on ``cuda`` against
   kernel 2's map of kernel 1's planes for one batch of the TEST scan
   (threshold ties exempt); and prints ``roofline_report`` of kernel 10
   (``CostModel.direct_scores``) and ``CostModel.frontend_fused_roofline``
   with the card's SM count and SM clock.  The peak rates behind every
   bound come from ``utils/profiling.py``;
11. runs ``verify_cuda.py`` (``verify_phase``, right after the bench
   phase; ``python3 chip_smoke.py --verify`` runs the build and it
   alone): ``verify_tpu.py``'s 15 checks against the NumPy oracle, each
   traced, its kernels launched and among the device operations; the
   ``PARITY_CUDA.json`` it writes (to a temporary directory) has
   ``PARITY_TPU.json``'s keys and this card, every check passed;
12. runs ``soak.py`` and ``soak_bank10k.py`` on the card (``soak_phase``,
   after training, on its soak corpus and trained bank; ``python3
   chip_smoke.py --soak`` runs the build and it alone, training a bank
   as ``soak.py`` does): ``soak_cuda``'s fault -> resume -> clean runs
   of ``detect_corpus_sharded`` at mesh (1, 1, 1) over the 300
   utterances in batches of 32, for the default config and DTW + int8,
   each resumed bitwise the clean scan with the fault after half the
   batches; then the bank inflated to K 10,000 (``inflate_bank``) on
   bf16 and int8 spectra in batches of 8, each against its plain run
   (``check_scan_scores``, 4e-3) and against ``detect_corpus_stream``
   (times and ids identical, scores rtol 1e-4, atol 1e-3), its peak
   ``max_memory_allocated`` printed; kernels 4, 5 and 6 on the stream's
   first batch at K 10,000 (``shape`` rows, their launches the sharded
   scan's);
13. runs the multi-device entry points on this one card
   (``multichip_phase``, after the sharded phase; ``python3 chip_smoke.py
   --multichip`` runs the build and it alone): ``bench_scaling_cuda.py``
   (``bench_scaling.py``'s report: NCCL in a world of one, axis
   bank) for the conv and fft backends, each line with the reference's
   keys, this card's ``nvidia-smi`` line and the gathered scores within
   their class of the unsharded twin, and kernels 3, 4 and 5 at its shape
   (D 512, K 1024; ``shape`` rows); ``multichip_cuda.py N
   --gloo-on-one-card`` (``__graft_entry__.py``'s dry run) at 4 and 8
   ranks, every sharded path held against its twin on every rank and
   each rank's FFT path (kernels 3, 4, 5) and DTW scan (kernels 1, 2, 11,
   12) launched; ``soak_bank10k_cuda``'s fake mesh (K 10,000 on a (2, 2,
   2) mesh of 8 gloo ranks against the single-device stream in the
   reference's contract), each rank's peak memory printed, and kernels 4
   and 5 at a bank rank's K-shard of 5,000 (``shape`` rows, their
   launches rank 0's).  Ranks sharing the card are time-sliced: their
   times are no multi-GPU number.

The default, the DTW + int8 and the two log-mel scans are each run once
more under ``torch.profiler``: the union of the device intervals in
the scan loop, set against the untraced loop's wall time, is the
device's busy share; the device operations a batch (for the DTW + int8
scan beside its 118.7 with the DTW stage's elementwise ops), the block
DFT's device time a batch and share, and the copy kernels' (the map's
cast to bf16 among them), are printed by name.

Any failed check exits non-zero without printing the result line.  The
last three lines are the kernels JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from card_checks import (
    MAX_EXEMPT,
    TRAIN_PHONES,
    CheckFailed,
    card_line,
    check,
    check_scan_scores,
    device_events,
    device_op_names,
    free_port,
    launch_ranks,
    map_flips,
    match_detections,
    same_detections,
)

SEED = 0
B, SECONDS, N_UTT = 8, 30.0, 19
K, L = 1024, 32
T_BENCH = 3000             # frames per utterance of the reference's bench.py
# the H100's peak rates (device memory bytes/s; fp32, bf16 and TF32 flops
# and int8 ops a second, dense): set by ``use_h100_peaks`` from the port's
# utils/profiling.py, which keeps them beside the card they belong to
HBM_BPS = FP32_FLOPS = BF16_FLOPS = TF32_FLOPS = INT8_OPS = None
STEMS = ("frontend_planes", "select_binspread", "fft_block_dft", "fft_binmm", "fft_idft",
         "banded_dtw", "pair_llr", "fft_binmm_int8", "radix_select", "binspread", "correlation")
# kernels each scan must launch (launch-count names)
SCAN_KERNELS = ("frontend_planes", "select_binspread", "fft_block_dft", "fft_binmm",
                "fft_idft")
MEL_KERNELS = ("frontend_planes_mel", "radix_select", "binspread", "fft_block_dft",
               "fft_binmm", "fft_idft")
# the two shapes at which the kernels line reports fft_block_dft
DFT_BENCH = "bench: B 8, T 3072, D 2048, nfft 159"
DFT_MEL = "log-mel: B 8, T 3072, D 504, nfft 159"
# the two shapes at which the kernels line reports fft_binmm
BINMM_BENCH = "bench: bins 80, m 192, D 2048, K 1024"
BINMM_MEL = "log-mel: bins 80, m 192, D 504, K 1024"
# the two shapes at which the kernels line reports fft_binmm_int8
INT8_BENCH = "bench: bins 80, m 192, D 2048, K 1024"
INT8_MEL = "log-mel: bins 80, m 192, D 504, K 1024"
# the variant and shape at which the kernels line reports select_binspread
SELBIN_BENCH = "cluster: P 4, B 8, T 3072, F 256"
# the two shapes at which the kernels line reports correlation
CORR_BENCH = "bench: B 8, T 3000, K 1024, L 32, D 2048"
CORR_ONE = "one utterance: B 1, T 3000, K 1024, L 32, D 2048"


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


def traced_device_ms(torch, fn):
    """Device time of ``fn`` from a ``torch.profiler`` trace: the union of
    its device intervals (kernels, copies, memsets) in ms, the device ms
    by name and the number of device operations; (None, {}, 0) if the
    trace holds no device event.  Unlike events around a stage, the union
    leaves out the gaps in which the device waits for the host to
    enqueue."""
    dev_events = device_events(torch, fn)
    if not dev_events:
        return None, {}, 0
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return busy / 1e3, by_name, len(dev_events)


def report_busy(torch, say, label, run, build, ctr):
    """The scan loop's device time (a traced run of the whole scan less a
    traced bank build) against the loop wall of the untraced run, and the
    five names with the most device time in the loop."""
    total, names, n_ops = traced_device_ms(torch, run)
    built, built_names, n_built = traced_device_ms(torch, build)
    if total is None or built is None:
        say(f"{label}: device busy share not measured (the trace holds no device event)")
        return None
    loop_ms = ctr["time_scan_s"] * 1e3
    scan_ms = total - built
    for name, ms in built_names.items():
        names[name] = names.get(name, 0.0) - ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    nb = ctr["batches"]
    dft = sum(ms for n, ms in names.items() if "block_dft" in n)
    cast = sum(ms for n, ms in names.items() if "direct_copy" in n)
    say(f"{label}: device time in the scan loop {scan_ms:.3f} ms ({scan_ms / nb:.3f} "
        f"ms a batch; torch.profiler, the bank build's {built:.3f} ms left out) = "
        f"{scan_ms / loop_ms:.3f} of the untraced loop's {loop_ms:.3f} ms; "
        f"{(n_ops - n_built) / nb:.1f} device ops a batch; most device time: "
        + ", ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in top)
        + f"; the block DFT kernel (fft_block_dft) {dft / nb:.4f} ms a batch, "
          f"{dft / scan_ms:.3f} of the device time; copy kernels (direct_copy: dtype casts, "
          f"the map's to bf16 among them) {cast / nb:.4f} ms a batch")
    return (n_ops - n_built) / nb


def use_h100_peaks() -> None:
    global HBM_BPS, FP32_FLOPS, BF16_FLOPS, TF32_FLOPS, INT8_OPS
    from template_speech_recognition_tpu_torch.utils import profiling as prof

    HBM_BPS, FP32_FLOPS = prof.HBM_BYTES_PER_S, prof.PEAK_FP32_FLOPS
    BF16_FLOPS, TF32_FLOPS, INT8_OPS = (prof.PEAK_BF16_FLOPS, prof.PEAK_TF32_FLOPS,
                                        prof.PEAK_INT8_OPS)


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / rate * 1e3 if ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Corpus:
    """``n`` utterances of exactly ``samples`` samples cut from the
    synthetic fixture corpus (oracle/fixtures.py) of ``phones`` phones
    each; past ``distinct`` of them the first ones repeat, under ids of
    their own.  By default N_UTT distinct utterances of SECONDS s, so
    every one lands in the 491,520-sample bucket (T_pad = 3072)."""

    def __init__(self, seed: int, n: int = N_UTT, samples: int = int(SECONDS * 16000),
                 phones: int = 180, distinct: int | None = None):
        from oracle.fixtures import make_synthetic_corpus

        self.sample_rate = 16000
        base = make_synthetic_corpus(num_utterances=min(n, distinct or n),
                                     phones_per_utterance=phones, seed=seed)
        pool = []
        for u in base.utterances:
            check(len(u.waveform) >= samples,
                  f"synthetic utterance of {len(u.waveform)} samples, {samples} wanted")
            phones_in = [(p, s, e) for (p, s, e) in u.phones if e <= samples]
            pool.append((u.utt_id, np.ascontiguousarray(u.waveform[:samples]), phones_in))
        self.utts = [pool[i] if i < len(pool) else
                     (f"{pool[i % len(pool)][0]}.{i // len(pool)}", *pool[i % len(pool)][1:])
                     for i in range(n)]

    def iter_utterances(self):
        yield from self.utts

    @staticmethod
    def held(utts, sample_rate: int = 16000) -> "Corpus":
        """Given (utt_id, waveform, phones) triples, held in memory."""
        out = object.__new__(Corpus)
        out.sample_rate, out.utts = sample_rate, list(utts)
        return out

    def head(self, n: int) -> "Corpus":
        return Corpus.held(self.utts[:n], self.sample_rate)


def scan_rates(torch, corpus, bank, cfg, reps: int, dev, **kw) -> list[float]:
    """The audio-s/s of ``reps`` scans of ``corpus`` (``detect_corpus_stream``'s
    ``counters["audio_s_per_s"]``: audio seconds over the scan loop's
    wall, the bank build excluded), after a warm-up scan of all of it (a
    warm-up of one batch leaves the first timed scan ~1.3x slow)."""
    from template_speech_recognition_tpu_torch.scan import detect_corpus_stream

    def scan(utts):
        res = detect_corpus_stream(utts, bank, cfg, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(res.counters["audio_s_per_s"])

    scan(corpus)
    return [scan(corpus) for _ in range(reps)]


def check_planes(torch, frames, nfft, got, want, name, sample_rate=0, n_mels=0,
                 min_share=0.5):
    """Kernel 1 (``frontend_kernel.planes_metrics``): on the
    well-conditioned cells its planes within 1e-5 (scaled by max|plain|)
    of the float64 planes; on every cell the kernel within its error
    bound of float64 (fp32 summation plus the 3-pass TF32 split) and the
    plain version within its fp32 bound.  The plain version is the
    function's definition, but not an accuracy yardstick at 1e-5: its
    cuBLAS GEMM is itself up to 1.4e-5 (scaled) off float64 at a few
    hundred rows, so the kernel-to-plain scaled error is printed only.
    Returns the metrics."""
    from template_speech_recognition_tpu_torch.ops.frontend_kernel import planes_metrics

    m = planes_metrics(frames, nfft, got, want, sample_rate, n_mels, split=True)
    check(m["share"] > min_share, f"{name}: too few well-conditioned cells ({m['share']})")
    check(m["scaled64"] <= 1e-5, f"{name}: scaled error against float64 {m['scaled64']} > 1e-5")
    for label, key in (("kernel", "head"), ("plain", "plain_head")):
        check(m[key] <= 1.0, f"{name}: {label} off the float64 planes by {m[key]:.3g} x "
                             "its error bound")
    return m


def float64_text(m) -> str:
    """The errors of ``planes_metrics``, for a log line."""
    return (f"against float64: kernel scaled {m['scaled64']:.3g} (tolerance 1e-5), "
            f"{m['head']:.4g} of its error bound; plain {m['plain_scaled64']:.3g}, "
            f"{m['plain_head']:.4g} of its fp32 bound; kernel vs plain scaled "
            f"{m['scaled']:.3g} (printed only) on {m['share']:.3f} of the cells")


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


SPLIT_TOL = "hi 2^-7 * max|ref|, hi + lo 1e-4 * max|ref|"


def binmm_row(torch, k4, record, xr, xi, w2, shape, plain_kw=None):
    """Kernel 4 on bf16 spectra (its hi and lo planes) against its plain
    version: hi within one bf16 step (2^-7) of max|ref|, hi + lo within
    1e-4 of it (the fp32 sums in another order), two launches bitwise
    equal; timed over loops of 10 launches behind a device sleep (the
    device's time, not the wrapper's host time) beside its plain version
    and ``torch.bmm`` on the packed operand (one bf16 plane out).
    Returns the kernel's output [2, 2, bins, m, K]."""
    got = k4.fft_binmm(xr, xi, w2)
    ref = k4.fft_binmm_plain(xr, xi, w2)
    top = float(ref[0].float().abs().max())
    err_hi = float((got[0].float() - ref[0].float()).abs().max())
    err = float((got.float().sum(0) - ref.float().sum(0)).abs().max())
    check(err_hi <= 2.0 ** -7 * top, f"fft_binmm ({shape}): hi {err_hi} > 2^-7 * {top}")
    check(err <= 1e-4 * top, f"fft_binmm ({shape}): hi + lo {err} > 1e-4 * {top}")
    check(bool(torch.equal(got, k4.fft_binmm(xr, xi, w2))),
          f"fft_binmm ({shape}): two launches differ")
    del ref
    bins_, d_, k_ = xr.shape[0], xr.shape[-1], w2.shape[-1]
    m_ = xr.numel() // (bins_ * d_)
    xr3, xi3 = xr.reshape(bins_, m_, d_), xi.reshape(bins_, m_, d_)
    x2 = torch.cat([torch.cat([xr3, xi3], 2), torch.cat([xi3, -xr3], 2)], 1)
    record(
        k4, err, SPLIT_TOL, time_ms(torch, lambda: k4.fft_binmm(xr, xi, w2), loop=10),
        time_ms(torch, lambda: k4.fft_binmm_plain(xr, xi, w2), **(plain_kw or {})),
        time_ms(torch, lambda: torch.bmm(x2, w2)),
        2 * bins_ * m_ * d_ * 2 + w2.numel() * 2 + 2 * (2 * bins_ * m_ * k_ * 2),
        2 * (2 * m_) * (2 * d_) * k_ * bins_, BF16_FLOPS, shape=shape,
    )
    return got


def idft_row(torch, k5, record, y2, imat, c, nblk_, shape, loop=100, plain_kw=None):
    """Kernel 5 on ``y2`` [rows, m*K] (a bf16 ``ycat``: 4 bins rows, with
    ``imat`` stacked twice) against its plain version, 1e-5 of max|ref|
    (fp32 sums in another order); timed beside the library GEMM with
    fp32 output where this PyTorch has that overload of ``mm`` (the
    kernel's bytes written, without the reassembly and + c), else the
    bf16-output ``matmul`` (half the bytes).  Returns the library call's
    name."""
    k_ = c.numel()
    sc = k5.fft_idft(y2, imat, c, nblk_)
    ref = k5.fft_idft_plain(y2, imat, c, nblk_)
    err, top = float((sc - ref).abs().max()), float(ref.abs().max())
    check(err <= 1e-5 * top, f"fft_idft ({shape}): {err} > 1e-5 * {top}")
    m_, hop_ = y2.shape[1] // k_, sc.shape[1] // nblk_
    del sc, ref
    imat_t = imat[:, :hop_].t().contiguous()
    try:
        torch.mm(imat_t, y2[:, :8], out_dtype=torch.float32)
        lib, name = (lambda: torch.mm(imat_t, y2, out_dtype=torch.float32)), "torch.mm, fp32 out"
    except (TypeError, RuntimeError):
        lib, name = (lambda: torch.matmul(imat_t, y2)), "torch.matmul, bf16 out, half the bytes"
    record(
        k5, err, "1e-5 * max|ref|", time_ms(torch, lambda: k5.fft_idft(y2, imat, c, nblk_),
                                            loop=loop),
        time_ms(torch, lambda: k5.fft_idft_plain(y2, imat, c, nblk_), **(plain_kw or {})),
        time_ms(torch, lib, loop=loop),
        y2.numel() * 2 + imat.numel() * 2 + k_ * 4 + m_ * hop_ * k_ * 4,
        2 * y2.shape[0] * hop_ * m_ * k_, BF16_FLOPS, shape=shape,
    )
    return name


def correlation_bench(torch, kc, flat, wflat, cf, record, say):
    """Kernel 10 at the reference's bench shape (bench.py: B = 8 maps of
    T = 3000 frames, K = 1024, L = 32, D = 2048, bf16): the scan's
    frontend maps cut to T frames (their real sparsity), the random
    bank's flat LLR filter.  Held against the plain f32 version on the
    same bf16 operands within 1e-5 x max|score|: both sum the same exact
    products (binary x bf16) in float32, in different orders; two
    launches on the same inputs must be bitwise equal (no split of the
    contraction).  Then the same at one utterance (B = 1, the pallas API
    path's launch), a second row tagged by ``shape``.  Returns the bf16
    maps [B, T, D]."""
    b, d = flat.shape[0], flat.shape[2]
    x = flat[:, :T_BENCH].to(torch.bfloat16).contiguous()
    w16 = wflat.to(torch.bfloat16).contiguous()
    k, length = w16.shape[0], w16.shape[1]
    tv = T_BENCH - length + 1
    wt = w16.transpose(1, 2).contiguous()                        # conv1d's [K, D, L]
    for xs, shape in ((x, CORR_BENCH), (x[:1].contiguous(), CORR_ONE)):
        bs = xs.shape[0]
        got = kc.correlation_scores(xs, w16, cf)
        check(bool(torch.equal(got, kc.correlation_scores(xs, w16, cf))),
              f"correlation ({shape}): two launches differ")
        want, plain_ms = time_once(torch, lambda: kc.correlation_scores_plain(xs, w16, cf))
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), "correlation: scores not finite")
        check(err <= 1e-5 * top, f"correlation ({shape}): {err} > 1e-5 * {top}")
        del got, want
        xt = xs.transpose(1, 2).contiguous()                     # conv1d's [B, D, T]
        record(
            kc, err, "1e-5 * max|plain|",
            time_ms(torch, lambda: kc.correlation_scores(xs, w16, cf)),
            plain_ms,
            time_ms(torch, lambda: torch.nn.functional.conv1d(xt, wt)),   # bf16 out
            xs.numel() * 2 + w16.numel() * 2 + k * 4 + bs * k * tv * 4,
            2 * bs * k * tv * length * d, BF16_FLOPS, shape=shape,
        )
        del xt
        say(f"correlation ({shape}; {float(xs.float().mean()):.4f} of the map set): "
            f"max|score| {top:.6g}, two launches bitwise equal; plain timed once")
    return x


def selbin_planes(torch, dev, rng, p, b, t, f):
    """Random planes with ties (the first third of the rows quantised to
    0.25) and a run of -0.0."""
    x = rng.standard_normal((p, b, t, f)).astype(np.float32)
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
    x[:, :, min(5, t - 1), : min(7, f)] = -0.0
    return torch.from_numpy(x).to(dev)


def selbin_checks(torch, dev, k2, fp, say):
    """Kernel 2 bitwise (map and keys) against its plain version at
    ragged shapes, with the variant each launch took held to the
    wrapper's shape rule: T = 256, 200, 37, 5 (not all multiples of 16)
    x F = 128, 100, 36, 4 (multiples of 4, not of 32), an utterance with
    no valid row, ranks 0 and past the valid count, ties and -0.0, q 0.3
    and 0.98, rf and rt 0, 1, 2; then T at the cluster variant's capacity
    (F = 256) and one row past it, so both variants launch."""
    rng = np.random.default_rng(SEED + 2)
    launched = {"cluster": 0, "multipass": 0}

    def one(planes, need, valid, rf, rt, label):
        p, b, t, f = planes.shape
        want = k2.route(t, f)
        check(k2.cluster_fits_on_card(t, f) == (want == "cluster"),
              f"select_binspread {label}: the wrapper's route and the kernel's shape rule differ")
        before = dict(k2.route_launches)
        fk, kk = k2.select_binspread(planes, need, valid, rf, rt)
        fr, kr = k2.select_binspread_plain(planes, need, valid, rf, rt)
        ran = [v for v in before if k2.route_launches[v] != before[v]]
        check(ran == [want], f"select_binspread {label}: ran {ran}, the rule says {want}")
        check(bool(torch.equal(fk, fr)) and bool(torch.equal(kk, kr)),
              f"select_binspread {label} ({want}): {int((fk != fr).sum())} cells and "
              f"{int((kk != kr).sum())} keys differ (bitwise)")
        launched[want] += 1

    n = 0
    for t, f in ((256, 128), (200, 100), (37, 36), (5, 4)):
        planes = selbin_planes(torch, dev, rng, 4, 4, t, f)
        valid = torch.tensor([t, t // 2, min(7, t), 0], dtype=torch.int32, device=dev)
        for q in (0.3, 0.98):
            need = fp._dual_ranks(valid, f, q)
            need[2, 0] = 0                               # rank 0 selects key 0
            need[1, 1] = int(valid[1]) * f + 5           # past the valid cells
            for rf in (0, 1, 2):
                for rt in (0, 1, 2):
                    one(planes, need, valid, rf, rt, f"T {t} F {f} q {q} rf {rf} rt {rt}")
                    n += 1
    t_cap = 16 * max(r for r in range(1, 400) if k2.route(16 * r, 256) == "cluster")
    for t in (t_cap, t_cap + 1):
        planes = selbin_planes(torch, dev, rng, 4, 2, t, 256)
        valid = torch.tensor([t, t - 100], dtype=torch.int32, device=dev)
        one(planes, fp._dual_ranks(valid, 256, 0.98), valid, 1, 1, f"T {t} F 256")
        n += 1
    check(launched["cluster"] > 0 and launched["multipass"] > 0,
          f"select_binspread: both variants must launch, got {launched}")
    say(f"select_binspread: bitwise (map and keys) at {n} ragged shapes, launches by variant "
        f"{launched}; the cluster variant's capacity at F = 256 is T = {t_cap} "
        f"(T = {t_cap + 1} takes the multipass variant)")


def int8_checks(torch, dev, k4, fs, say):
    """Kernel 6 (TMA + int8 wgmma) bitwise against its plain version:
    2m not a multiple of 64, K not of 256, D = 8, 40, 504 and 2048 (rows
    padded to 16 bytes, as the scorer writes them) at 48 shapes; the
    scorer's own 4-D operands from ``quantize_block_spectra``; +-127
    everywhere at 2D = 4096, where row 0 meets the bound 2D x 127^2;
    two launches bitwise equal; the wrapper's own K-major copy; and the
    operands TMA cannot take (rows of 504 bytes, K not a multiple of 8)
    must raise."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def operands(bins, m, d, k):
        buf = torch.zeros((2, bins, m, k4.int8_row_width(d)), dtype=torch.int8, device=dev)
        buf[..., :d] = torch.randint(-127, 128, (2, bins, m, d), dtype=torch.int8, device=dev,
                                     generator=g)
        w2 = torch.randint(-127, 128, (bins, 2 * d, k), dtype=torch.int8, device=dev,
                           generator=g)
        return buf[0, ..., :d], buf[1, ..., :d], w2, torch.rand(bins, k, device=dev,
                                                               generator=g) * 1e-3

    n = 0
    for m in (1, 33, 50, 97):
        for d in (8, 40, 504, 2048):
            for k in (8, 136, 264):
                xr, xi, w2, sc = operands(2, m, d, k)
                w2t = k4.kmajor_spectra(w2)
                got = k4.fft_binmm_int8(xr, xi, w2, sc, w2_kmajor=w2t)
                check(bool(torch.equal(got, k4.fft_binmm_int8_plain(xr, xi, w2, sc))),
                      f"fft_binmm_int8 (m {m}, D {d}, K {k}): not bitwise")
                n += 1
    for d in (40, 504):
        xf = [torch.randn(3, 2, 25, d, device=dev, generator=g) * 50 for _ in range(2)]
        w2 = torch.randint(-127, 128, (3, 2 * d, 136), dtype=torch.int8, device=dev, generator=g)
        xr, xi, sc = fs.quantize_block_spectra(*xf, torch.rand(3, 136, device=dev, generator=g))
        got = k4.fft_binmm_int8(xr, xi, w2, sc, w2_kmajor=k4.kmajor_spectra(w2))
        check(bool(torch.equal(got, k4.fft_binmm_int8_plain(xr, xi, w2, sc))),
              f"fft_binmm_int8 (4-D, D {d}): not bitwise")
        check(bool(torch.equal(k4.fft_binmm_int8(xr, xi, w2, sc), got)),
              f"fft_binmm_int8 (4-D, D {d}): the wrapper's own K-major copy differs")
        n += 2
    # +-127: templates 0..63 align with row 0 of each bin
    d, k = 2048, 136
    xr, xi, w2, sc = operands(2, 64, d, k)
    for x in (xr, xi):
        x.copy_(torch.where(x >= 0, 127, -127).to(torch.int8))
    w2.copy_(torch.where(w2 >= 0, 127, -127).to(torch.int8))
    w2[:, :, :64] = torch.cat([xr[:, 0], xi[:, 0]], dim=1)[:, :, None]
    ones = torch.ones_like(sc)
    w2t = k4.kmajor_spectra(w2)
    got = k4.fft_binmm_int8(xr, xi, w2, ones, w2_kmajor=w2t)
    exact = k4.fft_binmm_int8_plain(xr, xi, w2, ones, out_dtype=torch.float32)
    check(float(exact[0, :, 0, :64].min()) == 2 * d * 127 * 127, "the +-127 case misses its bound")
    check(bool(torch.equal(got, k4.fft_binmm_int8_plain(xr, xi, w2, ones))),
          "fft_binmm_int8 (+-127, 2D = 4096): not bitwise")
    check(bool(torch.equal(k4.fft_binmm_int8(xr, xi, w2, ones, w2_kmajor=w2t), got)),
          "fft_binmm_int8: two launches differ")
    n += 2
    # what TMA cannot take
    xr, xi, w2, sc = operands(2, 50, 504, 136)
    for bad, why in (((xr.contiguous(), xi.contiguous(), w2, sc), "rows of 504 bytes"),
                     ((xr, xi, w2[..., :132].contiguous(), sc[:, :132].contiguous()), "K 132")):
        try:
            k4.fft_binmm_int8(*bad)
            check(False, f"fft_binmm_int8 took {why}")
        except ValueError:
            pass
    say(f"fft_binmm_int8: bitwise at {n} small shapes (hi and lo planes; 2m not a multiple "
        f"of 64, K not of 256, "
        f"D 8/40/504/2048, the scorer's 4-D operands, +-127 at 2D = 4096 meeting the bound "
        f"{2 * d * 127 * 127}); two launches bitwise; rows of 504 bytes and K 132 raise")


def dft_checks(torch, dev, k3, fs, say):
    """Kernel 3 at ragged shapes (the CPU tests' cases): three
    utterances whose last window overruns T (a read into the next
    utterance's rows would show), T not a multiple of hop, D 504 / 40 /
    8 (a partial d tile, a lone one), nfft 159 / 39 / 223 / 319 (319: the
    basis split into two passes), and L 45, 80 and 103 of a bank of 1024
    (nfft 236, 399, 518: two resident passes, then the basis streamed
    in four and six passes) and L 256 of a bank of 4096 (nfft 1791, 14
    streamed passes); each within 2^-7 x max|ref| of the plain
    version and two launches bitwise equal; shapes the kernel cannot take
    raise."""
    rng = np.random.default_rng(SEED + 3)
    n = 0
    for length, bank_k, t in ((32, 1024, 300), (8, 128, 250), (32, 4096, 500), (64, 1024, 700),
                              (45, 1024, 500), (80, 1024, 800), (103, 1024, 1000),
                              (256, 4096, 3400)):
        nfft = fs.pick_nfft(length, bank_k)
        hop = nfft - length + 1
        nblk = -(-(t - length + 1) // hop)
        cm, sm = fs._dft_mats(nfft, torch.bfloat16, dev)
        g = torch.cat([cm, -sm], dim=1).contiguous()
        for d in (504, 40, 8):
            x = torch.from_numpy(rng.random((3, t, d)) < 0.3).to(dev, torch.bfloat16)
            got = k3.fft_block_dft(x, g, nfft, hop, nblk)
            ref = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
            err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
            top = max(float(r.float().abs().max()) for r in ref)
            shape = f"B 3, T {t}, D {d}, nfft {nfft}, hop {hop}"
            check(err <= 2.0 ** -7 * top, f"fft_block_dft ({shape}): {err} > 2^-7 * {top}")
            check(all(bool(torch.equal(a, c)) for a, c in
                      zip(got, k3.fft_block_dft(x, g, nfft, hop, nblk))),
                  f"fft_block_dft ({shape}): two launches differ")
            n += 1
    cm, sm = fs._dft_mats(159, torch.bfloat16, dev)
    g = torch.cat([cm, -sm], dim=1).contiguous()
    try:
        k3.fft_block_dft(torch.zeros((0, 300, 64), dtype=torch.bfloat16, device=dev), g, 159,
                         128, 3)
        check(False, "fft_block_dft took B 0")
    except ValueError:
        pass
    # D 500 and a base 2 bytes off: the wrapper pads to an aligned D8
    # copy and launches the kernel, the plain version's values
    buf = torch.zeros(2 * 300 * 512 + 8, dtype=torch.bfloat16, device=dev)
    off = buf[1 : 1 + 2 * 300 * 512].view(2, 300, 512)
    off.copy_((torch.rand(2, 300, 512, device=dev) < 0.3).to(torch.bfloat16))
    for why, x in (("D 500", (torch.rand(2, 300, 500, device=dev) < 0.3).to(torch.bfloat16)),
                   ("a base 2 bytes off", off)):
        got = k3.fft_block_dft(x, g, 159, 128, 3)
        ref = k3.fft_block_dft_plain(x, g, 159, 128, 3)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        top = max(float(r.float().abs().max()) for r in ref)
        check(got[0].shape == ref[0].shape and err <= 2.0 ** -7 * top,
              f"fft_block_dft ({why}): {err} > 2^-7 * {top}")
    say(f"fft_block_dft: within 2^-7 x max|ref| at {n} ragged shapes (B 3, the last window "
        f"past T; D 504/40/8; nfft 159/39/223/319 and 236/399/518/1791 (L 45/80/103 of K "
        f"1024, L 256 of K 4096), 236 and 319 in two passes, 399 and up streamed), two launches "
        f"bitwise; D 500 and a base 2 bytes off (padded to D8) as close; B 0 raises")


# (B, P, T, F, valid, kind) of the radix select's small checks: F 39,
# 63, 64 and 511; valid 0, 1, T - 1, T and mixes; an unaligned base;
# ties, signed zeros, planes of one value
RADIX_SMALL = (
    (1, 4, 40, 39, [40], "random"), (3, 4, 33, 63, [32, 1, 0], "random"),
    (8, 4, 17, 64, [17, 16, 1, 0, 9, 3, 12, 5], "random"), (3, 2, 9, 511, [9, 8, 0], "random"),
    (1, 3, 50, 63, [49], "random"), (8, 2, 12, 39, [0, 1, 0, 1, 11, 12, 2, 0], "random"),
    (3, 4, 21, 511, [1, 20, 21], "random"), (1, 1, 130, 64, [129], "random"),
    (3, 4, 250, 63, [250, 83, 0], "ties"), (3, 4, 77, 63, [77, 1, 40], "equal"),
    (2, 4, 1000, 512, [999, 3], "random"), (3, 4, 33, 63, [32, 1, 0], "unaligned"),
)


def radix_checks(torch, dev, k8, fp, rng, say):
    """Kernel 8 (``radix_select``) bitwise against its plain version at
    ``RADIX_SMALL`` x quantiles 0, 0.3, 0.9 and 0.98; a base one float
    past 16-byte alignment is taken, shapes it cannot take raise."""
    n = 0
    for b, p, t, f, valid, kind in RADIX_SMALL:
        if kind == "ties":
            vals = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0], np.float32)
            x = vals[rng.integers(0, len(vals), (p, b, t, f))]
        elif kind == "equal":
            x = np.empty((p, b, t, f), np.float32)
            for i in range(p):
                x[i] = (0.5, -0.0, 0.0, -3.25)[i % 4]
        else:
            x = rng.standard_normal((p, b, t, f)).astype(np.float32)
            x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
            x[:, :, min(5, t - 1), :7] = -0.0
        if kind == "unaligned":
            pm = torch.zeros(x.size + 1, device=dev)[1:].view(x.shape)
            pm.copy_(torch.from_numpy(x))
            check(pm.data_ptr() % 16 == 4, "the misaligned planes are not misaligned")
        else:
            pm = torch.from_numpy(x).to(dev)
        vt = torch.tensor(valid, dtype=torch.int32, device=dev)
        for q in (0.0, 0.3, 0.9, 0.98):
            need = fp._dual_ranks(vt, f, q)
            want = k8.radix_select_plain(pm, vt, need)
            got = k8.radix_select(pm, vt, need)
            check(all(tuple(g.shape) == (b, p) and g.is_contiguous() for g in got)
                  and all(bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
                          for g, w in zip(got, want)),
                  f"radix_select (B {b}, P {p}, T {t}, F {f}, valid {valid}, {kind}, "
                  f"q {q}): not bitwise")
            n += 1
    for why, args in (
            ("F 0", (torch.zeros(4, 2, 8, 0, device=dev),)),
            ("non-contiguous", (torch.zeros(2, 4, 8, 63, device=dev).transpose(0, 1),)),
            ("float64", (torch.zeros(4, 2, 8, 63, device=dev, dtype=torch.float64),))):
        try:
            k8.radix_select(*args, torch.full((2,), 8, dtype=torch.int32, device=dev),
                            torch.ones(2, 2, dtype=torch.int32, device=dev))
            check(False, f"radix_select took planes it cannot take ({why})")
        except ValueError:
            pass
    say(f"radix_select: bitwise at {len(RADIX_SMALL)} small shapes x 4 quantiles ({n} "
        f"calls); F 0, non-contiguous and float64 planes raise")


def small_shape_checks(torch, dev, audio, k1, k2, k3, k4, k5, kp, kd, k8, k9, kc, fp, fs,
                       say):
    """Each kernel once at small ragged shapes (the CPU tests' sizes:
    nfft 256 -> F = 128, D = 1024, K = 128, L = 8 -> nfft 39, hop 32;
    the log-mel widths F = 39 and 63, D = 504), against its plain
    version on the same inputs."""
    from template_speech_recognition_tpu_torch.ops import _cuda

    rng = np.random.default_rng(SEED + 1)
    frames = torch.from_numpy(
        rng.standard_normal((4 * 128, 400)).astype(np.float32)).to(dev)
    check_planes(torch, frames, 256, k1.edge_response_planes(frames, 256),
                 k1.edge_response_planes_plain(frames, 256), "frontend_planes (small)")

    selbin_checks(torch, dev, k2, fp, say)

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
    dft_checks(torch, dev, k3, fs, say)
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
                    # hi within a bf16 step, hi + lo the fp32 sums
                    # within 1e-4 of max|ref|
                    got = k4.fft_binmm(a_r, a_i, w_s)
                    ref = k4.fft_binmm_plain(a_r, a_i, w_s)
                    close(got[0], ref[0], tol, f"fft_binmm (bins={nb}, m={mm}, D={dd}, K={kk})")
                    close(got.float().sum(0), ref.float().sum(0), 1e-4,
                          f"fft_binmm hi + lo (bins={nb}, m={mm}, D={dd}, K={kk})")
    a_r, a_i, w_s = rnd(3, 3, 32, 504), rnd(3, 3, 32, 504), rnd(3, 1008, 136)
    close(k4.fft_binmm(a_r, a_i, w_s), k4.fft_binmm_plain(a_r, a_i, w_s), tol,
          "fft_binmm (4-D input, B=3)")
    # a base pointer 2 bytes off, which TMA cannot take: the wrapper
    # pads to an aligned copy and launches the kernel
    off = rnd(3 * 96 * 40 + 8)[1 : 1 + 3 * 96 * 40].view(3, 96, 40)
    check(off.data_ptr() % 16 == 2, "the misaligned view is not misaligned")
    a_i, w_s = rnd(3, 96, 40), rnd(3, 80, 136)
    close(k4.fft_binmm(off, a_i, w_s), k4.fft_binmm_plain(off, a_i, w_s), tol,
          "fft_binmm (a base 2 bytes off)")
    ycat = torch.randn(2 * bins, m * k, device=dev).to(torch.bfloat16)
    icm, ism = fs._idft_mats(nfft, hop, torch.bfloat16, dev)
    imat = torch.cat([icm, -ism], dim=0).contiguous()
    c = torch.randn(k, device=dev)
    close(k5.fft_idft(ycat, imat, c, nblk), k5.fft_idft_plain(ycat, imat, c, nblk),
          1e-5, "fft_idft")

    # the TMA + wgmma iDFT at ragged shapes: 2 bins short of a 64-row
    # stage (40) and past two (160); hop short of a 64-row warpgroup tile
    # (32), at the bench's 128 and at 224 (the last 128-row tile ends
    # 32 rows short: the 3-D store map must clip there, not write into
    # block j + 1's rows); 30 (not a multiple of 8: imat padded); K short
    # of a 128-template tile (8, 136) and the bench's 1024; m of 1, 3
    # and 192 blocks; a ycat base 2 bytes off, which TMA cannot take
    for tb in (40, 160):
        for hp in (32, 128, 224):
            for kk in (8, 136, 1024):
                for mm, nb in ((1, 1), (3, 3), (192, 24)):
                    yc, im_, cc = rnd(tb, mm * kk), rnd(tb, hp), torch.randn(kk, device=dev)
                    close(k5.fft_idft(yc, im_, cc, nb), k5.fft_idft_plain(yc, im_, cc, nb),
                          1e-5, f"fft_idft (2 bins {tb}, hop {hp}, K {kk}, m {mm})")
    yc, im_, cc = rnd(40, 3 * 136), rnd(40, 30), torch.randn(136, device=dev)
    close(k5.fft_idft(yc, im_, cc, 3), k5.fft_idft_plain(yc, im_, cc, 3), 1e-5,
          "fft_idft (hop 30)")
    off = rnd(40 * 3 * 136 + 8)[1 : 1 + 40 * 3 * 136].view(40, 3 * 136)
    try:
        k5.fft_idft(off, rnd(40, 32), cc, 3)
        check(False, "fft_idft took a base pointer that is not 16-byte aligned")
    except ValueError:
        pass

    int8_checks(torch, dev, k4, fs, say)

    # kernel 1 at 30 small shapes of windowed audio frames (white noise
    # puts deep cancellations into single DFT bins, which the few-bin low
    # mel filters pass on to the log): log-mel F = 39, 63 and 128 (n_mels
    # 129) and a DFT width that is not a multiple of the 128-column tile
    # (nfft 400), over 501 rows (not a multiple of the 63 written rows of
    # a tile); 1, 63, 64, 65 and 511 rows; nfft 1024, 1984 and 4096 (4,
    # 8 and 16 column tiles); a frame length of 398 (padded to 400); 501 rows at
    # four more offsets into the batch; and the most mel filters the
    # kernel's shared memory takes (``MAX_MELS``, at nfft 1984)
    fr = audio[1000 : 1000 + 4 * 128 - 11]
    fr398 = fr[:, :398].contiguous()
    cases = [(fr, 512, 40), (fr, 512, 64), (fr, 512, 129), (fr, 400, 0)]
    cases += [(audio[1000 : 1000 + n], 512, nm) for n in (1, 63, 64, 65, 511) for nm in (0, 64)]
    cases += [(fr, nf, nm) for nf in (1024, 1984) for nm in (0, 129)] + [(fr, 4096, 0)]
    cases += [(fr398, 512, 0), (fr398, 512, 64)]
    cases += [(audio[o : o + 501], nf, 0) for o in (3000, 9000, 15000, 21000) for nf in (400, 512)]
    worst = {}
    for x, nfft_s, nm in cases + [(fr, 1984, k1.MAX_MELS)]:
        label = f"frontend_planes (N {x.shape[0]}, FL {x.shape[1]}, nfft {nfft_s}, n_mels {nm})"
        m = check_planes(torch, x, nfft_s, k1.edge_response_planes(x, nfft_s, 16000, nm),
                         k1.edge_response_planes_plain(x, nfft_s, 16000, nm), label, 16000, nm,
                         min_share=0.0 if nm == k1.MAX_MELS else 0.5)
        say(f"{label}: {float64_text(m)}")
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in m.items()}
    say(f"frontend_planes at {len(cases) + 1} small shapes, the most of each: "
        f"{float64_text(worst)}")
    # the shared memory a launch asks for, and the mel count past which
    # the wrapper launches in chunks (mel_chunks)
    smem_fn = _cuda.load("frontend_planes").tsr_frontend_planes_smem
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_int
    smem = {nm: smem_fn(nm) for nm in (0, 64, 129, k1.MAX_MELS, k1.MAX_MELS + 1)}
    check(smem[k1.MAX_MELS] <= 232448 < smem[k1.MAX_MELS + 1],
          f"frontend_planes: MAX_MELS disagrees with the kernel's shared memory {smem}")
    check(k1.mel_chunks(k1.MAX_MELS + 1) == [(0, k1.MAX_MELS - 1), (k1.MAX_MELS - 1,
                                                                       k1.MAX_MELS)],
          "mel_chunks: past MAX_MELS, two launches sharing a filter")
    say(f"frontend_planes dynamic shared memory by n_mels: {smem}")
    off = fr.reshape(-1)[: 3 * 400 + 1].clone()[1:].view(3, 400)
    check(off.data_ptr() % 16 == 4, "the misaligned view is not misaligned")
    try:
        k1.edge_response_planes(off, 512)
        check(False, "frontend_planes took a base pointer that is not 16-byte aligned")
    except ValueError:
        pass

    radix_checks(torch, dev, k8, fp, rng, say)

    # order statistics and binarize + spread at F = 39, 63, 65 and 513
    # (words of the bit masks past one and across many), T not a multiple
    # of the 32-row tile and odd (tiles whose first flat byte is not
    # 16-byte aligned), an utterance with no valid row, a strided [B, P]
    # view of plane-major planes, rf and rt 0, 1 and 2; kernel 9 with
    # its time spread, and binarize_spread_flat, bitwise against both
    # plain versions
    for f_s, t_s, rf, rt in ((39, 250, 0, 0), (63, 250, 2, 1), (63, 77, 1, 1),
                             (63, 33, 0, 2), (65, 130, 1, 2), (513, 71, 1, 1)):
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
        check(bool(torch.equal(k9.binarize_freqspread(*args9, rt),
                               k9.binarize_freqspread_plain(*args9, rt))),
              f"binspread (small, F={f_s}, T={t_s}, rf={rf}, rt={rt}): not bitwise")
        check(bool(torch.equal(
            fp.binarize_spread_flat(pl, hi, lo, vs, rt, rf),
            fp.binarize_spread_flat(pl, hi, lo, vs, rt, rf, plain=True))),
            f"binarize_spread_flat (small, F={f_s}): not bitwise")
    rows_fn = _cuda.load("binspread").tsr_binspread_tile_rows
    rows_fn.argtypes, rows_fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for p_s, f_s, rt in ((4, 63, 1), (4, 63, 0), (4, 65, 2), (4, 512, 1), (4, 513, 1)):
        check(rows_fn(p_s, f_s, rt) == k9.tile_rows(p_s, f_s, rt),
              f"binspread: the kernel's tile rows at P {p_s}, F {f_s}, rt {rt} are not "
              f"tile_rows'")

    # pair LLR: windows into the next utterance and past the map's end,
    # L and m not multiples of the output tiles (L 6, 40, 64; m 16, 40,
    # 48); D = 64 and 96 (one partial stage; 96 rows are not 16-byte
    # multiples), D = 504 leaves the last 128-wide stage partial; ids out
    # of range, one id for every pair, every id once
    _cuda.reset_launches()
    n_llr = 0
    for bb, tt, dd, kk, length, mm, ids_kind in (
            (2, 50, 64, 5, 6, 16, "mixed"), (3, 40, 96, 4, 40, 48, "mixed"),
            (2, 40, 504, 4, 32, 40, "mixed"), (2, 60, 504, 9, 32, 40, "same"),
            (3, 40, 2048, 40, 32, 40, "distinct"), (2, 40, 2048, 3, 64, 40, "mixed")):
        fmap = torch.from_numpy(rng.random((bb, tt, dd)) < 0.3).to(dev)
        wq = torch.randn(kk, length, dd, device=dev).to(torch.bfloat16)
        rs_np = rng.integers(0, bb * tt, 37).astype(np.int32)
        rs_np[:7] = (0, 3, tt - 4, tt + 5, bb * tt - 9, bb * tt - 2, bb * tt - 1)
        rs = torch.from_numpy(rs_np).to(dev)
        if ids_kind == "same":
            ids_np = np.full(37, 2, np.int32)
        elif ids_kind == "distinct":
            ids_np = rng.permutation(kk)[:37].astype(np.int32)
        else:
            ids_np = rng.integers(-2, kk + 2, 37).astype(np.int32)
        ids = torch.from_numpy(ids_np).to(dev)
        close(kp.pair_llr(fmap, wq, rs, ids, mm), kp.pair_llr_plain(fmap, wq, rs, ids, mm),
              1e-5, f"pair_llr (L={length}, D={dd}, m={mm}, ids {ids_kind})")
        n_llr += 1
    ran = _cuda.launch_counts().get(kp.NAME, 0)
    check(ran == n_llr, f"pair_llr: {ran} launches for {n_llr} calls")
    say(f"pair_llr: within 1e-5 x max|ref| at {n_llr} small shapes, {ran} launches")

    # direct correlation: T'' not a multiple of the 192-start tile, K = 1,
    # 3 and 129 (a template tile past K), D = 40 and 504 (a partial last
    # 64-column chunk) and
    # 2048, L = 1, 9, 32, 48 and L = T, B = 1, and an all-zero utterance,
    # whose scores are c exactly; two launches bitwise equal
    for bb, tt, dd, kk, length in ((1, 77, 40, 3, 9), (2, 300, 504, 5, 48),
                                   (3, 130, 504, 130, 1), (1, 48, 16, 7, 48),
                                   (2, 257, 2048, 129, 32), (1, 250, 40, 1, 9),
                                   (3, 430, 504, 1, 32), (2, 200, 40, 129, 1),
                                   (2, 600, 504, 3, 17)):
        xc = torch.from_numpy(rng.random((bb, tt, dd)) < 0.2).to(dev, torch.bfloat16)
        if bb > 1:
            xc[-1] = 0
        wc = torch.randn(kk, length, dd, device=dev).to(torch.bfloat16)
        cc = torch.randn(kk, device=dev)
        got = kc.correlation_scores(xc, wc, cc)
        label = f"correlation (B={bb}, T={tt}, D={dd}, K={kk}, L={length})"
        close(got, kc.correlation_scores_plain(xc, wc, cc), 1e-5, label)
        check(bool(torch.equal(got, kc.correlation_scores(xc, wc, cc))),
              f"{label}: two launches differ")
        if bb > 1:
            check(bool(torch.equal(got[-1], cc[:, None].expand(kk, tt - length + 1))),
                  "correlation: an all-zero utterance does not score c")

    # banded DTW: the TPU's packed (L 32), band (L 96) and full (L 128)
    # regimes, and L 48 and 200 (2 and 8 rows a lane); ragged seg_lens
    # from 1 to M, pair counts that are not multiples of a block; band 1
    # leaves terminals unreachable
    for length, m, band, n in ((32, 40, 6, 37), (32, 40, 1, 37), (48, 56, 6, 21),
                               (96, 104, 6, 19), (128, 136, 64, 13), (200, 40, 3, 5),
                               (1, 8, 3, 40), (256, 300, 100, 9), (32, 1024, 6, 11)):
        cost = torch.from_numpy(
            (rng.standard_normal((n, length, m)) + 2.0).astype(np.float32)).to(dev)
        lens_np = rng.integers(1, m + 1, n).astype(np.int32)
        lens_np[0], lens_np[1], lens_np[-1] = 1, m + 5, m     # m + 5: no terminal cell
        lens = torch.from_numpy(lens_np).to(dev)
        check_terminals(torch, kd.banded_dtw(cost, lens, band),
                        kd.banded_dtw_plain(cost, lens, band),
                        f"banded_dtw (small, L={length}, band={band})")
    dtw_fused_checks(torch, dev, kd, say)


def check_scores(torch, got, ref, name):
    """DTW scores: bitwise where the plain version is finite, -inf alike
    elsewhere; returns the number of unreachable pairs."""
    finite = torch.isfinite(ref)
    check(bool(finite.any()), f"{name}: no reachable pair")
    check(bool(torch.equal(got[finite], ref[finite])), f"{name}: finite scores not bitwise")
    check(bool(torch.isneginf(got[~finite]).all()), f"{name}: unreachable pairs not at -inf")
    return int((~finite).sum())


def dtw_fused_checks(torch, dev, kd, say):
    """The DTW kernel's fused mode (LLR tile in, score out) bitwise against
    its plain twin at L 96, m 1024 (the ring of chunks turns ~33 times a
    pair), band 100 at L 32, L 1, L 256, the gathered route's m 38
    (152-byte rows; with a pair -> row index and with c_pairs), and the
    exhaustive route's strided view of a [nb, M, K, L] GEMM output (one
    length a segment, c row n % K); two launches bitwise equal."""
    rng = np.random.default_rng(SEED + 15)
    shapes = []
    for label, length, m, band, n in (
            ("L 96", 96, 104, 6, 77), ("m 1024", 32, 1024, 6, 21),
            ("band 100 at L 32", 32, 40, 100, 37), ("L 1", 1, 8, 3, 70),
            ("L 256", 256, 300, 100, 9), ("gathered m 38", 32, 38, 6, 53)):
        llr = torch.from_numpy(
            rng.standard_normal((n, length, m)).astype(np.float32) - 2.0).to(dev)
        lens_np = np.clip(rng.integers(length - 4, m + 1, n), 1, m).astype(np.int32)
        lens_np[:3] = (1, m, m + 2)                   # m + 2: no terminal cell
        lens = torch.from_numpy(lens_np).to(dev)
        c_tab = torch.randn(5, length, device=dev)
        cid = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev)
        shapes.append((label, band, llr, lens, c_tab, cid))
    label, band, llr, lens, c_tab, cid = shapes[-1]
    shapes.append(("gathered m 38, c_pairs", band, llr, lens,
                   c_tab[cid.long()].contiguous(), None))
    nb, m, q, length = 12, 38, 41, 32
    gemm = torch.from_numpy(
        rng.standard_normal((nb, m, q, length)).astype(np.float32) - 2.0).to(dev)
    lens_np = np.clip(rng.integers(length - 4, m + 1, nb), 1, m).astype(np.int32)
    lens_np[0] = 1
    shapes.append(("exhaustive GEMM view", 6, gemm.permute(0, 2, 3, 1),
                   torch.from_numpy(lens_np).to(dev), torch.randn(q, length, device=dev), None))
    for label, band, llr, lens, c_tab, cid in shapes:
        name = f"banded_dtw fused ({label})"
        got = kd.banded_dtw_scores(llr, lens, c_tab, band, cid)
        check_scores(torch, got, kd.banded_dtw_scores_plain(llr, lens, c_tab, band, cid), name)
        check(bool(torch.equal(got, kd.banded_dtw_scores(llr, lens, c_tab, band, cid))),
              f"{name}: two launches differ")
    say(f"banded_dtw fused mode: bitwise against its plain twin at {len(shapes)} shapes ("
        + ", ".join(sh[0] for sh in shapes) + "); two launches equal at each")


def take_launches(rows, names, counts, shape=None):
    """Each listed kernel's row (only the row of ``shape``, if given)
    takes its launch count from this run."""
    for row in rows:
        if row["name"] in names and (shape is None or row.get("shape") == shape):
            row["launches"] = int(counts.get(row["name"], 0))


def wide_frontend_check(torch, C, fp, k8, _cuda, wavs, nvalid, say):
    """``FrontendConfig(nfft=1024)`` (512 DFT columns, past the 480 at
    which the port's earlier fp32 SIMT kernel 1 no longer launched)
    through both frontend paths on the first two utterances: the two
    paths give one map bit for bit, and it agrees with the plain run's
    map on >= 99.9% of its cells (the frontend's parity contract:
    cells whose response ties the threshold within float tolerance may
    flip)."""
    wcfg = C.FrontendConfig(nfft=1024)
    check(fp._fused_ok(wcfg), "nfft 1024 must take the two-kernel path")
    w2, n2 = wavs[:2], nvalid[:2]
    plain = fp.frontend_batch_flat(w2, n2, wcfg, plain=True).binary
    _cuda.reset_launches()
    fused = fp.frontend_batch_flat(w2, n2, wcfg, layered=False).binary
    layered = fp.frontend_batch_flat(w2, n2, wcfg, layered=True).binary
    counts = _cuda.launch_counts()
    check(counts.get("frontend_planes", 0) == 2 and counts.get("select_binspread", 0) == 1
          and counts.get("radix_select", 0) == 1 and counts.get("binspread", 0) == 1,
          f"nfft 1024 frontends: launches {counts}")
    check(bool(torch.equal(fused, layered)), "nfft 1024: the layered and two-kernel maps differ")
    share = int((fused != plain).sum()) / plain.numel()
    check(share <= 1e-3, f"nfft 1024: {share} of the map cells differ from the plain run's")
    say(f"FrontendConfig(nfft=1024), 2 utterances, both frontend paths: one map bit for bit "
        f"({int(fused.sum())} set cells of {fused.numel()}), {share:.3g} of its cells unlike "
        f"the plain run's (tolerance 1e-3); launches {counts}")
    # the radix select at the layered path's shape for all 8 utterances
    # (F 512: 201 MB of planes), bitwise against its plain version
    planes = fp.response_planes(fp._windowed_frames(wavs, wcfg), wcfg)
    pm = planes.transpose(0, 1)
    valid = torch.div(nvalid - wcfg.frame_length, wcfg.hop_length, rounding_mode="floor").to(
        torch.int32)
    need = fp._dual_ranks(valid, pm.shape[3], wcfg.edge_quantile)
    got = k8.radix_select(pm, valid, need)
    want = k8.radix_select_plain(pm, valid, need)
    check(all(bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
              for g, w in zip(got, want)), "radix_select (nfft 1024, F 512): not bitwise")
    say(f"radix_select at nfft 1024 (planes {tuple(pm.shape)}, {pm.numel() * 4 / 1e6:.1f} MB): "
        f"bitwise")


def mel_kernel_checks(torch, M, dev, wavs, nvalid, valid, frames2, bank_mel, record, say):
    """The log-mel scan's kernels at its shapes (B = 8, T_pad = 3072,
    n_mels 64 -> F = 63, D = 504), each against its plain version."""
    C, fp, fs, k1, k3, k4, kp, k8, k9 = (M.C, M.fp, M.fs, M.k1, M.k3, M.k4, M.kp, M.k8,
                                          M.k9)
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices, mel_filterbank
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops.edges import order_keys
    from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat

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
            time_ms(torch, lambda: k1.edge_response_planes(frames2, nfft, sr, n_mels), loop=100),
            time_ms(torch, lambda: k1.edge_response_planes_plain(frames2, nfft, sr, n_mels)),
            time_ms(torch, lambda: (torch.matmul(frames2, cs), torch.matmul(pw, fb)), loop=100),
        )
        single = time_ms(torch, lambda: k1.edge_response_planes(frames2, nfft, sr, n_mels))
        nbytes = (n_rows * fl * 4 + 2 * fl * bins * 4 + fb.numel() * 4
                  + 4 * n_rows * (n_mels - 1) * 4)
        ops = 2 * 2 * n_rows * fl * bins + 2 * n_rows * nnz
        say(f"frontend_planes (n_mels {n_mels}): {float64_text(m)}; the mel "
            f"product over {nnz} nonzero filter weights of {fb.numel()}; one launch between "
            f"the events (with the wrapper's host time) {single:.4f} ms")
        return got, m["err"], times, nbytes, ops

    pm, err7, times7, bytes7, ops7 = planes_row(nm)
    record(SimpleNamespace(NAME=k1.MEL_NAME, SOURCE=k1.SOURCE, REPLACES=k1.MEL_REPLACES),
           err7, "scaled 1e-5 of float64; error bounds", *times7, bytes7, ops7, FP32_FLOPS,
           tf32=True)
    _p129, err1, times1, bytes1, ops1 = planes_row(129)
    b1, by1 = bound_ms(bytes1, ops1, FP32_FLOPS)
    bt1, byt1 = bound_ms(bytes1, 3 * ops1, TF32_FLOPS)
    say(f"frontend_planes mel mode at n_mels 129 (TPU row 1's mel mode; the two-kernel "
        f"path): max_abs_err {err1:.6g} kernel {times1[0]:.4f} ms plain {times1[1]:.4f} ms "
        f"library {times1[2]:.4f} ms bound {b1:.4f} ms ({by1}; three TF32 passes "
        f"{bt1:.4f} ms, {byt1})")
    del _p129

    # kernel 8, the whole layered select, on kernel 1's plane-major
    # output: bitwise against its plain version and through
    # plane_order_statistics, two launches bitwise equal; one wrapper call
    # of at most four kernels and one memset (torch.profiler)
    planes = pm.reshape(4, B, t_pad, f).transpose(0, 1)            # [B, 4, T, F] view
    pm4 = planes.transpose(0, 1)                                    # the [4, B, T, F] storage
    q = mcfg.edge_quantile
    need = fp._dual_ranks(valid, f, q)
    sel = k8.radix_select(pm4, valid, need)
    want = k8.radix_select_plain(pm4, valid, need)
    again = k8.radix_select(pm4, valid, need)
    via = fp.plane_order_statistics(planes, valid, q)
    via_copy = fp.plane_order_statistics(planes.contiguous(), valid, q)  # [B, P] storage

    def same(x, y):
        return all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                   for a, b in zip(x, y))

    check(same(sel, want), "radix_select: not bitwise at the log-mel scan's planes")
    check(same(again, sel), "radix_select: two launches differ")
    check(same(via, sel), "plane_order_statistics does not return the kernel's select")
    check(same(via_copy, sel), "plane_order_statistics differs on utterance-major planes")
    del via_copy
    os_hi, os_lo = sel
    _cuda.reset_launches()
    ops = device_op_names(torch, lambda: k8.radix_select(pm4, valid, need))
    whole = device_op_names(torch, lambda: fp.plane_order_statistics(planes, valid, q))
    calls = _cuda.launch_counts().get(k8.NAME, 0)
    check(calls == 2, f"radix_select: {calls} wrapper calls for two selects")
    if ops is None:
        say("radix_select: device ops a call not measured (the trace holds no device event)")
    else:
        memsets = [n for n in ops if "emset" in n]
        check(len(ops) - len(memsets) <= 4 and len(memsets) <= 1,
              f"radix_select enqueues {ops}")
        say(f"radix_select: one call enqueues {len(ops) - len(memsets)} kernels and "
            f"{len(memsets)} memset; the whole plane_order_statistics (the ranks' elementwise "
            f"ops and the call) {len(whole)} device ops")
    # the yardstick: torch.kthvalue of both ranks over the keys of every
    # cell (masked cells 0xFFFFFFFF, above every real key)
    rv = torch.arange(t_pad, device=dev)[None, :] < valid[:, None]
    keys64 = order_keys(pm4).masked_fill(~rv[None, :, :, None], 0xFFFFFFFF).reshape(4 * B, -1)
    check(bool((valid == valid[0]).all()), "the timed batch has one valid length")
    ka, kb = int(need[0, 0]), int(need[0, 1])
    record(
        k8, 0.0, "bitwise",
        time_ms(torch, lambda: k8.radix_select(pm4, valid, need), loop=100),
        time_ms(torch, lambda: k8.radix_select_plain(pm4, valid, need)),
        time_ms(torch, lambda: (torch.kthvalue(keys64, ka, dim=1),
                                torch.kthvalue(keys64, kb, dim=1))),
        # the valid cells read once, the ranks and valid frames, both outputs
        4 * int(valid.sum()) * f * 4 + need.numel() * 4 + B * 4 + 2 * os_hi.numel() * 4,
        0, 1.0,
    )
    sel_ms = time_ms(torch, lambda: fp.plane_order_statistics(planes, valid, q))
    say(f"radix_select: {4 * B} rows of {int(valid[0])} x {f} valid cells, bitwise, two "
        f"launches equal; the whole layered select (plane_order_statistics: the ranks and one "
        f"radix_select call, one call between the events) sel_ms {sel_ms:.4f} ms; host "
        f"{host_us(torch, lambda: k8.radix_select(pm4, valid, need)):.1f} us a call")
    del keys64, pm4

    # kernel 9 on the kernel-1 planes (a strided [B, P] view) with the
    # selected statistics; bitwise at rt = 0 (the TPU kernel's function)
    # and at the scan's rt = 1, and through binarize_spread_flat against
    # its plain path (the kernel's plain version, the time dilation and
    # the row mask); two launches equal
    rt = mcfg.spread_time
    check(rt == 1, f"the log-mel scan's spread_time is {rt}")
    args9 = (planes, os_hi.contiguous(), os_lo.contiguous(), valid, mcfg.spread_freq)
    m9 = k9.binarize_freqspread(*args9)
    check(bool(torch.equal(m9, k9.binarize_freqspread_plain(*args9))), "binspread: not bitwise")
    m9t = k9.binarize_freqspread(*args9, rt)
    check(bool(torch.equal(m9t, k9.binarize_freqspread_plain(*args9, rt))),
          f"binspread (rt {rt}): not bitwise")
    check(bool(torch.equal(m9t, k9.binarize_freqspread(*args9, rt))),
          "binspread: two launches differ")
    flat_args = (planes, os_hi.contiguous(), os_lo.contiguous(), valid, rt, mcfg.spread_freq)
    whole = fp.binarize_spread_flat(*flat_args)
    check(bool(torch.equal(whole, fp.binarize_spread_flat(*flat_args, plain=True))),
          "binarize_spread_flat: not bitwise against its plain path")
    check(whole.dtype == torch.bool, "binarize_spread_flat: dtype")
    _cuda.reset_launches()
    ops9 = device_op_names(torch, lambda: fp.binarize_spread_flat(*flat_args))
    check(_cuda.launch_counts().get(k9.NAME, 0) == 1, "binarize_spread_flat: launches")
    if ops9 is not None:
        check(len(ops9) == 1, f"binarize_spread_flat enqueues {ops9}")

    def caller_passes():
        """binarize_spread_flat as it was before the time spread moved into
        the kernel: the kernel at rt = 0, then the time dilation, the row
        mask and the cast to bool, each a pass of its own."""
        from template_speech_recognition_tpu_torch.ops.edges import _dilate_axis

        fl = _dilate_axis(k9.binarize_freqspread(*args9), rt, 1)
        return fl.to(torch.bool) & (torch.arange(t_pad, device=dev)[None, :, None]
                                    < valid[:, None, None])

    check(bool(torch.equal(caller_passes(), whole)), "the caller's passes give another map")
    ops_old = device_op_names(torch, caller_passes)
    ms9t = time_ms(torch, lambda: k9.binarize_freqspread(*args9, rt), loop=100)
    ms90 = time_ms(torch, lambda: k9.binarize_freqspread(*args9), loop=100)
    whole_ms = time_ms(torch, lambda: fp.binarize_spread_flat(*flat_args))
    old_ms = time_ms(torch, caller_passes)
    say(f"binspread at rt {rt} (the log-mel scan's call, the kernels line's row): {ms9t:.4f} "
        f"ms; at rt 0 (the TPU kernel's function) {ms90:.4f} ms (loops of 100); "
        f"the whole binarize_spread_flat, one call between the events {whole_ms:.4f} ms, "
        f"{len(ops9) if ops9 else 'not measured'} device op(s), against the kernel at rt 0 "
        f"+ the caller's passes {old_ms:.4f} ms, "
        f"{len(ops_old) if ops_old else 'not measured'} device ops; bitwise")
    del whole, m9t
    record(
        k9, 0.0, "bitwise", ms9t,
        time_ms(torch, lambda: k9.binarize_freqspread_plain(*args9, rt)),
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
    llr_ref = kp.pair_llr_plain(*args_p)
    ref_p = float(llr_ref.abs().max())
    err_p = float((kp.pair_llr(*args_p) - llr_ref).abs().max())
    check(err_p <= 1e-5 * ref_p, f"pair_llr (D=504): {err_p} > 1e-5 * {ref_p}")
    ms_p = time_ms(torch, lambda: kp.pair_llr(*args_p), loop=100)
    wf_m, cf_m = bank_mel.llr()
    fbank8 = fs.build_fft_bank(filters_to_flat(wf_m), cf_m, mm_dtype=torch.int8)
    nfft_s, length = fbank8.nfft, fbank8.length
    hop = nfft_s - length + 1
    nblk = -(-(t_pad - length + 1) // hop)
    cmat, smat = fs._dft_mats(nfft_s, torch.bfloat16, dev)
    g = torch.cat([cmat, -smat], dim=1).contiguous()
    # kernel 3 at D = 504 on the log-mel map: the last d tile is partial
    # (504 = 3 x 128 + 120) and TMA clips its stores
    xr, xi = M.record_dft(k3, fm.binary.to(torch.bfloat16), g, nfft_s, hop, nblk, DFT_MEL)
    xq_r, xq_i, sc8 = fs.quantize_block_spectra(xr, xi, fbank8.w2_scale)
    m = B * nblk
    M.record_int8(k4, fbank8, xq_r, xq_i, sc8, m, INT8_MEL)

    # the bf16 bin matmul at D = 504 on the log-mel scan's own block
    # spectra and bf16 bank: the last k tile of each half is partial
    # (504 = 7 x 64 + 56) and TMA's zero fill completes it
    bins_m = nfft_s // 2 + 1
    fbank16 = fs.build_fft_bank(filters_to_flat(wf_m), cf_m, mm_dtype=torch.bfloat16)
    check(tuple(fbank16.w2.shape) == (bins_m, 2 * d, K) and m == 192,
          f"log-mel bin matmul shape {tuple(fbank16.w2.shape)}, m {m}")
    binmm_row(torch, k4, record, xr, xi, fbank16.w2, BINMM_MEL)
    del fbank16
    say(f"at D = 504: pair_llr max error {err_p:.3g} (1e-5 x {ref_p:.4g} allowed) "
        f"{ms_p:.4f} ms (loops of 100)")


# ---- resumable scans: the manifest and the PCM16 upload --------------------


def upload_ms(torch, run):
    """The device time of the host-to-device copies of one traced
    ``run`` in ms, or None when the trace holds no device event."""
    total, names, _n = traced_device_ms(torch, run)
    if total is None:
        return None
    return sum(ms for n, ms in names.items() if "HtoD" in n)


def resume_phase(torch, say, corpus, bank, scan_cfg, clean, clean_ctr, _cuda):
    """The default scan with a manifest: recorded whole, then failed in
    ``compute`` after 2 of its 3 batches and resumed, and a complete
    manifest reloaded; each bitwise equal to the clean scan ``clean``."""
    import tempfile

    from template_speech_recognition_tpu_torch import scan as scan_mod
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest

    real_step = scan_mod.scan_step
    calls = {"n": 0, "fail_after": None}

    def step(*a, **k):
        calls["n"] += 1
        if calls["fail_after"] is not None and calls["n"] > calls["fail_after"]:
            raise RuntimeError("injected fault")
        return real_step(*a, **k)

    def scan(manifest, fail_after=None):
        calls.update(n=0, fail_after=fail_after)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan_mod.detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa",
                                            manifest=manifest)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    scan_mod.scan_step = step
    try:
        with tempfile.TemporaryDirectory() as tmp:
            whole, wall_rec = scan(ScanManifest(f"{tmp}/whole"))
            check(same_detections(whole.detections, clean),
                  "manifest: the recorded scan differs from the clean scan")
            check(ScanManifest(f"{tmp}/whole").completed() == {0, 1, 2},
                  "manifest: the recorded scan did not record shards 0-2")
            again, wall_load = scan(ScanManifest(f"{tmp}/whole"))
            check(calls["n"] == 0 and same_detections(again.detections, clean),
                  f"manifest: the complete manifest ran {calls['n']} steps or differs")
            mdir = f"{tmp}/fault"
            try:
                scan(ScanManifest(mdir), fail_after=2)
                check(False, "manifest: the injected fault did not fire")
            except RuntimeError as exc:
                check("injected fault" in str(exc), f"manifest: {exc}")
            done = ScanManifest(mdir).completed()
            check(done == {0, 1}, f"manifest: the failed scan recorded {sorted(done)}")
            torch.cuda.synchronize()
            _cuda.reset_launches()
            resumed, wall_res = scan(ScanManifest(mdir))
            counts = _cuda.launch_counts()
    finally:
        scan_mod.scan_step = real_step
    check(calls["n"] == 1, f"manifest: the resumed scan ran {calls['n']} steps for 1 shard")
    for name in SCAN_KERNELS:
        check(counts.get(name, 0) == 1, f"resumed scan: {name} launched {counts.get(name, 0)}x")
    check(same_detections(resumed.detections, clean),
          "manifest: the resumed scan is not bitwise the clean scan")
    def loop(r):
        return f"{r.counters['time_scan_s']:.4f} s loop"

    say(f"manifest: the default scan ({clean_ctr['batches']:.0f} batches) recording its shards: "
        f"{loop(whole)} ({whole.counters['audio_s_per_s']:.1f} audio-s/s; {wall_rec:.4f} s "
        f"with the bank build), without a manifest {clean_ctr['time_scan_s']:.4f} s loop "
        f"({clean_ctr['audio_s_per_s']:.1f} audio-s/s); the complete manifest reloaded: "
        f"{loop(again)} ({wall_load:.4f} s), no step; failed in compute after 2 batches, "
        f"shards 0 and 1 recorded, resumed: {loop(resumed)} ({wall_res:.4f} s), 1 step "
        f"(launches {counts}); all three bitwise the clean scan's {len(clean.scores)} "
        f"detections")


def pcm16_phase(torch, say, corpus, bank, scan_cfg, _cuda):
    """``SCAN_UPLOAD_INT16=1`` on the smoke corpus snapped to the PCM16
    grid: bitwise the float upload of the same corpus; the uploads' ms
    a batch from a trace, and audio-s/s, of both."""
    import os

    from template_speech_recognition_tpu_torch.scan import _pcm16, detect_corpus_stream

    pcm = Corpus.held([(u, _pcm16(w).astype(np.float32) / 32768.0, p)
                       for u, w, p in corpus.utts], corpus.sample_rate)

    def run(int16):
        prev = os.environ.pop("SCAN_UPLOAD_INT16", None)
        if int16:
            os.environ["SCAN_UPLOAD_INT16"] = "1"
        try:
            return detect_corpus_stream(pcm, bank, scan_cfg, target_phone="aa")
        finally:
            os.environ.pop("SCAN_UPLOAD_INT16", None)
            if prev is not None:
                os.environ["SCAN_UPLOAD_INT16"] = prev

    from template_speech_recognition_tpu_torch import scan as scan_mod

    run(True)                                                         # warm-up
    real_fe = scan_mod.frontend_batch_flat
    seen = []
    scan_mod.frontend_batch_flat = lambda w, *a, **k: seen.append(w.clone()) or real_fe(w, *a, **k)
    try:
        f32 = run(False)
        floats, seen[:] = list(seen), []
        torch.cuda.synchronize()
        _cuda.reset_launches()
        i16 = run(True)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
    finally:
        scan_mod.frontend_batch_flat = real_fe
    check(len(seen) == len(floats) == 3 and all(
        a.dtype == torch.float32 and bool(torch.equal(a, b)) for a, b in zip(seen, floats)),
        "PCM16 upload: the frontend's waveforms are not bitwise the float upload's")
    for name in SCAN_KERNELS:
        check(counts.get(name, 0) == 3, f"PCM16 scan: {name} launched {counts.get(name, 0)}x")
    check(len(i16.detections.scores) > 0 and same_detections(i16.detections, f32.detections),
          "PCM16 upload: the detections are not bitwise the float upload's")
    nb = i16.counters["batches"]
    up = {k: upload_ms(torch, lambda: run(k)) for k in (False, True)}
    rates = [run(k).counters["audio_s_per_s"] for k in (False, True, True, False)]
    text = ", ".join(
        "not measured (no device event traced)" if v is None else
        f"{lbl} {v / nb:.4f} ms a batch"
        for lbl, v in (("float", up[False]), ("int16", up[True])))
    say(f"PCM16 upload: {nb:.0f} batches bitwise the float upload's (the frontend's "
        f"waveforms and {len(f32.detections.scores)} detections; launches {counts}); uploads (host to device, traced): {text}; "
        f"audio-s/s float {f32.counters['audio_s_per_s']:.1f}, int16 "
        f"{i16.counters['audio_s_per_s']:.1f}, then float, int16, int16, float: "
        + ", ".join(f"{r:.1f}" for r in rates) + " (three batches: no stable throughput)")


# ---- config-3 training (the soak corpus of soak.py) ----------------------

SOAK_UTTS = 75                     # utterances a group (soak.py); the cut, if any


def soak_corpus(utts_per_group: int):
    """soak.py's corpus without JAX: four groups of synthetic utterances
    with 25/50/75/100 phones each, seeds 100-103, interleaved
    (``soak_cuda.build_corpus``)."""
    from soak_cuda import build_corpus

    return build_corpus(utts_per_group)


def loop_flips(torch, fp, corpus, fcfg, dev):
    """``map_flips`` for the per-utterance loop: each utterance's map
    alone, kernels against plain -> {utterance: sorted frames holding a
    cell the two set differently}."""
    from template_speech_recognition_tpu_torch.scan import bucket_length

    out = {}
    for ui, (_u, wav, _p) in enumerate(corpus.iter_utterances()):
        buf = torch.zeros((1, bucket_length(len(wav))), dtype=torch.float32)
        buf[0, : len(wav)] = torch.from_numpy(wav)
        nv = torch.tensor([len(wav)], dtype=torch.int32, device=dev)
        mk = fp.frontend_batch_flat(buf.to(dev), nv, fcfg).binary[0]
        mp = fp.frontend_batch_flat(buf.to(dev), nv, fcfg, plain=True).binary[0]
        out[ui] = np.flatnonzero((mk != mp).any(dim=-1).cpu().numpy())
    return out


def same_state(a, b) -> bool:
    """Two EM states bitwise equal, field by field (NaN equal to NaN)."""
    return all(np.array_equal(x.cpu().numpy(), y.cpu().numpy(), equal_nan=True)
               for x, y in zip(a, b))


def em_checkpoint_phase(torch, say, dev, x, init_resp, iters):
    """``run_em_checkpointed`` on the card at the training phase's shape,
    tol 0, chunks of 5: killed after its first chunk and called again,
    bitwise the unbroken run (and ``bernoulli_mixture_em``); the unbroken
    run against the CPU's in the training phase's EM classes."""
    import tempfile

    from template_speech_recognition_tpu_torch import checkpoint as ck
    from template_speech_recognition_tpu_torch.models.mixture import bernoulli_mixture_em

    chunk = 5
    kw = dict(num_iters=iters, chunk_iters=chunk, tol=0.0)
    real = ck.resume_fit
    chunks = {"n": 0}

    def dies_after_one(*a, **k):
        chunks["n"] += 1
        if chunks["n"] > 1:
            raise RuntimeError("killed")
        return real(*a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        (whole, ms_whole) = time_once(
            torch, lambda: ck.run_em_checkpointed(x, init_resp, f"{tmp}/whole", **kw))
        ck.resume_fit = dies_after_one
        try:
            ck.run_em_checkpointed(x, init_resp, f"{tmp}/crash", **kw)
            check(False, "checkpointed EM: the kill did not fire")
        except RuntimeError as exc:
            check("killed" in str(exc), f"checkpointed EM: {exc}")
        finally:
            ck.resume_fit = real
        saved = int(ck.restore_em_state(f"{tmp}/crash", dev).iteration)
        check(saved == chunk, f"checkpointed EM: {saved} iterations saved, not {chunk}")
        (resumed, ms_res) = time_once(
            torch, lambda: ck.run_em_checkpointed(x, init_resp, f"{tmp}/crash", **kw))
        (direct, ms_direct) = time_once(
            torch, lambda: bernoulli_mixture_em(x, init_resp, num_iters=iters, tol=0.0))
        t0 = time.perf_counter()
        cpu = ck.run_em_checkpointed(x.cpu(), init_resp, f"{tmp}/cpu", **kw)
        cpu_s = time.perf_counter() - t0
    check(same_state(resumed, whole), "checkpointed EM: the resumed run is not bitwise "
                                      "the unbroken one")
    check(same_state(whole, direct), "checkpointed EM: not bitwise bernoulli_mixture_em")
    it_g, it_c = int(whole.iteration), int(cpu.iteration)
    common = min(it_g, it_c)
    hg, hc = whole.history.cpu().numpy(), cpu.history.numpy()
    err = float((whole.means.cpu() - cpu.means).abs().max())
    check(torch.allclose(whole.means.cpu(), cpu.means, rtol=1e-4, atol=1e-5),
          f"checkpointed EM: means differ from the CPU's by {err}")
    check(np.allclose(hg[:common], hc[:common], rtol=1e-4, atol=1e-3),
          "checkpointed EM: the histories differ from the CPU's past rtol 1e-4, atol 1e-3")
    for h, it in ((hg, it_g), (hc, it_c)):
        check(np.all(np.isfinite(h[:it])) and np.all(np.diff(h[:it]) >= -1e-3),
              "checkpointed EM: the log-likelihood falls by more than 1e-3")
    say(f"checkpointed EM at x [{x.shape[0]}, {x.shape[1]}], K {init_resp.shape[1]}, tol 0, "
        f"chunks of {chunk}: unbroken {it_g} iterations in {ms_whole:.3f} ms "
        f"({ms_whole / it_g:.4f} ms an iteration with a save a chunk; "
        f"bernoulli_mixture_em {ms_direct:.3f} ms); killed after one chunk ({saved} "
        f"iterations saved), resumed in {ms_res:.3f} ms: bitwise the unbroken run and "
        f"bernoulli_mixture_em; CPU {it_c} iterations in {cpu_s:.2f} s, means max diff "
        f"{err:.3g}, histories within rtol 1e-4 / atol 1e-3 over {common}")


def classify_phase(torch, say, dev, corpus, bank, tcfg, record, rows, _cuda):
    """``classify_segments`` on the card with the trained bank over the
    soak corpus's labelled aa / iy spans (at least frame_length + 3 hops,
    the CLI's rule; maps from ``pipeline._clip_maps_kept``): sliding
    against the CPU, DTW against its plain version on the card;
    predictions identical, scores within 1e-5 x max|score|.  The DTW
    kernel's row at classification's shape; the CLI's ``classify`` on
    the card, both routes."""
    import contextlib
    import io
    import tempfile

    from template_speech_recognition_tpu_torch.cli import main as cli_main
    from template_speech_recognition_tpu_torch.detect import classify as cls
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd
    from template_speech_recognition_tpu_torch.pipeline import _clip_maps_kept

    fcfg = tcfg.frontend
    band = tcfg.dtw.band
    classes = sorted(set(bank.labels))
    min_samples = fcfg.frame_length + 3 * fcfg.hop_length
    clips = [(ph, wav[s0:e0]) for _u, wav, phones in corpus.iter_utterances()
             for ph, s0, e0 in phones if ph in classes and e0 - s0 >= min_samples]
    stack, lengths, kept = _clip_maps_kept([c for _p, c in clips], tcfg, dev)
    truth = [clips[i][0] for i in kept]
    m_pad = int(lengths.max())
    segs = stack[:, :m_pad]
    n = segs.shape[0]
    k, lb = bank.num_templates, bank.template_length
    bank_cpu = TemplateBank(bank.templates.cpu(), bank.background.cpu(), list(bank.labels))
    for use_dtw in (False, True):                                      # warm-up
        cls.classify_segments(segs[:8], lengths[:8], bank, use_dtw=use_dtw, band=band)
    lines = []
    for use_dtw in (False, True):
        route = "DTW" if use_dtw else "sliding"
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        preds, scores = cls.classify_segments(segs, lengths, bank, use_dtw=use_dtw, band=band)
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        if use_dtw:
            check(counts.get("banded_dtw", 0) >= 1, f"classify DTW: launches {counts}")
            dtw_counts = counts
            ref_p, ref_s = cls.classify_segments(segs, lengths, bank, use_dtw=True, band=band,
                                                 plain=True)
        else:
            check(not counts, f"the sliding route launched {counts}")
            ref_p, ref_s = cls.classify_segments(segs.cpu(), lengths, bank_cpu, band=band)
        fin = np.isfinite(ref_s)
        check(np.array_equal(np.isfinite(scores), fin) and np.array_equal(scores[~fin],
                                                                          ref_s[~fin]),
              f"classify {route}: the -inf scores differ")
        top = float(np.abs(ref_s[fin]).max())
        err = float(np.abs(scores[fin] - ref_s[fin]).max())
        n_diff = sum(a != b for a, b in zip(preds, ref_p))
        check(n_diff == 0, f"classify {route}: {n_diff} predictions differ")
        check(err <= 1e-5 * top, f"classify {route}: scores differ by {err} > 1e-5 * {top}")
        acc = float(np.mean([p == t for p, t in zip(preds, truth)]))
        lines.append(f"{route} {n / wall:.1f} segments/s ({wall:.4f} s), accuracy {acc:.4f}, "
                     f"max diff {err:.3g} of max|score| {top:.6g} against the "
                     f"{'plain version' if use_dtw else 'CPU'}, launches {counts}")
    say(f"classify: {n} segments of {'/'.join(classes)} (M_pad {m_pad}, K {k}, L {lb}, band "
        f"{band}): " + "; ".join(lines) + "; predictions identical")

    # the DTW kernel at classification's shape: the GEMM's output read
    # through its strides, every segment against every template
    w_rows, c_rows = bank.llr_rows()
    with torch.no_grad():
        llr = (segs.reshape(n * m_pad, -1).to(torch.float32)
               @ w_rows.reshape(k * lb, -1).T).reshape(n, m_pad, k, lb).permute(0, 2, 3, 1)
    lens = torch.from_numpy(lengths).to(dev, torch.int32)
    args = (llr, lens, c_rows.to(torch.float32).contiguous(), band)
    sc = kd.banded_dtw_scores(*args)
    n_unreach = check_scores(torch, sc, kd.banded_dtw_scores_plain(*args), "banded_dtw (classify)")
    check(bool(torch.equal(sc, kd.banded_dtw_scores(*args))),
          "banded_dtw (classify): two launches differ")
    check(not kd.whole_tile(llr, band), "classify's DTW tiles took the whole-tile mode")
    cells = band_cells(torch, lb, m_pad, lens.repeat_interleave(k), band)
    shape = f"classify: {n} segments x {k} templates, L {lb}, M {m_pad}, band {band}"
    record(kd, 0.0, "bitwise on finite scores, -inf alike",
           time_ms(torch, lambda: kd.banded_dtw_scores(*args), loop=100),
           time_ms(torch, lambda: kd.banded_dtw_scores_plain(*args)), None,
           cells * 4 + k * lb * 4 + n * 4 + n * k * 4, 5 * cells, FP32_FLOPS, shape=shape)
    take_launches(rows, ("banded_dtw",), dtw_counts, shape=shape)
    say(f"banded_dtw ({shape}): {n * k} pairs, {cells} in-band cells, {n_unreach} "
        f"unreachable; the ring path (strided tiles)")

    # the CLI's classify on the card (its 6-utterance synthetic corpus)
    with tempfile.TemporaryDirectory() as tmp:
        bank.save(f"{tmp}/bank.npz")
        for flags in ([], ["--dtw"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(cli_main(["classify", "--bank", f"{tmp}/bank.npz", *flags]) == 0,
                      f"the CLI's classify {flags} failed")
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            check(line["num_segments"] > 0 and line["classes"] == classes,
                  f"the CLI's classify: {line}")
            say(f"CLI classify {' '.join(flags) or '(sliding)'} on the card: {json.dumps(line)}")


def training_phase(torch, dev, C, say, scan_corpus, scan_cfg, flips, record, rows):
    """Config 3 on the card at the soak shape (F 256, E 8, K 4, R 4), each
    check against the plain versions or the CPU; the numbers printed
    beside the card's name and power limit.  Returns the EM input of the
    sharded phase (x, one restart's responsibilities, the iterations), the
    soak corpus and the bank trained on it (the soak phase's); a failed
    check raises."""
    import tempfile

    from oracle.mixture import init_responsibilities

    from template_speech_recognition_tpu_torch.frontend import features as ff
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.models import parts as mparts
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.models.mixture import (
        bernoulli_mixture_em_restarts,
    )
    from template_speech_recognition_tpu_torch.models.template import register_exemplars
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.pipeline import (
        _clip_feature_maps,
        _detect_corpus_loop,
        _host_maps,
        detect_corpus,
        train_bank,
    )
    from template_speech_recognition_tpu_torch.scan import bucket_length, detect_corpus_stream

    k_comp, restarts, iters = 4, 4, 30
    tcfg = C.PipelineConfig(template=C.TemplateConfig(
        num_components=k_comp, em_restarts=restarts, em_max_iters=iters))
    fcfg = tcfg.frontend
    t0 = time.perf_counter()
    corpus = soak_corpus(SOAK_UTTS)
    n_utts = len(corpus.corpus.utterances)
    clips = [c for ph in TRAIN_PHONES for c in corpus.exemplar_clips(ph)]
    audio_s = sum(len(c) for c in clips) / corpus.sample_rate
    usable = [c for c in clips if len(c) >= fcfg.frame_length + fcfg.hop_length]
    n_calls = -(-len(usable) // 128)
    say(f"training: soak corpus of {n_utts} utterances ({SOAK_UTTS} a group of "
        f"4, {'no cut' if SOAK_UTTS == 75 else 'cut from 75'}; "
        f"{corpus.corpus.total_seconds:.1f} audio-s), {len(clips)} exemplars of "
        f"{'/'.join(TRAIN_PHONES)} ({audio_s:.1f} audio-s), built on the host in "
        f"{time.perf_counter() - t0:.2f} s")

    # exemplar maps: the card's against the plain versions'
    _clip_feature_maps(clips[:128], tcfg, dev)                        # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stack, lengths = _clip_feature_maps(clips, tcfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in ("frontend_planes", "select_binspread"):
        check(counts.get(name, 0) == n_calls,
              f"exemplar maps: {name} launched {counts.get(name, 0)}x")
    stack_p, lengths_p = _clip_feature_maps(clips, tcfg, dev, plain=True)
    check(np.array_equal(lengths, lengths_p) and stack.shape == stack_p.shape,
          "exemplar maps: valid frames differ from the plain run's")
    n_diff = int((stack != stack_p).sum())
    check(n_diff <= 1e-3 * stack.numel(), f"exemplar maps: {n_diff} cells differ")
    del stack_p
    # the last chunk as the frontend gets it: rows of no valid sample
    # after the clips, against the plain version's
    tail = usable[-(len(usable) % 128 or 100):]
    pad = bucket_length(max(len(c) for c in usable), quantum=4096)
    wavs = torch.zeros((128, pad), dtype=torch.float32)
    vs = torch.zeros((128,), dtype=torch.int32)
    for r, c in enumerate(tail):
        wavs[r, : len(c)] = torch.from_numpy(c)
        vs[r] = len(c)
    fk = ff.frontend_batch(wavs.to(dev), vs.to(dev), fcfg)
    fpl = ff.frontend_batch(wavs.to(dev), vs.to(dev), fcfg, plain=True)
    empty = len(tail)
    check(bool(torch.equal(fk.valid_frames, fpl.valid_frames))
          and not bool(fk.valid_frames[empty:].any())
          and not bool(fk.binary[empty:].any()) and not bool(fpl.binary[empty:].any()),
          "exemplar maps: the rows of no valid sample are not empty in both")
    n_tail = int((fk.binary != fpl.binary).sum())
    check(n_tail <= 1e-3 * fk.binary.numel(), f"exemplar maps, last chunk: {n_tail} cells")
    say(f"training: exemplar maps {tuple(stack.shape)} in {build_s:.4f} s = "
        f"{audio_s / build_s:.1f} audio-s/s ({n_calls} frontend calls of 128 "
        f"clips padded to {pad} samples; launches {counts}); {n_diff} of {stack.numel()} "
        f"cells unlike the plain run's (limit 1e-3); the last chunk's {128 - empty} rows of "
        f"no valid sample empty in both, {n_tail} cells of it differ")

    # EM on the card against EM on the CPU, on one registered stack
    target = int(np.median(lengths))
    x = register_exemplars(stack, lengths, target)
    n = x.shape[0]
    x = x.reshape(n, -1).to(torch.float32)
    check(tuple(x.shape) == (n, target * fcfg.feature_freqs * 8), f"EM x {tuple(x.shape)}")
    resps = np.stack([init_responsibilities(n, k_comp, r) for r in range(restarts)])
    bernoulli_mixture_em_restarts(x, resps, num_iters=2, tol=0.0)     # warm-up
    (sg, bg), em_ms = time_once(
        torch, lambda: bernoulli_mixture_em_restarts(x, resps, num_iters=iters, tol=0.0))
    it_g = int(sg.iteration)
    total, names, n_ops = traced_device_ms(
        torch, lambda: bernoulli_mixture_em_restarts(x, resps, num_iters=iters, tol=0.0))
    if total is None:
        say("training: EM's device time by name not measured (no device event traced)")
    else:
        gemm = sum(ms for nm, ms in names.items() if "gemm" in nm.lower()
                   or "gemv" in nm.lower() or "splitk" in nm.lower())
        top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
        say(f"training: EM traced ({it_g} iterations): {total / it_g:.4f} ms of device time "
            f"an iteration (the union of its intervals) in {n_ops / it_g:.1f} device ops, "
            f"GEMM kernels {gemm / it_g:.4f} ms an iteration; most device time: "
            + ", ".join(f"{nm[:60]} {ms / it_g:.4f} ms" for nm, ms in top))
    t0 = time.perf_counter()
    sc, bc = bernoulli_mixture_em_restarts(x.cpu(), resps, num_iters=iters, tol=0.0)
    cpu_s = time.perf_counter() - t0
    it_c = int(sc.iteration)
    hg, hc = sg.history.cpu().numpy(), sc.history.numpy()
    common = min(it_g, it_c)
    hist_ok = np.allclose(hg[:common], hc[:common], rtol=1e-4, atol=1e-3)
    mean_err = float((sg.means.cpu() - sc.means).abs().max())
    say(f"training: EM at x [{n}, {x.shape[1]}], R {restarts} x K {k_comp}, tol 0, "
        f"{iters} iterations at most: card {it_g} iterations in {em_ms:.3f} ms = "
        f"{em_ms / it_g:.4f} ms an iteration (one host sync an iteration), winner {bg}; "
        f"CPU {it_c} iterations in {cpu_s:.2f} s, winner {bc}; bytes bound "
        f"{2 * x.numel() * 4 / HBM_BPS * 1e3:.4f} ms an iteration (x read once by each "
        f"of the two GEMMs); means max diff {mean_err:.3g}; final mean log-likelihood "
        f"{float(sg.log_likelihood):.4f} (card) {float(sc.log_likelihood):.4f} (CPU)")
    check(bg == bc, f"EM: the card's winner {bg}, the CPU's {bc}")
    check(torch.allclose(sg.means.cpu(), sc.means, rtol=1e-4, atol=1e-5),
          f"EM: means differ by {mean_err}")
    check(hist_ok, "EM: the histories differ past rtol 1e-4, atol 1e-3")
    for h, it in ((hg, it_g), (hc, it_c)):
        check(np.all(np.isfinite(h[:it])) and np.all(np.diff(h[:it]) >= -1e-3),
              "EM: the log-likelihood falls by more than 1e-3")
    em_checkpoint_phase(torch, say, dev, x, resps[0], iters)
    em_input = (x.cpu().numpy(), resps[0], iters)
    del x, sg, sc

    # train_bank, save, load, scan
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    bank = train_bank(corpus, list(TRAIN_PHONES), tcfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in ("frontend_planes", "select_binspread"):
        check(counts.get(name, 0) > 0, f"train_bank did not launch {name}")
    check(bank.labels == ["aa"] * k_comp + ["iy"] * k_comp
          and tuple(bank.templates.shape) == (2 * k_comp, target, fcfg.feature_freqs, 8)
          and bool(torch.isfinite(bank.templates).all()),
          f"trained bank: {bank.labels}, {tuple(bank.templates.shape)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bank.npz"
        bank.save(path)
        loaded = TemplateBank.load(path, device=dev)
    check(loaded.labels == bank.labels and loaded.parts is None
          and bool(torch.equal(loaded.templates, bank.templates))
          and bool(torch.equal(loaded.background, bank.background)),
          "the saved bank does not load back equal")
    say(f"training: train_bank (K {k_comp} x R {restarts}, {len(TRAIN_PHONES)} classes) "
        f"{train_s:.3f} s wall -> K {bank.num_templates}, L {bank.template_length}; "
        f"launches {counts}; saved and loaded back equal")
    _cuda.reset_launches()
    res = detect_corpus_stream(scan_corpus, loaded, scan_cfg, target_phone="aa")
    counts = _cuda.launch_counts()
    for name in SCAN_KERNELS:
        check(counts.get(name, 0) > 0, f"the trained bank's scan did not launch {name}")
    ref = detect_corpus_stream(scan_corpus, loaded, scan_cfg, target_phone="aa", plain=True)
    say(f"training: the loaded bank's scan ({res.counters['utterances']:.0f} utterances, "
        f"K {loaded.num_templates}, L {loaded.template_length}): "
        f"{res.counters['audio_s_per_s']:.1f} audio-s/s, launches {counts}")
    check_scan_scores(res.detections, ref.detections, flips, loaded.template_length, 4e-3,
                      "trained-bank scan", say)
    del res, ref
    classify_phase(torch, say, dev, corpus, loaded, tcfg, record, rows, _cuda)
    del bank

    # parts: the dictionary, the codes on the card and on the CPU, the bank
    pcfg = C.PartsConfig(enabled=True)
    pooled = _host_maps(stack, lengths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = mparts.learn_parts(pooled, pcfg.num_parts, pcfg.patch_time, pcfg.patch_freq,
                               pcfg.num_patches, pcfg.seed, pcfg.em_iters, device=dev)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    (codes, code_ms) = time_once(torch, lambda: mparts.code_parts_batch(stack, parts))
    n_cpu = min(512, n)
    codes_cpu = mparts.code_parts_batch(stack[:n_cpu].cpu(), parts.cpu())
    frac = float((codes[:n_cpu].cpu() != codes_cpu).any(dim=-1).float().mean())
    check(bool((codes.sum(dim=-1) == 1).all()), "codes: not one part a location")
    check(frac < 1e-3, f"codes: {frac} of locations differ between the card and the CPU")
    say(f"training: learn_parts ({pcfg.num_parts} parts of {pcfg.patch_time} x "
        f"{pcfg.patch_freq}, {pcfg.num_patches} patches, {pcfg.em_iters} iterations) "
        f"{learn_s:.3f} s wall; code_parts_batch of {tuple(stack.shape)} -> "
        f"{tuple(codes.shape)} in {code_ms:.3f} ms = {n * stack.shape[1] / code_ms * 1e3:.0f} "
        f"frames/s ({mparts.CODE_CHUNK} maps a conv2d); the first {n_cpu} maps' codes on "
        f"the CPU: {frac:.3g} of locations differ (limit 1e-3)")
    del codes, codes_cpu, stack, pooled
    pk_cfg = C.override(tcfg, parts=pcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pbank = train_bank(corpus, list(TRAIN_PHONES), pk_cfg, device=dev)
    torch.cuda.synchronize()
    ptrain_s = time.perf_counter() - t0
    f2 = fcfg.feature_freqs - pcfg.patch_freq + 1
    check(pbank.parts is not None and tuple(pbank.parts.shape) == (pcfg.num_parts,
          pcfg.patch_time, pcfg.patch_freq, 8)
          and tuple(pbank.templates.shape[2:]) == (f2, pcfg.num_parts)
          and bool(torch.isfinite(pbank.templates).all()),
          f"parts bank: {tuple(pbank.templates.shape)}")
    say(f"training: train_bank with parts {ptrain_s:.3f} s wall (without: {train_s:.3f} s) "
        f"-> K {pbank.num_templates}, L {pbank.template_length}, F' {f2}, J "
        f"{pcfg.num_parts} (D {f2 * pcfg.num_parts} a frame)")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = detect_corpus(scan_corpus, pbank, pk_cfg, target_phone="aa")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    n_scan = res.counters["utterances"]
    check("batches" not in res.counters, "the parts bank was not routed to the loop")
    for name in ("frontend_planes", "select_binspread"):
        check(counts.get(name, 0) == n_scan, f"parts loop: {name} launched {counts}")
    ref = _detect_corpus_loop(scan_corpus, pbank, pk_cfg, target_phone="aa", plain=True)
    say(f"training: detect_corpus with the parts bank: the per-utterance loop, "
        f"{n_scan:.0f} utterances in {loop_s:.3f} s = {res.counters['audio_s_per_s']:.1f} "
        f"audio-s/s, launches {counts}")
    # a coded row reads patch_time map rows, a score L coded rows
    check_scan_scores(res.detections, ref.detections,
                      loop_flips(torch, fp, scan_corpus, fcfg, dev),
                      pbank.template_length + pcfg.patch_time - 1, 1e-5, "parts loop", say)
    return em_input, corpus, loaded


# ---- TIMIT input: io/, TimitAdapter, the CLI's timit:<root> ----------------

TIMIT_TEST = 1680          # TIMIT's test set, utterances
TIMIT_TRAIN = 1024         # TIMIT's 4,620 training utterances, cut
TIMIT_PHONES = 16          # phones an utterance: ~3 s, TIMIT's mean
CLI_UTTS = 64              # the CLI's tree, half TRAIN, half TEST
ROW10_TABLE_MS = 3.2234    # PERF.md's bound of row 10 (T - L + 1 starts)


def edge_helper_check(torch, say, dev, fcfg, wavs, nvalid):
    """The classic per-map helpers of ``ops.edges`` on ``cuda``, on kernel
    1's planes of one batch of the TIMIT scan, against kernel 2's map of
    the same planes (the scan's own map: the two-kernel frontend).  A
    cell may differ only where a response ties its channel's threshold
    (within the spread of such a cell), as ``map_flips`` exempts."""
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import edges
    from template_speech_recognition_tpu_torch.ops import selbin_kernel as k2
    from template_speech_recognition_tpu_torch.ops.layout import flat_to_channels

    b, f = wavs.shape[0], fcfg.feature_freqs
    rt, rf, q = fcfg.spread_time, fcfg.spread_freq, fcfg.edge_quantile
    frames = fp._windowed_frames(wavs, fcfg)
    stacked = fp._stacked_planes(frames, fcfg, False)                 # kernel 1
    planes = stacked.reshape(4, b, -1, f)
    fm = fp.frontend_batch_flat(wavs, nvalid, fcfg)
    valid = fm.valid_frames
    flat, _keys = k2.select_binspread(planes, fp._dual_ranks(valid, f, q), valid, rf, rt)
    check(bool(torch.equal(flat.to(torch.bool), fm.binary)),
          "edge helpers: kernel 2 on kernel 1's planes is not the scan's map")
    n_diff = n_tie = n_cells = 0
    t0 = time.perf_counter()
    for i in range(b):
        v = int(valid[i])
        if v == 0:
            continue
        resp = torch.stack([p for j in range(4) for p in (planes[j, i], -planes[j, i])], -1)
        tau = edges.quantile_threshold(resp, q, v)
        tau_sort = edges.quantile_threshold(resp, q, v, method="sort")
        check(bool(torch.equal(tau, tau_sort)),
              f"edge helpers: utterance {i}: radix and sort thresholds differ")
        want = edges.mask_rows(edges.spread_binary(edges.binarize(resp, q, v), rt, rf), v)
        got = flat_to_channels(flat[i].to(torch.bool), f)
        ties = edges.mask_rows(edges.spread_binary(resp == tau, rt, rf), v)
        diff = got != want
        check(not bool((diff & ~ties).any()),
              f"edge helpers: utterance {i}: {int((diff & ~ties).sum())} cells differ "
              f"from kernel 2's map away from a threshold tie")
        n_diff += int(diff.sum())
        n_tie += int((resp[:v] == tau).sum())
        n_cells += want.numel()
    torch.cuda.synchronize()
    say(f"edge helpers (ops.edges on cuda: quantile_threshold by radix and by sort, "
        f"binarize, spread_binary rt {rt} rf {rf}, mask_rows) on kernel 1's planes of one "
        f"TIMIT batch ({b} utterances, T_pad {planes.shape[2]}, F {f}): {n_diff} of {n_cells} "
        f"cells differ from kernel 2's map (tolerance: threshold ties only; {n_tie} valid "
        f"cells tie their threshold); {time.perf_counter() - t0:.3f} s")


def timit_phase(torch, say, dev, C, bank, bank_build, rows, _cuda):
    """A synthetic TIMIT tree through the port's TIMIT input: written by
    ``io.fixtures.write_synthetic_timit``; decoded by the native and the
    Python readers (bitwise); a bank trained on its TRAIN split
    (``TimitAdapter``: kernels 1, 2); the default scan of its TEST split
    with that bank and with the random K 1024 bank, each bitwise the same
    scan over the decoded waveforms held in memory, the int16 upload
    bitwise the float upload; the exact loop traced by
    ``utils.profiling.profile_trace``; the CLI's ``train`` ->
    ``evaluate --tensorboard`` -> ``classify --dtw`` on ``timit:<root>``;
    the edge helpers against kernel 2's map; the roofline lines."""
    import contextlib
    import glob
    import io
    import os
    import tempfile

    from template_speech_recognition_tpu_torch import scan as scan_mod
    from template_speech_recognition_tpu_torch.cli import main as cli_main
    from template_speech_recognition_tpu_torch.corpus import TimitAdapter
    from template_speech_recognition_tpu_torch.io import audio, native
    from template_speech_recognition_tpu_torch.io.corpus import TimitCorpus
    from template_speech_recognition_tpu_torch.io.fixtures import write_synthetic_timit
    from template_speech_recognition_tpu_torch.ops import correlation_kernel as kc
    from template_speech_recognition_tpu_torch.pipeline import (
        detect_corpus,
        evaluate_detections,
        train_bank,
    )
    from template_speech_recognition_tpu_torch.utils.profiling import (
        CostModel,
        profile_trace,
        roofline_report,
    )

    cfg = C.PipelineConfig()
    fcfg = cfg.frontend
    scan_cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B))
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the tree
        root = os.path.join(tmp, "timit")
        t0 = time.perf_counter()
        write_synthetic_timit(root, num_train=TIMIT_TRAIN, num_test=TIMIT_TEST,
                              phones_per_utterance=TIMIT_PHONES, seed=SEED)
        t_write = time.perf_counter() - t0
        corpus = TimitCorpus(root)
        test, train = corpus.split("TEST"), corpus.split("TRAIN")
        check(len(test) == TIMIT_TEST and len(train) == TIMIT_TRAIN,
              f"TIMIT tree: {len(test)} TEST, {len(train)} TRAIN utterances")
        say(f"TIMIT tree (io.fixtures.write_synthetic_timit, WAV and SPHERE alternating, "
            f"{TIMIT_PHONES} phones an utterance): TEST {len(test)} utterances (TIMIT's), "
            f"TRAIN {len(train)} (cut from TIMIT's 4,620 to keep the phase near a minute of "
            f"host time); written in {t_write:.1f} s")

        # 2. decode: the native reader and the Python readers, bitwise
        check(native.available(), "the native reader does not load (native/Makefile)")
        decoded = {}
        for name, read in (("native", native.read_audio), ("Python", audio.read_audio)):
            t0 = time.perf_counter()
            decoded[name] = [read(r.wav_path) for r in corpus.records]
            decoded[name + "_s"] = time.perf_counter() - t0
        check(all(ra == rb == 16000 and wa.dtype == wb.dtype == np.float32
                  and np.array_equal(wa, wb)
                  for (wa, ra), (wb, rb) in zip(decoded["native"], decoded["Python"])),
              "TIMIT decode: the native and the Python readers differ")
        audio_s = sum(len(w) for w, _r in decoded["native"]) / 16000
        say(f"TIMIT decode of {len(corpus.records)} utterances ({audio_s:.1f} audio-s): "
            + ", ".join(f"{n} {decoded[n + '_s']:.3f} s = {audio_s / decoded[n + '_s']:.1f} "
                        f"audio-s/s" for n in ("native", "Python"))
            + "; bitwise equal (host decode, warm page cache)")
        waves = {r.utt_id: w for r, (w, _sr) in zip(corpus.records, decoded["native"])}
        del decoded

        # 3. training on the TRAIN split (kernels 1 and 2)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        tbank = train_bank(TimitAdapter(corpus, "TRAIN"), list(TRAIN_PHONES), cfg, device=dev)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        for name in ("frontend_planes", "select_binspread"):
            check(counts.get(name, 0) > 0, f"TIMIT training: {name} launched {counts}")
        check(tbank.labels == list(TRAIN_PHONES) and bool(torch.isfinite(tbank.templates).all()),
              f"TIMIT training: the bank's labels {tbank.labels} or templates")
        n_ex = {ph: len(corpus.occurrences(ph, "TRAIN")) for ph in TRAIN_PHONES}
        say(f"TIMIT training: train_bank({'/'.join(TRAIN_PHONES)}) on TimitAdapter(split="
            f"'TRAIN') on the card: {t_train:.3f} s with the decode ({n_ex} exemplars), "
            f"K {tbank.num_templates}, L {tbank.template_length}; launches {counts}")

        # 4. the default scan of the TEST split, both banks
        test_ad = TimitAdapter(corpus, "TEST")
        mem = Corpus.held((r.utt_id, waves[r.utt_id],
                           [(s.phone, s.start_sample, s.end_sample)
                            for s in corpus.load_phones(r)]) for r in test)
        head = mem.head(2 * B)
        first = []
        real_fe = scan_mod.frontend_batch_flat

        def spy(w, vs, *a, **k):
            if not first:
                first.append((w.clone(), vs.clone()))
            return real_fe(w, vs, *a, **k)

        def scan(b_, corp, int16=False):
            prev = os.environ.pop("SCAN_UPLOAD_INT16", None)
            if int16:
                os.environ["SCAN_UPLOAD_INT16"] = "1"
            try:
                return scan_mod.detect_corpus_stream(corp, b_, scan_cfg, target_phone="aa")
            finally:
                os.environ.pop("SCAN_UPLOAD_INT16", None)
                if prev is not None:
                    os.environ["SCAN_UPLOAD_INT16"] = prev

        for label, b_ in (("random K 1024", bank), ("trained", tbank)):
            scan(b_, head)                                                     # warm-up
            torch.cuda.synchronize()
            _cuda.reset_launches()
            scan_mod.frontend_batch_flat = spy
            try:
                res = scan(b_, test_ad)
            finally:
                scan_mod.frontend_batch_flat = real_fe
            torch.cuda.synchronize()
            counts = _cuda.launch_counts()
            ctr = res.counters
            nb = int(ctr["batches"])
            for name in SCAN_KERNELS:
                check(counts.get(name, 0) == nb,
                      f"TIMIT scan ({label}): {name} launched {counts.get(name, 0)}x in {nb} "
                      f"batches")
            check(test_ad.sample_rate == 16000 and ctr["utterances"] == TIMIT_TEST,
                  f"TIMIT scan ({label}): {ctr['utterances']} utterances")
            dets = res.detections
            check(len(dets.scores) > 0 and bool(np.isfinite(dets.scores).all()),
                  f"TIMIT scan ({label}): no detections")
            in_mem = scan(b_, mem)
            check(same_detections(dets, in_mem.detections),
                  f"TIMIT scan ({label}): not bitwise the in-memory scan")
            i16 = scan(b_, test_ad, int16=True)
            check(same_detections(dets, i16.detections),
                  f"TIMIT scan ({label}): the int16 upload is not bitwise the float upload")
            ref = scan_mod.detect_corpus_stream(mem, b_, scan_cfg, target_phone="aa", plain=True)
            frac, id_frac, *_ = match_detections(dets, ref.detections)
            check(frac >= 0.99 and id_frac >= 0.99,
                  f"TIMIT scan ({label}) vs plain scan: matched peaks {frac}, same template "
                  f"{id_frac} (limit 0.99)")
            rates = [scan(b_, c).counters["audio_s_per_s"] for c in (test_ad, mem, mem, test_ad)]
            quality = ""
            if "aa" in b_.labels:
                m = evaluate_detections(res, cfg.detect.match_tolerance,
                                        [lb == "aa" for lb in b_.labels])
                quality = (f"; aa: EER {m['eer']:.4f}, best TPR {m['best_tpr']:.4f} over "
                           f"{m['num_labels']:.0f} labels")
            say(f"TIMIT scan ({label} bank) of the TEST split: {nb} batches, "
                f"{ctr['audio_seconds']:.1f} audio-s, {ctr['audio_s_per_s']:.1f} audio-s/s with "
                f"the decode (loop {ctr['time_scan_s']:.4f} s), in memory "
                f"{in_mem.counters['audio_s_per_s']:.1f}, int16 upload "
                f"{i16.counters['audio_s_per_s']:.1f}; then TIMIT, memory, memory, TIMIT: "
                + ", ".join(f"{r:.1f}" for r in rates)
                + f"; {len(dets.scores)} detections bitwise the in-memory scan's and the int16 "
                  f"upload's; against the plain scan {frac:.4f} matched peaks, {id_frac:.4f} "
                  f"same template{quality}; launches {counts}")
            for corp, what in ((test_ad, "with the decode"), (mem, "in memory")):
                report_busy(torch, say, f"TIMIT scan ({label} bank, {what})",
                            lambda corp=corp: scan(b_, corp), bank_build(b_),
                            scan(b_, corp).counters)
            del res, in_mem, i16, ref

        # 5. the exact loop over 8 TEST utterances under profile_trace
        tdir = os.path.join(tmp, "trace")
        ex_cfg = C.PipelineConfig(detect=C.DetectConfig(exact_scores=True))
        with profile_trace(tdir) as prof:
            res = detect_corpus(mem.head(B), tbank, ex_cfg, "aa")
        (path,) = glob.glob(os.path.join(tdir, "*.json"))
        with open(path) as fh:
            names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
        for want in ("frontend", "score", "nms"):
            check(names.count(want) >= B, f"the trace holds {names.count(want)} '{want}' ranges")
        kernels = {k: sum(k in n for n in names) for k in ("planes_kernel", "selbin_cluster")}
        check(all(v >= B for v in kernels.values()), f"the trace's kernel events: {kernels}")
        n_dev = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
        say(f"profile_trace of the exact loop over {B} TEST utterances: a Chrome trace of "
            f"{os.path.getsize(path)} bytes, {len(names)} events ({n_dev} on the device): "
            f"'frontend' {names.count('frontend')}, 'score' {names.count('score')}, 'nms' "
            f"{names.count('nms')} ranges; kernel events {kernels}; "
            f"{len(res.detections.scores)} detections")

        # 6. the CLI on a small tree, as a user runs it
        cli_root = os.path.join(tmp, "timit_cli")
        write_synthetic_timit(cli_root, num_train=CLI_UTTS // 2, num_test=CLI_UTTS // 2,
                              phones_per_utterance=TIMIT_PHONES, seed=SEED + 1)
        spec = f"timit:{cli_root}"
        bank_npz, tb = os.path.join(tmp, "cli_bank.npz"), os.path.join(tmp, "tb")
        steps = (["train", "--phones", ",".join(TRAIN_PHONES), "--bank", bank_npz],
                 ["evaluate", "--bank", bank_npz, "--phone", "aa", "--tensorboard", tb],
                 ["classify", "--bank", bank_npz, "--dtw"])
        lines = []
        repo = os.path.dirname(os.path.abspath(__file__))
        for argv in steps:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "template_speech_recognition_tpu_torch", argv[0],
                 "--corpus", spec, *argv[1:]],
                cwd=repo, capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0,
                  f"CLI {argv[0]} on {spec}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
            lines.append((json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr,
                          time.perf_counter() - t0))
        (tr, _e, tr_s), (ev, ev_err, ev_s), (cl, _e2, cl_s) = lines
        check(tr["trained"] == list(TRAIN_PHONES) and tr["num_templates"] == 2,
              f"CLI train: {tr}")
        check(ev["num_labels"] > 0 and 0.0 <= ev["eer"] <= 1.0, f"CLI evaluate: {ev}")
        check(cl["num_segments"] > 0 and cl["dtw"] and cl["classes"] == list(TRAIN_PHONES),
              f"CLI classify: {cl}")
        if "tensorboard" in ev:
            events = glob.glob(os.path.join(tb, "events.out.tfevents*"))
            check(len(events) == 1, f"CLI evaluate --tensorboard: {events}")
            tb_text = f"tensorboard wrote {os.path.basename(events[0])}"
        else:
            check("tensorboard unavailable" in ev_err, "CLI evaluate: no tensorboard line")
            tb_text = ("tensorboard unavailable: "
                       + ev_err.split("tensorboard unavailable:")[1].strip().splitlines()[0])
        # classify --dtw again in this process: the DTW kernel's launches
        torch.cuda.synchronize()
        _cuda.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli_main(["classify", "--corpus", spec, "--bank", bank_npz, "--dtw"]) == 0,
                  "CLI classify --dtw (in process) failed")
        counts = _cuda.launch_counts()
        check(counts.get("banded_dtw", 0) >= 1, f"CLI classify --dtw: launches {counts}")
        check(json.loads(buf.getvalue().strip().splitlines()[-1]) == cl,
              "CLI classify --dtw: the in-process line differs from the subprocess's")
        say(f"CLI on timit:<root> ({CLI_UTTS} utterances), python -m "
            f"template_speech_recognition_tpu_torch on the card, a process each: train "
            f"{tr_s:.1f} s {json.dumps(tr)}; evaluate --tensorboard {ev_s:.1f} s "
            f"{json.dumps(ev)} ({tb_text}); classify --dtw {cl_s:.1f} s {json.dumps(cl)}; "
            f"in process: launches {counts}")

        # 7. the edge helpers on one batch of the TIMIT scan
        edge_helper_check(torch, say, dev, fcfg, *first[0])

    # 8. roofline lines
    row10 = next(r for r in rows if r["name"] == kc.NAME and r.get("shape") == CORR_BENCH)
    rep = roofline_report(CostModel.direct_scores(B, T_BENCH, K, L, 2048), row10["ms"] / 1e3)
    say(f"roofline_report(CostModel.direct_scores(8, 3000, 1024, 32, 2048), kernel 10's "
        f"{row10['ms']:.4f} ms): " + json.dumps({k: (round(v, 9) if isinstance(v, float) else v)
                                                  for k, v in rep.items()})
        + f"; the kernels line's bound {row10['bound_ms']:.4f} ms (PERF.md's table: "
          f"{ROW10_TABLE_MS}). The cost model counts T = {T_BENCH} starts a map (the "
          f"reference's formula, kept); the kernels line counts the T - L + 1 = "
          f"{T_BENCH - L + 1} starts kernel 10 computes")
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    samples = int(SECONDS * 16000)
    fused = CostModel.frontend_fused_roofline(
        B, samples, fcfg.frame_length, fcfg.hop_length, fcfg.nfft, 0, fcfg.spread_time,
        fcfg.spread_freq, sm_count=props.multi_processor_count,
        sm_clock_hz=float(clock) * 1e6)
    k12 = [r["ms"] for r in rows if r["name"] in ("frontend_planes", "select_binspread")
           and r.get("shape") in (None, SELBIN_BENCH)]
    say(f"frontend_fused_roofline (B {B}, {samples} samples, nfft {fcfg.nfft}; "
        f"{props.multi_processor_count} SMs at {clock} MHz): "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in fused.items() if k.endswith("_s"))
        + f"; bound by {fused['bound']}, {fused['roofline_s'] * 1e3:.4f} ms against kernels "
          f"1 + 2's {sum(k12):.4f} ms ({len(k12)} rows of the kernels line)")


# ---- the sharded scan: parallel/ on torch.distributed ----------------------

# the meshes of the four-rank check on one card, and the EM meshes of two
SHARD_MESHES = ((1, 2, 2), (2, 2, 1))
SHARD_EM_MESHES = ((2, 1, 1), (1, 2, 1))
SHARD_WORLD = 4
SHARD_TIMEOUT = 420        # seconds the four ranks may take in all
DTW_KERNELS = SCAN_KERNELS + ("pair_llr", "banded_dtw")
DTW_INT8_KERNELS = ("frontend_planes", "select_binspread", "fft_block_dft", "fft_binmm_int8",
                    "fft_idft", "pair_llr", "banded_dtw")
SHARD_KERNELS = {"default": SCAN_KERNELS, "DTW": DTW_KERNELS, "DTW + int8": DTW_INT8_KERNELS}
# two scans that must give the same peaks: scores within the default
# scan's bf16 class; a DTW score is a function of the peak's time, its
# template and the map, so the same peaks give it within 1e-4
SAME_TOL = {"default": 4e-3, "DTW": 1e-4, "DTW + int8": 1e-4}


def random_bank(fcfg, rng, k: int = K, length: int = L):
    """A random bank's templates (K 1024 of L 32 by default) and
    background, drawn from ``rng`` (the main run's, or a worker's from
    ``SEED``: the same draws)."""
    templates = rng.uniform(0.01, 0.99, (k, length, fcfg.feature_freqs, 8)).astype(np.float32)
    background = rng.uniform(0.01, 0.99, (fcfg.feature_freqs, 8)).astype(np.float32)
    return templates, background


def shard_configs(C):
    """The three scan configs of the sharded phase: the default scan, DTW
    (verify-the-winner) on bf16 spectra, and DTW on int8 spectra."""
    dtw = dict(batch_size=B, dtw_rescore=True)
    return (("default", C.PipelineConfig(detect=C.DetectConfig(batch_size=B))),
            ("DTW", C.PipelineConfig(detect=C.DetectConfig(**dtw))),
            ("DTW + int8", C.PipelineConfig(detect=C.DetectConfig(**dtw, int8_spectra=True))))


def check_same(label, got, want, tol, say):
    """Two scans that must give the same peaks: equal (utterance, time,
    template) peaks (``match_detections``: all matched, all the same
    template, as many on each side), scores within ``tol`` x max|score|."""
    frac, id_frac, diff, top, _ex = match_detections(got, want)
    same = len(got.scores) == len(want.scores) > 0 and frac == 1.0 and id_frac == 1.0
    say(f"{label}: {len(got.scores)} vs {len(want.scores)} detections, peaks "
        f"{'equal' if same else 'DIFFER'} ({frac:.4f} matched, {id_frac:.4f} same template), "
        f"score max diff {diff:.6g} of max|score| {top:.6g} (tolerance {tol:g}), bitwise "
        f"{same and diff == 0.0}")
    check(same and diff <= tol * top, f"{label}: peaks or scores differ")


def check_int8_split(label, got, want, say):
    """DTW + int8 at a split mesh against the unsplit scan (a): the block
    spectra quantize per shard call over the shard's own extent, so
    borderline peaks move with the split (the reference's class for it,
    ``tests/test_detect_sharded.py:270-284``, leaves 2 of its 14-17 peaks
    unmatched, up to 12%): >= 95% matched peaks, >= 99% of them with the
    same template, and the DTW scores of those within 1e-4 of max|score|.
    Set after the H100 read 0.9826 / 0.9841 matched and 0.9995 same
    template (PERF.md); the DTW scan on bf16 spectra at the same mesh,
    which must give (a)'s peaks, and this scan's plain run at the same
    mesh witness that the gap is the quantization's."""
    frac, id_frac, diff, top, _ex = match_detections(got, want)
    say(f"{label}: {len(got.scores)} vs {len(want.scores)} detections, {frac:.4f} matched "
        f"peaks, {id_frac:.4f} same template on matched; DTW score max diff {diff:.6g} of "
        f"max|score| {top:.6g} (tolerance 1e-4)")
    check(frac >= 0.95 and id_frac >= 0.99, f"{label}: matched {frac}, same template {id_frac}")
    check(diff <= 1e-4 * top, f"{label}: DTW scores differ by {diff}")


def shard_counts_line(counts, names):
    return ", ".join(f"{n} {counts.get(n, 0)}" for n in names)


def sharded_phase(torch, say, dev, C, corpus, bank, stream_dets, flips, em_input, _cuda):
    """``parallel.detect_corpus_sharded`` and ``sharded_bernoulli_mixture_em``
    on the card: (a) NCCL in a world of one, mesh (1, 1, 1), the three
    scan configs at full width, each with the peaks of the card's
    ``detect_corpus_stream`` of the same config (``stream_dets``: the
    default and DTW + int8 scans of the main run); (b) four ranks on
    this one card, gloo with host-staged tensors, meshes (1, 2, 2) and
    (2, 2, 1), the three configs against (a) (DTW + int8 in its split
    class) and DTW + int8 against its own plain run at the same mesh,
    in the kernel-vs-plain class of the unsharded scan (``flips``: the
    default frontend's flipped cells at the main run's batch shape);
    (c) EM on two of those ranks, data 2 then bank 2, against the
    card's ``bernoulli_mixture_em``.  Launch counts are set to 0 just
    before each sharded scan and read just after, on every rank.  (b)
    is one card time-sliced by four processes: its times are no
    multi-GPU number."""
    import os
    import tempfile

    import torch.distributed as dist

    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.models.mixture import bernoulli_mixture_em
    from template_speech_recognition_tpu_torch.parallel import (
        bootstrap,
        build_mesh,
        detect_corpus_sharded,
    )
    from template_speech_recognition_tpu_torch.scan import detect_corpus_stream, stream_scan

    configs = dict(shard_configs(C))
    stream_dets = dict(stream_dets, DTW=detect_corpus_stream(
        corpus, bank, configs["DTW"], target_phone="aa").detections)
    # the flipped map cells at each data split's batch shape: a rank of a
    # split data axis runs the frontend on B / n_data rows, tails unshrunk
    flips_at = {1: flips}
    for n_data in sorted({m[0] for m in SHARD_MESHES} - {1}):
        b_l = B // n_data
        flips_at[n_data], n_diff, n_all = map_flips(
            torch, fp, stream_scan, corpus, C.FrontendConfig(), b_l, dev,
            local_rows=set(range(b_l)))
        say(f"default frontend at batch {b_l}: {n_diff} of {n_all} binary-map cells differ "
            f"from the plain run's, in {sum(len(v) for v in flips_at[n_data].values())} frames")
    # (a) NCCL, one rank
    bootstrap.initialize_distributed("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                     world_size=1, rank=0,
                                     device=torch.device("cuda", torch.cuda.current_device()))
    single = {}
    try:
        mesh = build_mesh(C.MeshConfig(1, 1, 1))
        for label, cfg in shard_configs(C):
            detect_corpus_sharded(corpus.head(B), bank, cfg, mesh, target_phone="aa")  # warm-up
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            res = detect_corpus_sharded(corpus, bank, cfg, mesh, target_phone="aa")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            for name in SHARD_KERNELS[label]:
                check(counts.get(name, 0) > 0, f"sharded (a) {label}: {name} not launched")
            ctr = res.counters
            say(f"sharded (a) NCCL, world 1, mesh (1, 1, 1), {label}: {ctr['utterances']:.0f} "
                f"utterances, {ctr['audio_seconds']:.1f} audio-s, wall {wall:.4f} s = "
                f"{ctr['audio_seconds'] / wall:.1f} audio-s/s (scan loop "
                f"{ctr['audio_s_per_s']:.1f} audio-s/s), collective_bytes "
                f"{ctr.get('collective_bytes', 0.0):.0f}; launches {counts}")
            check_same(f"sharded (a) {label} vs detect_corpus_stream", res.detections,
                       stream_dets[label], SAME_TOL[label], say)
            single[label] = res.detections
            del res
    finally:
        dist.destroy_process_group()

    # (b) and (c): four ranks on this card
    x, resp, iters = em_input
    n = x.shape[0]
    mask = np.ones(n + n % 2, np.float32)
    if n % 2:                      # data 2 splits the rows: one masked row
        x = np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)])
        resp = np.concatenate([resp, resp[-1:]])
        mask[-1] = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "corpus.npz"), w=np.stack([w for _u, w, _p in corpus.utts]))
        np.savez(os.path.join(tmp, "em.npz"), x=x, resp=resp, mask=mask, iters=iters)
        t0 = time.perf_counter()
        # one card: every rank's device is GPU 0
        codes, logs = launch_ranks([sys.executable, __file__, "--sharded-worker", tmp],
                                   SHARD_WORLD, SHARD_TIMEOUT, tmp, one_card=True)
        for rank, (code, (out, err)) in enumerate(zip(codes, logs)):
            for line in (out + err).strip().splitlines()[-6:]:
                say(f"sharded rank {rank}: {line}")
            check(code == 0, f"sharded rank {rank} exited {code}")
        say(f"sharded (b), (c): four ranks in {time.perf_counter() - t0:.1f} s, the start of "
            f"four processes included")
        recs = []
        for rank in range(SHARD_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                recs.append(json.load(f))
        z = dict(np.load(os.path.join(tmp, "out.npz")))

    from template_speech_recognition_tpu_torch.detect.evaluate import DetectionSet

    for mesh_shape in SHARD_MESHES:
        for label, _cfg in shard_configs(C):
            tag = f"{mesh_shape}/{label}"
            for rank, rec in enumerate(recs):
                for name in SHARD_KERNELS[label]:
                    check(rec["counts"][tag].get(name, 0) > 0,
                          f"sharded (b) {tag}: rank {rank} did not launch {name}")
            r0 = recs[0]
            ctr = r0["counters"][tag]
            say(f"sharded (b) gloo host-staged, 4 ranks on one card, mesh {mesh_shape}, "
                f"{label}: wall {r0['wall'][tag]:.4f} s = {ctr['audio_seconds'] / r0['wall'][tag]:.1f} "
                f"audio-s/s (one card time-sliced by four processes: no multi-GPU number), "
                f"collective_bytes {ctr.get('collective_bytes', 0.0):.0f}; launches by rank: "
                + "; ".join(shard_counts_line(rec["counts"][tag], SHARD_KERNELS[label])
                            for rec in recs))

            def dets(key):
                return DetectionSet(*(z[f"{key}/{f}"] for f in
                                      ("scores", "times", "template_ids", "utterance_ids")))

            name = f"sharded (b) mesh {mesh_shape} {label}"
            if label != "DTW + int8":
                check_same(f"{name} vs (a)", dets(tag), single[label], SAME_TOL[label], say)
                continue
            check_int8_split(f"{name} vs (a)", dets(tag), single[label], say)
            check_scan_scores(dets(tag), dets(f"{tag}/plain"), flips_at[mesh_shape[0]],
                              L + configs[label].dtw.band, 1e-4, f"{name} (per-shard int8)",
                              say)
    # (c)
    xt = torch.from_numpy(x[:n]).to(dev)
    want = bernoulli_mixture_em(xt, resp[:n], num_iters=int(iters))
    for mesh_shape in SHARD_EM_MESHES:
        tag = f"em{mesh_shape}"
        it = int(z[f"{tag}/iteration"])
        means, hist = z[f"{tag}/means"], z[f"{tag}/history"]
        mean_err = float(np.max(np.abs(means - want.means.cpu().numpy())))
        hw = want.history.cpu().numpy()
        ok_hist = (np.array_equal(np.isnan(hist), np.isnan(hw))
                   and np.allclose(hist[:it], hw[:it], rtol=1e-4, atol=1e-3))
        say(f"sharded (c) EM at x [{n}, {x.shape[1]}] ({len(mask) - n} masked row), K "
            f"{resp.shape[1]}, mesh {mesh_shape} on 2 ranks: {it} iterations (card's "
            f"bernoulli_mixture_em {int(want.iteration)}) in {recs[0]['em_ms'][tag]:.3f} ms; "
            f"means max diff {mean_err:.3g}; histories within rtol 1e-4 / atol 1e-3: {ok_hist}")
        check(it == int(want.iteration), f"sharded EM {mesh_shape}: {it} iterations")
        check(np.allclose(means, want.means.cpu().numpy(), rtol=1e-4, atol=1e-5),
              f"sharded EM {mesh_shape}: means differ by {mean_err}")
        check(ok_hist, f"sharded EM {mesh_shape}: histories differ")


def sharded_worker(tmp: str) -> int:
    """One rank of the sharded phase's four (``chip_smoke.py
    --sharded-worker DIR``): joins the gloo world of torchrun's
    variables on GPU 0, scans the corpus of ``DIR/corpus.npz`` with the
    random bank on each mesh of ``SHARD_MESHES`` in both configs, then
    fits EM on ``SHARD_EM_MESHES``; writes ``rank<r>.json`` (launch
    counts, walls, counters) and, on rank 0, ``out.npz``."""
    import os

    import torch
    import torch.distributed as dist

    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.convert import bank_from_numpy
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.parallel import (
        bootstrap,
        build_mesh,
        detect_corpus_sharded,
        sharded_bernoulli_mixture_em,
    )
    from template_speech_recognition_tpu_torch.parallel.feeding import Placement, fetch_global

    bootstrap.initialize_distributed("gloo")
    rank = dist.get_rank()
    dev = bootstrap.rank_device()
    fcfg = C.FrontendConfig()
    templates, background = random_bank(fcfg, np.random.default_rng(SEED))
    bank = bank_from_numpy(templates, background, [f"k{i}" for i in range(K)], dev)
    wavs = np.load(os.path.join(tmp, "corpus.npz"))["w"]
    corpus = Corpus.held([(f"u{i}", w, []) for i, w in enumerate(wavs)])
    out, rec = {}, {"counts": {}, "wall": {}, "counters": {}, "em_ms": {}}
    for mi, mesh_shape in enumerate(SHARD_MESHES):
        mesh = build_mesh(C.MeshConfig(*mesh_shape))
        for label, cfg in shard_configs(C):
            tag = f"{mesh_shape}/{label}"
            if mi == 0:
                detect_corpus_sharded(corpus.head(B), bank, cfg, mesh)      # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            res = detect_corpus_sharded(corpus, bank, cfg, mesh)
            torch.cuda.synchronize()
            rec["wall"][tag] = time.perf_counter() - t0
            rec["counts"][tag] = _cuda.launch_counts()
            rec["counters"][tag] = {k: float(v) for k, v in res.counters.items()}
            runs = {tag: res.detections}
            if label == "DTW + int8":
                # the same per-shard arithmetic on the plain versions
                runs[f"{tag}/plain"] = detect_corpus_sharded(corpus, bank, cfg, mesh,
                                                             plain=True).detections
            for key, d in runs.items():
                for f in ("scores", "times", "template_ids", "utterance_ids"):
                    out[f"{key}/{f}"] = np.asarray(getattr(d, f))
            print(f"{tag}: {len(res.detections.scores)} detections in {rec['wall'][tag]:.3f} s",
                  flush=True)
    em = np.load(os.path.join(tmp, "em.npz"))
    x = torch.from_numpy(em["x"]).to(dev)
    for mesh_shape in SHARD_EM_MESHES:
        mesh = build_mesh(C.MeshConfig(*mesh_shape))
        if mesh.get_coordinate() is None:
            continue
        tag = f"em{mesh_shape}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sharded_bernoulli_mixture_em(x, em["resp"], mesh, num_iters=int(em["iters"]),
                                          mask=torch.from_numpy(em["mask"]).to(dev))
        torch.cuda.synchronize()
        rec["em_ms"][tag] = (time.perf_counter() - t0) * 1e3
        out[f"{tag}/means"] = fetch_global(st.means, Placement(mesh, ("bank",)))
        out[f"{tag}/iteration"] = st.iteration.cpu().numpy()
        out[f"{tag}/history"] = st.history.cpu().numpy()
        print(f"{tag}: {int(st.iteration)} iterations", flush=True)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# the template lengths whose pick_nfft needs kernel 3's multi-pass
# plans, each scanned with a random bank of its own: (K, L, scans); K 1024
# at L 48 (nfft 239) and L 80 (nfft 399, also DTW + int8: config 4), K
# 4096 at L 33 (nfft 240, the 10K-class hop; also on int8 spectra:
# config 5)
SHAPE_BANKS = ((1024, 48, ("default",)), (1024, 80, ("default", "DTW + int8")),
               (4096, 33, ("default", "int8")))
# kernel 3 alone at two more lengths, the basis streamed: six passes of
# 96 columns (L 103, nfft 518) and 14 of 128 (L 256 of K 4096, nfft 1791)
SHAPE_DFT_ONLY = ((1024, 103), (4096, 256))
DTW_LONG = (300, 6)        # the DTW kernel past L 256: (L, band)


def shapes_phase(torch, say, dev, C, corpus, x_map, flips, record, rows, M):
    """The FFT scan at template lengths past kernel 3's one-pass plans.
    Kernel 3 on the scan's map at each ``SHAPE_BANKS`` and
    ``SHAPE_DFT_ONLY`` nfft, kernels 4 and 5 on its spectra with the
    case's bank, kernel 6 on them quantized where the case scans on int8
    spectra (the row helpers' tolerances, a ``shape`` row each); then
    ``detect_corpus_stream`` over the corpus with each bank: the default
    scan (bf16 spectra), at K 4096 also on int8 spectra, at L 80 also DTW
    + int8, each with the launch counts set to 0 just before and read
    just after, against its plain run (``check_scan_scores``: 4e-3 of
    max|score| on the sliding scans' matches, 1e-4 on the DTW scan's, a
    window of L and L + band frames); the DTW scan's pair-LLR operands
    and DTW tiles (L 80: the ring route) held to the plain versions and
    timed; and the DTW kernel at ``DTW_LONG`` in raw and fused mode,
    bitwise."""
    fs, k3, k4, k5, kd, kp, _cuda = M.fs, M.k3, M.k4, M.k5, M.kd, M.kp, M._cuda
    rng = np.random.default_rng(SEED + 7)
    fcfg = C.FrontendConfig()
    b_, t_pad, d_ = x_map.shape
    t_phase = time.perf_counter()

    def dft_row(k_, l_):
        nfft_ = fs.pick_nfft(l_, k_)
        hop_ = nfft_ - l_ + 1
        nblk_ = -(-(t_pad - l_ + 1) // hop_)
        g_ = fs._dft_basis(nfft_, torch.bfloat16, dev)
        shape = f"L {l_}, K {k_}: B {b_}, T {t_pad}, D {d_}, nfft {nfft_}"
        return M.record_dft(k3, x_map, g_, nfft_, hop_, nblk_, shape), shape

    for k_, l_ in SHAPE_DFT_ONLY:
        dft_row(k_, l_)
    for k_, l_, scan_labels in SHAPE_BANKS:
        tag = f"L {l_}, K {k_}"
        templates = rng.uniform(0.01, 0.99, (k_, l_, fcfg.feature_freqs, 8)).astype(np.float32)
        background = rng.uniform(0.01, 0.99, (fcfg.feature_freqs, 8)).astype(np.float32)
        bank = M.bank_from_numpy(templates, background, [f"k{i}" for i in range(k_)], dev)
        del templates
        wf, cf = bank.llr()
        fbank = fs.build_fft_bank(M.filters_to_flat(wf), cf, mm_dtype=torch.bfloat16)
        nfft_ = fbank.nfft
        hop_, bins_ = nfft_ - l_ + 1, nfft_ // 2 + 1
        nblk_ = -(-(t_pad - l_ + 1) // hop_)
        m_ = b_ * nblk_
        (xr, xi), dft_shape = dft_row(k_, l_)
        plan = k3.plan(b_, d_, nfft_, nblk_, bins_, k3._sm_count(str(dev)))
        check(plan.passes > 1, f"{tag}: nfft {nfft_} takes one pass ({plan})")

        # kernels 4 and 5 as the scan runs them: the hi and lo planes, their iDFT
        binmm_shape = f"{tag}: bins {bins_}, m {m_}, D {d_}, K {fbank.k}"
        ycat = binmm_row(torch, k4, record, xr, xi, fbank.w2, binmm_shape,
                         dict(reps=3, warm=1))
        idft_shape = f"{tag}: 2 bins {2 * bins_} (hi, lo), hop {hop_}, m {m_}, K {fbank.k}"
        y2 = ycat.reshape(-1, m_ * fbank.k)
        idft_row(torch, k5, record, y2,
                 fs._idft_basis(nfft_, hop_, torch.bfloat16, dev, y2.shape[0] // (2 * bins_)),
                 fbank.c, nblk_,
                 idft_shape, plain_kw=dict(reps=3, warm=1))
        del ycat

        # kernel 6 on the same spectra quantized, where the case scans int8
        int8_shape = f"{tag}: bins {bins_}, m {m_}, D {d_}, K {fbank.k}"
        if any("int8" in label for label in scan_labels):
            fbank8 = fs.build_fft_bank(M.filters_to_flat(wf), cf, mm_dtype=torch.int8)
            xq_r, xq_i, sc8 = fs.quantize_block_spectra(xr, xi, fbank8.w2_scale)
            M.record_int8(k4, fbank8, xq_r, xq_i, sc8, m_, int8_shape)
            del fbank8, xq_r, xq_i, sc8
        del xr, xi, fbank
        torch.cuda.empty_cache()

        # the scans
        band = C.DTWConfig().band
        int8_kernels = SCAN_KERNELS[:3] + ("fft_binmm_int8", "fft_idft")
        scans = {"default": (dict(), SCAN_KERNELS, l_, 4e-3),
                 "int8": (dict(int8_spectra=True), int8_kernels, l_, 4e-3),
                 "DTW + int8": (dict(dtw_rescore=True, int8_spectra=True),
                                int8_kernels + ("pair_llr", "banded_dtw"), l_ + band, 1e-4)}
        for label in scan_labels:
            dkw, expect, window, tol = scans[label]
            cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B, **dkw))
            seen = {}
            real = (M.dtw_mod.pair_llr, M.dtw_mod.banded_dtw_scores)

            def keep_first(name, fn):
                def run(*a, **kw):
                    seen.setdefault(name, ([x.clone() if torch.is_tensor(x) else x for x in a],
                                           dict(kw)))
                    return fn(*a, **kw)
                return run

            M.dtw_mod.pair_llr = keep_first("pair_llr", real[0])
            M.dtw_mod.banded_dtw_scores = keep_first("banded_dtw", real[1])
            torch.cuda.synchronize()
            _cuda.reset_launches()
            try:
                t0 = time.perf_counter()
                res = M.detect_corpus_stream(corpus, bank, cfg, target_phone="aa")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                M.dtw_mod.pair_llr, M.dtw_mod.banded_dtw_scores = real
            counts = _cuda.launch_counts()
            for name in expect:
                check(counts.get(name, 0) > 0, f"{name} was not launched by the {tag} {label} "
                                               f"scan")
            if "int8_spectra" in dkw:
                check(counts.get("fft_binmm", 0) == 0, f"the {tag} {label} scan launched the "
                                                       f"bf16 bin matmul")
                take_launches(rows, ("fft_binmm_int8",), counts, shape=int8_shape)
            else:
                take_launches(rows, ("fft_block_dft",), counts, shape=dft_shape)
                take_launches(rows, ("fft_binmm",), counts, shape=binmm_shape)
                take_launches(rows, ("fft_idft",), counts, shape=idft_shape)
            ctr = res.counters
            say(f"{tag} {label} scan: {ctr['utterances']:.0f} utterances, "
                f"{ctr['audio_seconds']:.1f} audio-s, one pass, no warm-up: "
                f"{ctr['audio_s_per_s']:.1f} audio-s/s (with the bank build {wall:.3f} s); "
                f"launches {counts}")
            ref = M.detect_corpus_stream(corpus, bank, cfg, target_phone="aa", plain=True)
            check_scan_scores(res.detections, ref.detections, flips, window, tol,
                              f"{tag} {label} scan", say)
            del res, ref
            if "pair_llr" in seen:
                dtw_shape = f"{tag} DTW + int8 scan's first batch"
                a_p, _kw = seen["pair_llr"]
                got_p, want_p = kp.pair_llr(*a_p), kp.pair_llr_plain(*a_p)
                err_p, top_p = float((got_p - want_p).abs().max()), float(want_p.abs().max())
                check(err_p <= 1e-5 * top_p, f"pair_llr ({dtw_shape}): {err_p} > 1e-5 * {top_p}")
                fmap_, w16_, rowstart_, ids_, m_llr = a_p
                n_pairs, n_map = rowstart_.numel(), fmap_.shape[0] * fmap_.shape[1]
                # least bytes as for the scan's pairs: the distinct map rows
                # the windows cover, the distinct filters, the tiles
                rows_g = rowstart_.long()[:, None] + torch.arange(m_llr, device=dev)
                covered = torch.zeros(n_map, dtype=torch.bool, device=dev)
                covered[rows_g[rows_g < n_map]] = True
                seg_g = fmap_.reshape(n_map, -1)[rows_g.clamp(max=n_map - 1)].to(torch.bfloat16)
                wk_g = w16_[ids_.long()]
                record(
                    kp, err_p, "1e-5 * max|ref|",
                    time_ms(torch, lambda: kp.pair_llr(*a_p), loop=100),
                    time_ms(torch, lambda: kp.pair_llr_plain(*a_p)),
                    time_ms(torch, lambda: torch.bmm(wk_g, seg_g.transpose(1, 2)), loop=100),
                    int(covered.sum()) * d_ + int(torch.unique(ids_).numel()) * l_ * d_ * 2
                    + n_pairs * 8 + got_p.numel() * 4,
                    2 * n_pairs * l_ * m_llr * d_, BF16_FLOPS,
                    shape=f"{dtw_shape}: {n_pairs} pairs, L {l_}, m {m_llr}")
                take_launches(rows, ("pair_llr",), counts, shape=rows[-1]["shape"])
                a_d, kw_d = seen["banded_dtw"]
                llr_d, lens_d, c_d, band_d = a_d
                check(not kd.whole_tile(llr_d[:, None], band_d),
                      f"banded_dtw ({dtw_shape}): the tiles fit the whole-tile mode")
                got_d = kd.banded_dtw_scores(*a_d, **kw_d)
                check_scores(torch, got_d, kd.banded_dtw_scores_plain(*a_d, **kw_d),
                             f"banded_dtw ({dtw_shape})")
                check(bool(torch.equal(got_d, kd.banded_dtw_scores(*a_d, **kw_d))),
                      f"banded_dtw ({dtw_shape}): two launches differ")
                cells = band_cells(torch, l_, llr_d.shape[-1], lens_d, band_d)
                record(
                    kd, 0.0, "bitwise on finite scores, -inf alike",
                    time_ms(torch, lambda: kd.banded_dtw_scores(*a_d, **kw_d), loop=100),
                    time_ms(torch, lambda: kd.banded_dtw_scores_plain(*a_d, **kw_d)), None,
                    cells * 4 + int(torch.unique(kw_d["cid"]).numel()) * l_ * 4
                    + llr_d.shape[0] * 12,
                    5 * cells, FP32_FLOPS,
                    shape=f"{dtw_shape}: {llr_d.shape[0]} pairs, L {l_}, m {llr_d.shape[-1]}, "
                          f"band {band_d}, ring route")
                take_launches(rows, ("banded_dtw",), counts, shape=rows[-1]["shape"])
                del seen, a_p, a_d, got_p, want_p, got_d, seg_g, wk_g, covered
        del bank, wf, cf
        torch.cuda.empty_cache()

    # the DTW kernel past L 256: raw (cost in, terminals out) and fused
    # (LLR in, scores out), ring route, bitwise
    l_long, band = DTW_LONG
    m_long, n_long = l_long + band, B * 123
    cost = torch.from_numpy(
        (rng.standard_normal((n_long, l_long, m_long)) + 2.0).astype(np.float32)).to(dev)
    lens = torch.from_numpy(rng.integers((l_long + band) // 2, m_long + 1,
                                         n_long).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, K, n_long).astype(np.int32)).to(dev)
    ctab = torch.randn(K, l_long, device=dev)
    check_terminals(torch, kd.banded_dtw(cost, lens, band), kd.banded_dtw_plain(cost, lens, band),
                    f"banded_dtw raw (L {l_long})")
    args = (-cost, lens, ctab, band, ids)
    check_scores(torch, kd.banded_dtw_scores(*args), kd.banded_dtw_scores_plain(*args),
                 f"banded_dtw fused (L {l_long})")
    cells = band_cells(torch, l_long, m_long, lens, band)
    long_shape = f"L {l_long}, band {band}: {n_long} pairs, m {m_long}, ring route"
    record(
        kd, 0.0, "bitwise on finite scores, -inf alike",
        time_ms(torch, lambda: kd.banded_dtw_scores(*args), loop=100),
        time_ms(torch, lambda: kd.banded_dtw_scores_plain(*args), reps=3, warm=1), None,
        cells * 4 + int(torch.unique(ids).numel()) * l_long * 4 + n_long * 12,
        5 * cells, FP32_FLOPS, shape=f"fused, {long_shape}")
    raw_ms = time_ms(torch, lambda: kd.banded_dtw(cost, lens, band), loop=100)
    say(f"banded_dtw raw at {long_shape}: bitwise; {raw_ms:.4f} ms (loops of 100); the chain is "
        f"up to {l_long + m_long - 1} diagonals")
    del cost, args, ctab
    torch.cuda.empty_cache()
    say(f"shapes phase: {time.perf_counter() - t_phase:.1f} s")


# the domain phase: inputs that only the reference used to score
DOMAIN_MELS = ((485, 1024), (968, 2048))   # kernel 1 in chunks: (n_mels, nfft)
DOMAIN_MEL_UTTS = 2                        # utterances of the map and planes
DOMAIN_DTW = ((601, 300, 132), (1101, 550, 132))   # the wide route: (L, band, pairs)
DOMAIN_D = (500, 36)                       # D % 8 != 0 in kernels 3, 4, 10 and 11
DOMAIN_ROWS = (4097, 2)                    # kernel 10 past 2^31 rows: T, L (T'' 4096)
DOMAIN_ROW_LIMIT = 2**31
DOMAIN_LD = (32769, 65536)                 # kernel 10 past L*D = 2^31: L, D


def domain_phase(torch, say, dev, wavs, nvalid, record, rows):
    """Inputs the kernels refused before and the reference scores, each
    on its kernel on the card (launch counts set to 0 just before each
    call and read just after: the kernel ran, as many times as the call
    needs) against its plain version, with the tolerance stated:

    * kernel 1 in mel mode past ``MAX_MELS`` filters (``DOMAIN_MELS``:
      two and three chunks), its planes against float64
      (``check_planes``) and the map of ``frontend_batch_flat`` (two
      utterances) against the plain run's (<= 1e-3 of cells); and at
      n_mels 129 forced into chunks of 50 filters, bitwise the one launch;
    * the DTW kernel's wide route at windows 601 and 1101 and one pair of
      12,300 rows (its state past shared memory, in scratch), raw and
      fused, bitwise;
    * kernels 3, 4, 10 and 11 at D 500 and 36 and at a base one element off
      (their wrappers pad to D8), and the FFT scorer with a D 36 bank;
    * kernel 10 at B*T'' just past 2^31 (D 8; the utterances either side
      of row 2^31 against the plain version) and at L*D past 2^31.
    New ``shape`` rows in the kernels line; the padding copy at D 500
    timed."""
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.detect import fft_scorer as fs
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import (
        correlation_kernel as kc,
        dtw_kernel as kd,
        fft_binmm_kernel as k4,
        fft_dft_kernel as k3,
        frontend_kernel as k1,
        pair_llr_kernel as kp,
    )
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def launched(fn, expect, label):
        """fn() with the launch counts set to 0 just before and read just
        after: each name in ``expect`` launched that many times."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        for name, n in expect.items():
            check(counts.get(name, 0) == n, f"{label}: {name} launched {counts.get(name, 0)} "
                                            f"times, not {n}")
        return out, counts

    def close(got, want, rel, label):
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        check(err <= rel * top, f"{label}: {err} > {rel} * {top}")
        return err

    # ---- kernel 1: the mel mode past MAX_MELS filters, in chunks ------
    mel = SimpleNamespace(NAME=k1.MEL_NAME, SOURCE=k1.SOURCE, REPLACES=k1.MEL_REPLACES)
    w2_, n2_ = wavs[:DOMAIN_MEL_UTTS], nvalid[:DOMAIN_MEL_UTTS]
    for n_mels, nfft in DOMAIN_MELS:
        cfg = C.FrontendConfig(use_mel=True, n_mels=n_mels, nfft=nfft)
        sr = cfg.sample_rate
        x = fp._windowed_frames(w2_, cfg)
        x = x.reshape(-1, x.shape[-1]).contiguous()
        n_rows, fl = x.shape
        chunks = k1.mel_chunks(n_mels)
        label = f"frontend_planes (n_mels {n_mels}, nfft {nfft}, {len(chunks)} chunks)"
        got, _ = launched(lambda: k1.edge_response_planes(x, nfft, sr, n_mels),
                          {k1.MEL_NAME: len(chunks)}, label)
        want = k1.edge_response_planes_plain(x, nfft, sr, n_mels)
        m = check_planes(torch, x, nfft, got, want, label, sr, n_mels, min_share=0.0)
        cos_m, sin_m = dft_matrices(fl, nfft, dev)
        cs = torch.cat([cos_m, sin_m], dim=1).contiguous()
        _fbt, mr = k1._mel_on(sr, nfft, n_mels, str(dev))
        nnz = int((mr[:, 1] - mr[:, 0]).sum())
        bins = nfft // 2 + 1
        record(mel, m["err"], "scaled 1e-5 of float64; error bounds",
               time_ms(torch, lambda: k1.edge_response_planes(x, nfft, sr, n_mels), loop=10),
               time_ms(torch, lambda: k1.edge_response_planes_plain(x, nfft, sr, n_mels)),
               time_ms(torch, lambda: torch.matmul(x, cs), loop=10),
               n_rows * fl * 4 + 2 * fl * bins * 4 + bins * n_mels * 4
               + 4 * n_rows * (n_mels - 1) * 4,
               2 * 2 * n_rows * fl * bins + 2 * n_rows * nnz, FP32_FLOPS, tf32=True,
               shape=f"mel chunks: N {n_rows}, FL {fl}, nfft {nfft}, n_mels {n_mels}")
        rows[-1]["launches"] = len(chunks)
        say(f"{label}: {float64_text(m)}")
        del got, want
        # the map through frontend_batch_flat: the two-kernel path at F 484
        # (kernel 2), the layered one at F 967 (kernels 8 and 9)
        fused = fp._fused_ok(cfg)
        check(fused == (cfg.feature_freqs % 4 == 0), f"n_mels {n_mels}: path rule {fused}")
        expect = {k1.MEL_NAME: len(chunks)}
        expect.update({"select_binspread": 1} if fused else {"radix_select": 1, "binspread": 1})
        fm, counts = launched(lambda: fp.frontend_batch_flat(w2_, n2_, cfg).binary, expect,
                              f"frontend_batch_flat (n_mels {n_mels})")
        plain = fp.frontend_batch_flat(w2_, n2_, cfg, plain=True).binary
        share = int((fm != plain).sum()) / plain.numel()
        check(share <= 1e-3, f"n_mels {n_mels}: {share} of the map cells differ from the plain "
                             f"run's")
        say(f"frontend_batch_flat (n_mels {n_mels}, nfft {nfft}, "
            f"{'two-kernel' if fused else 'layered'} path): map {tuple(fm.shape)}, "
            f"{int(fm.sum())} set cells, {share:.3g} of them unlike the plain run's "
            f"(tolerance 1e-3); launches {counts}")
        del fm, plain, x
    # the chunking itself: n_mels 129 in chunks of 50 filters, bitwise the
    # one launch
    x = fp._windowed_frames(w2_, C.FrontendConfig()).reshape(-1, 400).contiguous()
    one = k1.edge_response_planes(x, 512, 16000, 129)
    saved = k1.MAX_MELS
    k1.MAX_MELS = 50
    try:
        forced, _ = launched(lambda: k1.edge_response_planes(x, 512, 16000, 129),
                             {k1.MEL_NAME: 3}, "frontend_planes (n_mels 129 in chunks of 50)")
    finally:
        k1.MAX_MELS = saved
    check(bool(torch.equal(one, forced)), "frontend_planes: chunks of 50 filters are not the "
                                          "one launch's planes")
    say("frontend_planes at n_mels 129 in 3 chunks of <= 50 filters: bitwise the one launch")
    del one, forced, x

    # ---- the DTW kernel's wide route: raw and fused, bitwise -----------
    for length, band, n in DOMAIN_DTW:
        m_ = length + 40
        sched = kd.wide_schedule(length, m_, band)
        check(kd.is_wide(length, m_, band), f"L {length}, band {band}: not the wide route")
        cost = torch.randn(n, length, m_, device=dev, generator=gen) + 2.0
        lens = torch.from_numpy(rng.integers(length // 2, m_ + 1, n).astype(np.int32)).to(dev)
        lens[0] = m_
        ids = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(dev)
        ctab = torch.randn(64, length, device=dev, generator=gen)
        tag = (f"wide route, window {min(2 * band + 1, length)}: L {length}, band {band}, "
               f"{n} pairs, m {m_}, WP {sched['WP']}, "
               f"{'scratch' if sched['scratch_words'] else 'shared memory'}")
        raw, _ = launched(lambda: kd.banded_dtw(cost, lens, band), {kd.NAME: 1},
                          f"banded_dtw raw ({tag})")
        check_terminals(torch, raw, kd.banded_dtw_plain(cost, lens, band),
                        f"banded_dtw raw ({tag})")
        args = (-cost, lens, ctab, band, ids)
        got, _ = launched(lambda: kd.banded_dtw_scores(*args), {kd.NAME: 1},
                          f"banded_dtw fused ({tag})")
        want, plain_ms = time_once(torch, lambda: kd.banded_dtw_scores_plain(*args))
        check_scores(torch, got, want, f"banded_dtw fused ({tag})")
        check(bool(torch.equal(got, kd.banded_dtw_scores(*args))),
              f"banded_dtw ({tag}): two launches differ")
        cells = band_cells(torch, length, m_, lens, band)
        record(kd, 0.0, "bitwise on finite scores, -inf alike",
               time_ms(torch, lambda: kd.banded_dtw_scores(*args), reps=5, warm=1),
               plain_ms, None, cells * 4 + int(torch.unique(ids).numel()) * length * 4 + n * 12,
               5 * cells, FP32_FLOPS, shape=f"fused, {tag}")
        rows[-1]["launches"] = 1
        raw_ms = time_ms(torch, lambda: kd.banded_dtw(cost, lens, band), reps=5, warm=1)
        say(f"banded_dtw ({tag}): raw and fused bitwise; raw {raw_ms:.4f} ms; the chain is "
            f"{length + m_ - 1} diagonals: {raw_ms * 1e6 / (length + m_ - 1):.1f} ns a diagonal")
        if length == DOMAIN_DTW[0][0]:
            # the state in scratch (as past 12,288 window positions), forced
            # here by a shared-memory budget of 0: bitwise the run above
            saved = kd.WIDE_SMEM_WORDS
            kd.WIDE_SMEM_WORDS = 0
            try:
                check(kd.wide_schedule(length, m_, band)["scratch_words"] > 0,
                      "the forced scratch route takes no scratch")
                again, _ = launched(lambda: kd.banded_dtw_scores(*args), {kd.NAME: 1},
                                    f"banded_dtw fused ({tag}, state in scratch)")
                scratch_ms = time_ms(torch, lambda: kd.banded_dtw_scores(*args), reps=5, warm=1)
            finally:
                kd.WIDE_SMEM_WORDS = saved
            check(bool(torch.equal(again, got)), f"banded_dtw ({tag}): the state in scratch "
                                                 f"gives other scores")
            say(f"banded_dtw ({tag}) with its state in scratch (global memory): bitwise; "
                f"{scratch_ms:.4f} ms")
        del cost, args, ctab, raw, got, want
        torch.cuda.empty_cache()

    # ---- kernels 3, 4, 10, 11 at D % 8 != 0 and at a base 2 bytes off --
    def offset(t):
        """t's values in a contiguous view whose base is one element past
        a 16-byte aligned one (2 bytes for bf16, 1 for bool)."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
        v = buf[1 : 1 + t.numel()].view(t.shape)
        v.copy_(t)
        check(v.data_ptr() % 16 == t.element_size(), "the offset view is aligned")
        return v

    b_, t_, k_, l_ = 2, 600, 130, 32
    nfft = fs.pick_nfft(l_, k_)
    hop, bins = nfft - l_ + 1, nfft // 2 + 1
    nblk = -(-(t_ - l_ + 1) // hop)
    g = fs._dft_basis(nfft, torch.bfloat16, dev)
    for d_ in DOMAIN_D + ("base",):
        dd = 512 if d_ == "base" else d_
        x = (torch.rand(b_, t_, dd, device=dev, generator=gen) < 0.3).to(torch.bfloat16)
        w = torch.randn(k_, l_, dd, device=dev, generator=gen).to(torch.bfloat16)
        c = torch.randn(k_, device=dev, generator=gen)
        fmap = x.bool()
        if d_ == "base":
            x, w = offset(x), offset(w)
            fmap = offset(fmap)
        tag = f"D {dd}, base 2 bytes off" if d_ == "base" else f"D {dd}"
        # kernel 10
        got, _ = launched(lambda: kc.correlation_scores(x, w, c), {kc.NAME: 1},
                          f"correlation ({tag})")
        err10 = close(got, kc.correlation_scores_plain(x, w, c), 1e-5, f"correlation ({tag})")
        # kernel 11: windows of 40 frames, into the next utterance and past
        # the map's end
        rs = torch.from_numpy(rng.integers(0, b_ * t_, 200).astype(np.int32)).to(dev)
        rs[:3] = torch.tensor([t_ - 5, b_ * t_ - 3, 0], dtype=torch.int32)
        ids = torch.from_numpy(rng.integers(0, k_, 200).astype(np.int32)).to(dev)
        got11, _ = launched(lambda: kp.pair_llr(fmap, w, rs, ids, 40), {kp.NAME: 1},
                            f"pair_llr ({tag})")
        err11 = close(got11, kp.pair_llr_plain(fmap, w, rs, ids, 40), 1e-5, f"pair_llr ({tag})")
        # kernel 3, then kernel 4 on its spectra with a W2 of the same D
        (xr, xi), _ = launched(lambda: k3.fft_block_dft(x, g, nfft, hop, nblk), {k3.NAME: 1},
                               f"fft_block_dft ({tag})")
        ref3 = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
        err3 = max(close(a, r, 2.0 ** -7, f"fft_block_dft ({tag})") for a, r in zip((xr, xi), ref3))
        w2 = torch.randn(bins, 2 * dd, 136, device=dev, generator=gen).to(torch.bfloat16)
        if d_ == "base":
            xr, xi, w2 = offset(xr.contiguous()), xi, offset(w2)
        y, _ = launched(lambda: k4.fft_binmm(xr, xi, w2), {k4.NAME: 1}, f"fft_binmm ({tag})")
        err4 = close(y, k4.fft_binmm_plain(xr, xi, w2), 2.0 ** -7, f"fft_binmm ({tag})")
        say(f"{tag}: correlation {err10:.3g}, pair_llr {err11:.3g}, fft_block_dft "
            f"{err3:.3g}, fft_binmm {err4:.3g} max abs error, each one launch of its kernel "
            f"on rows padded to D8")
        if d_ == DOMAIN_D[0]:
            # the timed rows at D 500, the padding copy inside each
            m_ = b_ * nblk
            tv = t_ - l_ + 1
            wt = w.transpose(1, 2).contiguous()
            xt = x.transpose(1, 2).contiguous()
            record(kc, err10, "1e-5 * max|plain|",
                   time_ms(torch, lambda: kc.correlation_scores(x, w, c), loop=10),
                   time_ms(torch, lambda: kc.correlation_scores_plain(x, w, c)),
                   time_ms(torch, lambda: torch.nn.functional.conv1d(xt, wt), loop=10),
                   x.numel() * 2 + w.numel() * 2 + k_ * 4 + b_ * k_ * tv * 4,
                   2 * b_ * k_ * tv * l_ * dd, BF16_FLOPS,
                   shape=f"D {dd}: B {b_}, T {t_}, K {k_}, L {l_}, padded to D8")
            rows[-1]["launches"] = 1
            seg = fmap.reshape(-1, dd)[rs.long().clamp(max=b_ * t_ - 41)[:, None]
                                       + torch.arange(40, device=dev)].to(torch.bfloat16)
            wk = w[ids.long()]
            record(kp, err11, "1e-5 * max|ref|",
                   time_ms(torch, lambda: kp.pair_llr(fmap, w, rs, ids, 40), loop=10),
                   time_ms(torch, lambda: kp.pair_llr_plain(fmap, w, rs, ids, 40)),
                   time_ms(torch, lambda: torch.bmm(wk, seg.transpose(1, 2)), loop=10),
                   fmap.numel() + w.numel() * 2 + 200 * 8 + got11.numel() * 4,
                   2 * 200 * l_ * 40 * dd, BF16_FLOPS,
                   shape=f"D {dd}: 200 pairs, L {l_}, m 40, padded to D8")
            rows[-1]["launches"] = 1
            record(k3, err3, "2^-7 * max|ref|",
                   time_ms(torch, lambda: k3.fft_block_dft(x, g, nfft, hop, nblk), loop=10),
                   time_ms(torch, lambda: k3.fft_block_dft_plain(x, g, nfft, hop, nblk)), None,
                   x.numel() * 2 + g.numel() * 2 + 2 * bins * m_ * dd * 2,
                   2 * (2 * bins) * nfft * m_ * dd, BF16_FLOPS,
                   shape=f"D {dd}: B {b_}, T {t_}, nfft {nfft}, padded to D8")
            rows[-1]["launches"] = 1
            x2 = torch.cat([torch.cat([xr, xi], -1), torch.cat([xi, -xr], -1)], 1).reshape(
                bins, 2 * m_, 2 * dd)
            record(k4, err4, "2^-7 * max|ref|",
                   time_ms(torch, lambda: k4.fft_binmm(xr, xi, w2), loop=10),
                   time_ms(torch, lambda: k4.fft_binmm_plain(xr, xi, w2)),
                   time_ms(torch, lambda: torch.bmm(x2, w2), loop=10),
                   2 * bins * m_ * dd * 2 + w2.numel() * 2 + 2 * (2 * bins * m_ * 136 * 2),
                   2 * (2 * m_) * (2 * dd) * 136 * bins, BF16_FLOPS,
                   shape=f"D {dd}: bins {bins}, m {m_}, K 136, operands padded to D8")
            rows[-1]["launches"] = 1
            pad_ms = time_ms(torch, lambda: _cuda.aligned_rows(x), loop=10)
            x504 = torch.zeros((b_, t_, 504), dtype=torch.bfloat16, device=dev)
            check(_cuda.aligned_rows(x504) is x504, "D 504: the wrapper's rows were copied")
            say(f"the padding copy at D {dd} (a map [{b_}, {t_}, {dd}] bf16 to D8): "
                f"{pad_ms:.4f} ms; at D 504 from an aligned base no copy")
        del x, w, fmap, xr, xi, y, got, got11
    # the whole FFT scorer with a D 36 bank (its spectra padded to D8
    # rows a half at build) against its plain run, 4e-3 of max|score|
    d36 = DOMAIN_D[1]
    wb = torch.randn(k_, l_, d36, device=dev, generator=gen)
    cb = torch.randn(k_, device=dev, generator=gen)
    bank = fs.build_fft_bank(wb, cb, mm_dtype=torch.bfloat16)
    check(bank.dp == 40 and bank.w2.shape[1] == 80, f"D 36 bank: dp {bank.dp}")
    xs = (torch.rand(b_, t_, d36, device=dev, generator=gen) < 0.3)
    got, counts = launched(lambda: fs.fft_sliding_scores(xs, bank),
                           {k3.NAME: 1, k4.NAME: 1, "fft_idft": 1}, "fft_sliding_scores (D 36)")
    close(got, fs.fft_sliding_scores(xs, bank, plain=True), 4e-3, "fft_sliding_scores (D 36)")
    say(f"fft_sliding_scores with a D 36 bank: within 4e-3 x max|score| of its plain run; "
        f"launches {counts}")
    # and on int8 spectra: kernel 6 behind kernel 3's padded D, within the
    # int8 class (1e-2 x max|score|)
    bank8 = fs.build_fft_bank(wb, cb, mm_dtype=torch.int8)
    check(tuple(bank8.w2_kmajor.shape[-1:]) == (48,), f"D 36 int8 bank: {bank8.w2_kmajor.shape}")
    got, counts = launched(lambda: fs.fft_sliding_scores(xs, bank8),
                           {k3.NAME: 1, k4.INT8_NAME: 1, "fft_idft": 1},
                           "fft_sliding_scores (D 36, int8)")
    close(got, fs.fft_sliding_scores(xs, bank8, plain=True), 1e-2,
          "fft_sliding_scores (D 36, int8)")
    say(f"fft_sliding_scores with a D 36 int8 bank: within 1e-2 x max|score| of its plain run; "
        f"launches {counts}")
    del bank, bank8, got, xs
    torch.cuda.empty_cache()

    # ---- kernel 10 past int32 extents ----------------------------------
    t_r, l_r = DOMAIN_ROWS
    tv_r = t_r - l_r + 1
    b_r = DOMAIN_ROW_LIMIT // tv_r + 1        # rows b*T'' + t pass 2^31 at b = 2^31 / T''
    feats = torch.empty((b_r, t_r, 8), dtype=torch.bfloat16, device=dev)
    feats.bernoulli_(0.3, generator=gen)
    w = torch.randn(1, l_r, 8, device=dev, generator=gen).to(torch.bfloat16)
    c = torch.randn(1, device=dev, generator=gen)
    tag = f"B*T'' {b_r * tv_r} (past 2^31): B {b_r}, T {t_r}, D 8, K 1, L {l_r}"
    out, ms_r = time_once(torch, lambda: launched(lambda: kc.correlation_scores(feats, w, c),
                                                  {kc.NAME: 1}, f"correlation ({tag})")[0])
    run = max(1, b_r // 16)

    def plain_runs():
        """The plain version over runs of utterances (a float32 copy of the
        whole map would not fit), each held to the kernel's scores."""
        errs, tops = [], []
        for b0 in range(0, b_r, run):
            want = kc.correlation_scores_plain(feats[b0 : b0 + run], w, c)
            errs.append((out[b0 : b0 + run] - want).abs().amax(dim=(1, 2)))
            tops.append(want.abs().max())
        return torch.cat(errs), max(float(t) for t in tops)

    (errs, top), plain_ms = time_once(torch, plain_runs)
    edge = DOMAIN_ROW_LIMIT // tv_r
    err = float(errs.max())
    check(err <= 1e-5 * top, f"correlation ({tag}): {err} > 1e-5 * {top}")
    record(kc, err, "1e-5 * max|plain|", ms_r, plain_ms, None,
           feats.numel() * 2 + w.numel() * 2 + 4 + out.numel() * 4,
           2 * b_r * tv_r * l_r * 8, BF16_FLOPS, shape=tag)
    rows[-1]["launches"] = 1
    say(f"correlation ({tag}): {feats.numel() * 2 / 1e9:.1f} GB of map, one launch "
        f"{ms_r:.1f} ms; every utterance within 1e-5 x max|plain| of the plain version (run "
        f"over {run} utterances at a time, with the comparison: {plain_ms:.1f} ms); utterances "
        f"{edge - 1} and {edge}, whose rows lie either side of 2^31: max abs error "
        f"{float(errs[edge - 1]):.3g} and {float(errs[edge]):.3g}")
    del feats, out
    torch.cuda.empty_cache()
    l_d, d_d = DOMAIN_LD
    t_d = l_d + 191                            # T'' 192: one tile of starts
    x = (torch.rand(1, t_d, d_d, device=dev, generator=gen) < 0.3).to(torch.bfloat16)
    w = (torch.randn(1, l_d, d_d, device=dev, generator=gen) * 0.01).to(torch.bfloat16)
    tag = f"L*D {l_d * d_d} (past 2^31): B 1, T {t_d}, D {d_d}, K 1, L {l_d}"
    out, ms_d = time_once(torch, lambda: launched(lambda: kc.correlation_scores(x, w, c),
                                                  {kc.NAME: 1}, f"correlation ({tag})")[0])
    want, plain_ms = time_once(torch, lambda: kc.correlation_scores_plain(x, w, c))
    # 2^31 products a score: held to the reference's bf16 class, 4e-3 x
    # max|score|; both beside a float64 evaluation (one shift at a time)
    err = close(out, want, 4e-3, f"correlation ({tag})")
    ref64 = torch.zeros(192, dtype=torch.float64, device=dev)
    for tau in range(l_d):
        ref64 += x[0, tau : tau + 192].double() @ w[0, tau].double()
    ref64 += float(c[0])
    top64 = float(ref64.abs().max())
    e_k = float((out[0, 0].double() - ref64).abs().max()) / top64
    e_p = float((want[0, 0].double() - ref64).abs().max()) / top64
    record(kc, err, "4e-3 * max|plain| (2^31 products a score)", ms_d, plain_ms, None,
           x.numel() * 2 + w.numel() * 2 + 4 + out.numel() * 4,
           2 * 192 * l_d * d_d, BF16_FLOPS, shape=tag)
    rows[-1]["launches"] = 1
    say(f"correlation ({tag}): one launch {ms_d:.1f} ms (one block: {l_d} x {d_d // 64} "
        f"steps, the split sums), plain {plain_ms:.1f} ms; kernel to plain {err / top64:.3g}, "
        f"kernel to float64 {e_k:.3g}, plain to float64 {e_p:.3g} of max|score| {top64:.6g}")
    del x, w, out, want, ref64
    torch.cuda.empty_cache()
    say(f"domain phase: {time.perf_counter() - t_phase:.1f} s")


# ---- verify_tpu.py, soak.py and soak_bank10k.py on the card ---------------

PARITY_KEYS = {"backend", "device", "compiled", "all_ok", "kernels"}   # PARITY_TPU.json's
N_PARITY_CHECKS = 15


def verify_phase(say, card) -> None:
    """``verify_cuda.py`` in this process: its 15 checks against the NumPy
    oracle, each traced (its kernels launched and among the device
    operations); its ``PARITY_CUDA.json`` (written to a temporary
    directory) has ``PARITY_TPU.json``'s keys, this card, every check
    passed."""
    import contextlib
    import io
    import tempfile

    import verify_cuda

    t_phase = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc = verify_cuda.main(["--out", tmp])
        with open(os.path.join(tmp, verify_cuda.OUT_NAME)) as f:
            parity = json.load(f)
    for line in buf.getvalue().strip().splitlines():
        say(f"verify_cuda: {line}")
    check(set(parity) == PARITY_KEYS, f"verify_cuda: keys {sorted(parity)}")
    check((parity["backend"], parity["device"], parity["compiled"]) == ("cuda", card, True),
          f"verify_cuda: {parity['backend']}, {parity['device']!r}, compiled "
          f"{parity['compiled']}")
    failed = [r["kernel"] for r in parity["kernels"] if not r["ok"]]
    check(rc == 0 and parity["all_ok"] and not failed
          and len(parity["kernels"]) == N_PARITY_CHECKS,
          f"verify_cuda: exit {rc}, {len(parity['kernels'])} checks, failed {failed}")
    say(f"verify phase: {len(parity['kernels'])} checks against the oracle pass, each "
        f"kernel launched and traced; {time.perf_counter() - t_phase:.1f} s")


SOAK_BATCH = 32                    # soak.py's SOAK_BATCH
SOAK_CONFIGS = (("default", False, False), ("DTW + int8", True, True))   # (label, DTW, int8)
BANK10K_K = 10_000                 # soak_bank10k.py's SOAK_BANK_K
BANK10K_BATCH = 8                  # and its SOAK_BATCH


def bank10k_rows(torch, M, seen, tag, hop):
    """Kernels 4 and 5 (``seen``'s first bf16 calls) or 6 (its first int8
    call) at K 10,000, on the stream scan's own operands: held to their
    plain versions in the tolerances of the shapes phase, a ``shape`` row
    each; the rows' shapes by kernel name."""
    shapes = {}
    if "fft_binmm" in seen:
        (xr, xi, w2), _kw = seen.pop("fft_binmm")
        bins_, d_ = xr.shape[0], xr.shape[-1]
        shapes["fft_binmm"] = (f"{tag}: bins {bins_}, m {xr.numel() // (bins_ * d_)}, D {d_}, "
                               f"K {w2.shape[-1]}")
        binmm_row(torch, M.k4, M.record, xr, xi, w2, shapes["fft_binmm"],
                  dict(reps=3, warm=1))
        del xr, xi
    if "fft_idft" in seen:
        (y2, imat, c, nblk_), _kw = seen.pop("fft_idft")
        m_ = y2.shape[1] // c.numel()
        shapes["fft_idft"] = (f"{tag}: 2 bins {y2.shape[0] // 2} (hi, lo), hop "
                              f"{hop}, m {m_}, K {c.numel()}")
        idft_row(torch, M.k5, M.record, y2, imat, c, nblk_, shapes["fft_idft"], loop=10,
                 plain_kw=dict(reps=3, warm=1))
        del y2
    if "fft_binmm_int8" in seen:
        (xq_r, xq_i, w2, sc8), kw = seen.pop("fft_binmm_int8")
        bins_, d_ = xq_r.shape[0], xq_r.shape[-1]
        m_ = xq_r.numel() // (bins_ * d_)
        shapes["fft_binmm_int8"] = f"{tag}: bins {bins_}, m {m_}, D {d_}, K {w2.shape[-1]}"
        M.record_int8(M.k4, SimpleNamespace(w2=w2, w2_kmajor=kw["w2_kmajor"], k=w2.shape[-1]),
                      xq_r, xq_i, sc8, m_, shapes["fft_binmm_int8"])
    seen.clear()
    torch.cuda.empty_cache()
    return shapes


def soak_phase(torch, say, dev, C, M, rows, corpus=None, bank=None) -> None:
    """``soak_cuda.py`` and ``soak_bank10k_cuda.py`` on the card, at mesh
    (1, 1, 1) in a world of one: the fault -> resume -> clean runs of
    ``detect_corpus_sharded`` over the soak corpus (``SOAK_UTTS`` a group:
    300 utterances) at ``SOAK_BATCH`` for the default config and DTW +
    int8 (resumed bitwise the clean scan, the fault after half the
    batches, the clean scan's kernels launched), then the K 10,000 bank
    (``inflate_bank`` of ``bank``) on bf16 and int8 spectra at
    ``BANK10K_BATCH``, each held against its plain run and the stream
    (``bank10k_soak``), with rows for kernels 4, 5 and 6 on the stream's
    first batch and their launches from the sharded scan.  ``corpus`` and
    ``bank``: the training phase's (its K 4 x 2 bank); without them the
    corpus is built and a bank trained as ``soak.py`` does."""
    import contextlib

    import soak_bank10k_cuda
    import soak_cuda

    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.pipeline import train_bank
    from template_speech_recognition_tpu_torch.scan import stream_scan

    t_phase = time.perf_counter()
    if corpus is None:
        corpus = soak_corpus(SOAK_UTTS)
    if bank is None:
        t0 = time.perf_counter()
        bank = train_bank(corpus, list(TRAIN_PHONES), soak_cuda.scan_config(SOAK_BATCH),
                          device=dev)
        say(f"soak: train_bank on the soak corpus {time.perf_counter() - t0:.1f} s -> K "
            f"{bank.num_templates}, L {bank.template_length}")
    n_batches = soak_cuda.count_batches(corpus, SOAK_BATCH)
    with soak_cuda.mesh_of_one(dev) as mesh:
        for label, dtw, int8 in SOAK_CONFIGS:
            cfg = soak_cuda.scan_config(SOAK_BATCH, dtw, int8)
            try:
                rec = soak_cuda.soak_record(corpus, bank, cfg, mesh, dev, None)
            except soak_cuda.SoakFailed as exc:
                check(False, f"soak {label}: {exc}")
            fr, rr, cr = rec["fault_run"], rec["resume_run"], rec["clean_run"]
            counts = cr["launches"]
            for name in SHARD_KERNELS[label]:
                check(counts.get(name, 0) > 0, f"soak {label}: the clean scan did not launch "
                                               f"{name}")
            check(fr["batches"] == n_batches and fr["killed_after_batches"] == n_batches // 2,
                  f"soak {label}: fault after {fr['killed_after_batches']} of {fr['batches']}")
            say(f"soak {label} (detect_corpus_sharded, mesh (1, 1, 1), batch {SOAK_BATCH}, K "
                f"{rec['bank']['k']}, L {rec['bank']['template_length']}): "
                f"{rec['corpus']['utterances']} utterances, "
                f"{rec['corpus']['audio_seconds']:.1f} audio-s, {fr['batches']} batches; fault "
                f"after {fr['killed_after_batches']} batches ({fr['wall_s']:.3f} s, "
                f"{fr['shards_recorded']} shards recorded); resume computed "
                f"{rr['batches_computed']} and loaded {rr['shards_loaded']} shards in "
                f"{rr['wall_s']:.3f} s; bitwise the clean scan: {cr['detections']} detections, "
                f"{cr['wall_s']:.3f} s wall, {cr['audio_s_per_s']:.1f} audio-s/s (scan loop), "
                f"EER {cr['eer']:.4f}, best TPR {cr['best_tpr']:.4f}; launches {counts}")

        # config 5 at spec scale: K 10,000
        t0 = time.perf_counter()
        big = soak_bank10k_cuda.inflate_bank(bank, BANK10K_K)
        say(f"soak: the K {BANK10K_K} bank (inflate_bank of K {bank.num_templates}, L "
            f"{big.template_length}) in {time.perf_counter() - t0:.1f} s")
        flips, n_diff, n_all = map_flips(torch, fp, stream_scan, corpus, C.FrontendConfig(),
                                         BANK10K_BATCH, dev)
        say(f"soak corpus at batch {BANK10K_BATCH}: {n_diff} of {n_all} map cells differ "
            f"from the plain run's, in {sum(len(v) for v in flips.values())} frames")
        seen, shapes = {}, {}
        tag = f"K {BANK10K_K}, L {big.template_length}: the soak stream's first batch"
        hop = M.fs.pick_nfft(big.template_length, BANK10K_K) - big.template_length + 1

        @contextlib.contextmanager
        def around_stream():
            real = {n: getattr(M.fs, n) for n in ("fft_binmm", "fft_idft", "fft_binmm_int8")}

            def keep_first(name, fn):
                def run(*a, **kw):
                    if name not in shapes:          # the first scan's, once a kernel
                        seen.setdefault(name, (a, kw))
                    return fn(*a, **kw)
                return run

            for n, fn in real.items():
                setattr(M.fs, n, keep_first(n, fn))
            try:
                yield
            finally:
                for n, fn in real.items():
                    setattr(M.fs, n, fn)
            shapes.update(bank10k_rows(torch, M, seen, tag, hop))

        recs = soak_bank10k_cuda.bank10k_soak(corpus, big, BANK10K_BATCH, mesh, dev, say,
                                              flips, around_stream)
    for label, names in (("bf16", ("fft_binmm", "fft_idft")), ("int8", ("fft_binmm_int8",))):
        for name in names:
            take_launches(rows, (name,), recs[label]["launches"], shape=shapes[name])
        rec = recs[label]
        check(rec["peak_bytes"] is not None, "soak: the peak memory was not measured")
        say(f"soak K {BANK10K_K} {label}: {rec['audio_s_per_s']:.1f} audio-s/s, "
            f"{rec['detections']} detections, peak torch.cuda.max_memory_allocated "
            f"{(rec['peak_bytes'] or 0) / 1e9:.3f} GB ({(rec['base_bytes'] or 0) / 1e9:.3f} GB "
            f"before the scan), {rec['batches']} batches, launches {rec['launches']}")
    del big, recs
    torch.cuda.empty_cache()
    say(f"soak phase: {time.perf_counter() - t_phase:.1f} s")


SCALING_TIMEOUT = 300      # seconds a bench_scaling_cuda.py process may take
MULTICHIP_RANKS = (4, 8)   # the dry run's worlds: meshes (2, 2, 1) and (2, 2, 2)
MULTICHIP_TIMEOUT = 420    # seconds a dry run's ranks may take in all


def scaling_rows(torch, M, rows, launches) -> None:
    """Kernels 3, 4 and 5 at ``bench_scaling.py``'s FFT shape (B 8, T
    2048, D 512, K 1024: the K-shard of a world of one), on its own
    inputs as the world of one's shard gets them (the zero-padded halo
    tail), each against its plain version, a ``shape`` row each with the
    launches of the scaling run's 5 steps."""
    import bench_scaling_cuda as S

    kn = S.knobs()
    b, t, k = kn["b"], kn["t"], kn["k"]
    feats, w, c = S.make_inputs(b, t, k, kn["length"], torch.device("cuda"))
    fbank = M.fs.build_fft_bank(w, c, mm_dtype=torch.bfloat16)     # the card's default
    nfft, length = fbank.nfft, fbank.length
    hop, bins = nfft - length + 1, nfft // 2 + 1
    x = feats.reshape(b, t, -1)
    ext = torch.cat([x, x.new_zeros((b, length - 1, x.shape[2]))], 1)
    nblk = -(-t // hop)
    tag = f"scaling bench: B {b}, T {t}, D {x.shape[2]}, K {k}"
    shapes = {"fft_block_dft": f"{tag}, nfft {nfft}",
              "fft_binmm": f"{tag}: bins {bins}, m {b * nblk}",
              "fft_idft": f"{tag}: 2 bins {bins} (hi, lo), hop {hop}, m {b * nblk}"}
    xr, xi = M.record_dft(M.k3, ext, M.fs._dft_basis(nfft, torch.bfloat16, ext.device), nfft,
                          hop, nblk, shapes["fft_block_dft"])
    y = binmm_row(torch, M.k4, M.record, xr, xi, fbank.w2, shapes["fft_binmm"])
    idft_row(torch, M.k5, M.record, y.reshape(-1, b * nblk * k),
             M.fs._idft_basis(nfft, hop, torch.bfloat16, ext.device, 2), fbank.c, nblk,
             shapes["fft_idft"])
    for name, shape in shapes.items():
        take_launches(rows, (name,), launches, shape=shape)
    del feats, w, fbank, ext, xr, xi, y
    torch.cuda.empty_cache()


def multichip_phase(torch, say, dev, card, M, rows) -> None:
    """The multi-device entry points on this one card: (a)
    ``bench_scaling_cuda.py`` (a process, NCCL in a world of
    one, axis bank) for both backends: the reference's keys and
    ``device``, the card's line, the gathered scores within their class
    of the unsharded twin, the FFT kernels launched; kernels 3, 4 and 5
    at its shape (``scaling_rows``); (b) ``multichip_cuda.py N
    --gloo-on-one-card`` at N 4 and 8: every path of the dry run held
    against its twin on every rank, each rank's FFT path with kernels 3,
    4 and 5 and its scan with kernels 1, 2, 11 and 12 launched; (c)
    ``soak_bank10k_cuda``'s fake mesh: K 10,000 on a (2, 2, 2) mesh of 8
    gloo ranks on this card against the single-device stream, each
    rank's peak memory printed; kernels 4 and 5 at a bank rank's K-shard
    (5,000) on the stream's spectra cut to rank 0's first batch.  (b)
    and (c) are one card time-sliced: their times are no multi-GPU
    number."""
    import contextlib
    import tempfile

    import multichip_cuda
    import soak_bank10k_cuda

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks below share this card's memory
    root = os.path.dirname(os.path.abspath(__file__))
    # (a) the scaling report, a process a backend
    fft_launches = None
    for backend in ("conv", "fft"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "bench_scaling_cuda.py"], cwd=root,
            env={**os.environ, "SCALE_BACKEND": backend, "SCALE_AXIS": "bank"},
            capture_output=True, text=True, timeout=SCALING_TIMEOUT)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"scaling {backend}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        lines = [json.loads(text) for text in proc.stdout.strip().splitlines()]
        meshes, summary = lines[:-1], lines[-1]
        check(len(meshes) == torch.cuda.device_count() == 1 and meshes[0]["mesh_devices"] == 1,
              f"scaling {backend}: {lines}")
        line = meshes[0]
        for key in ("mesh_devices", "axis", "backend", "audio_s_per_s", "step_ms", "device",
                    "max_abs_err"):
            check(key in line, f"scaling {backend}: no {key!r} in {line}")
        for key in ("metric", "backend", "devices", "audio_s_per_s", "efficiency", "platform",
                    "device"):
            check(key in summary, f"scaling {backend}: no {key!r} in {summary}")
        check(line["device"] == summary["device"] == card and summary["platform"] == "gpu",
              f"scaling {backend}: device {line['device']!r}, not {card!r}")
        check(summary["efficiency"] == [1.0] and line["audio_s_per_s"] > 0,
              f"scaling {backend}: {summary}")
        if backend == "fft":
            fft_launches = line["launches"]
            for name in ("fft_block_dft", "fft_binmm", "fft_idft"):
                check(fft_launches.get(name, 0) == 5,
                      f"scaling fft: {name} launched {fft_launches.get(name, 0)}x in 5 steps")
        say(f"scaling (a) {backend}, NCCL world of one, axis bank ({wall:.1f} s with the "
            f"process): {line['audio_s_per_s']} audio-s/s, step {line['step_ms']} ms, gathered "
            f"scores {line['max_abs_err']:.6g} off the unsharded twin ({line['tolerance']}); "
            f"launches {line['launches']}; summary {json.dumps(summary)}")
    scaling_rows(torch, M, rows, fft_launches)

    # (b) the dry run at 4 and 8 gloo ranks on this card
    for n in MULTICHIP_RANKS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            codes, logs, recs = multichip_cuda.launch(n, None, True, tmp, MULTICHIP_TIMEOUT)
        wall = time.perf_counter() - t0
        bad = multichip_cuda.launch_failures(codes, recs, cuda=True)
        for rank, (code, (_out, err)) in enumerate(zip(codes, logs)):
            if code != 0:
                say(f"dry run {n} rank {rank}: exit {code}: {err[-2000:]}")
        check(not bad, f"dry run at {n} ranks: {bad}")
        r0 = recs[0]
        say(f"dry run (b) {n} gloo ranks on this card, mesh {tuple(r0['mesh'])} ({wall:.1f} s "
            f"with the ranks' start; time-sliced, no multi-GPU number): {r0['summary']}")
        for name, path in r0["paths"].items():
            say(f"dry run {n} rank 0 {name}: {path['hold']}; {path['ms']:.2f} ms; launches by "
                f"rank: " + "; ".join(shard_counts_line(
                    rec["paths"][name]["launches"],
                    multichip_cuda.PATH_KERNELS.get(name, ())) or "-" for rec in recs))
        say(f"dry run {n}: peak torch.cuda.max_memory_allocated by rank " + ", ".join(
            f"{rec.get('peak_bytes', 0) / 1e9:.3f}" for rec in recs) + " GB")

    # (c) the fake mesh at K 10,000
    seen = {"fft_binmm": [], "fft_idft": []}

    @contextlib.contextmanager
    def around_stream():
        real = {n: getattr(M.fs, n) for n in ("fft_binmm", "fft_idft")}

        def keep_first(name, fn):
            def run(*a, **kw):
                seen[name].append(a[:2] if name == "fft_binmm" else a[1:3])
                if name == "fft_binmm":
                    seen.setdefault("w2", a[2])      # the bank's spectra, every call's
                return fn(*a, **kw)
            return run

        for n, fn in real.items():
            setattr(M.fs, n, keep_first(n, fn))
        try:
            yield
        finally:
            for n, fn in real.items():
                setattr(M.fs, n, fn)
            # only bank rank 0's columns are kept while the ranks run
            w2 = seen.pop("w2")
            k_l = -(-w2.shape[-1] // (8 * soak_bank10k_cuda.FAKE_MESH[1])) * 8
            seen["w2"] = w2[..., :k_l].contiguous()
            del w2

    t0 = time.perf_counter()
    run = soak_bank10k_cuda.fake_mesh(dev, say, around_stream=around_stream)
    section = run["section"]
    say(f"fake mesh (c): {json.dumps(section)}; {time.perf_counter() - t0:.1f} s with the "
        f"bank's training and the stream; peak torch.cuda.max_memory_allocated by rank "
        + ", ".join(f"{(rec['peak_bytes'] or 0) / 1e9:.3f}" for rec in run["ranks"]) + " GB")
    # kernels 4 and 5 at rank 0's K-shard and first batch's m = B_l x
    # nblk_l blocks, on the first m block spectra of the stream
    bins_, b_l, nblk_l, d_, k_l = run["ranks"][0]["binmm_shape"]["fft_binmm"]
    m_l = b_l * nblk_l
    xs = [torch.cat([x.reshape(bins_, -1, d_) for x in xx], 1)
          for xx in zip(*seen["fft_binmm"])]
    check(xs[0].shape[1] >= m_l and seen["w2"].shape[-1] >= k_l,
          f"fake mesh: the stream's {xs[0].shape[1]} blocks and K {seen['w2'].shape[-1]} do "
          f"not hold rank 0's {[bins_, b_l, nblk_l, d_, k_l]}")
    xr_l, xi_l = (x[:, :m_l].contiguous() for x in xs)
    imat, c = seen["fft_idft"][0]
    w2_l, c_l = seen["w2"][..., :k_l].contiguous(), c[:k_l].contiguous()
    del xs, c
    seen.clear()
    hop = imat.shape[1]
    tag = f"K {section['bank_k']} on bank 2, K_l {k_l}: a rank's first batch"
    shapes = {"fft_binmm": f"{tag}: bins {bins_}, m {m_l}, D {d_}, K {k_l}",
              "fft_idft": f"{tag}: 2 bins {bins_} (hi, lo), hop {hop}, m {m_l}, K {k_l}"}
    y = binmm_row(torch, M.k4, M.record, xr_l, xi_l, w2_l, shapes["fft_binmm"],
                  dict(reps=3, warm=1))
    idft_row(torch, M.k5, M.record, y.reshape(-1, m_l * k_l), imat, c_l, nblk_l,
             shapes["fft_idft"], loop=10, plain_kw=dict(reps=3, warm=1))
    for name, shape in shapes.items():
        take_launches(rows, (name,), run["ranks"][0]["launches"], shape=shape)
    del xr_l, xi_l, w2_l, y, run
    torch.cuda.empty_cache()
    say(f"multichip phase: {time.perf_counter() - t_phase:.1f} s")


# the keys of bench.py's JSON line, its tpu_* keys named for the card
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "bank_k", "template_len",
              "batch_utts", "frames_per_utt", "h100_step_ms", "h100_effective_tflops",
              "cpu_oracle_audio_s_per_s", "backend", "timing", "e2e_audio_s_per_s",
              "e2e_frac_of_kernel", "frontend_audio_s_per_s")
# the kernels each bench backend's scorer must launch (conv: the library's)
BENCH_SCORER_KERNELS = {"fft": ("fft_block_dft", "fft_binmm", "fft_idft"), "conv": (),
                        "pallas": ("correlation",)}
BENCH_TIMEOUT = 300        # seconds a bench process may take


def bench_phase(say, card) -> None:
    """The port CLI's ``bench`` (``bench_cuda.py``) on the card at
    ``bench.py``'s shape (B 8, T 3000, K 1024, L 32), a process for each
    backend: its last line parses as JSON with every key of ``bench.py``
    (``h100_*`` for ``tpu_*``), ``value`` > 0, this card's ``nvidia-smi``
    line, and each kernel of the scorer, the frontend and the scan
    launched in its own measurement."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    for backend in BENCH_SCORER_KERNELS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "template_speech_recognition_tpu_torch", "bench"],
            cwd=root, env={**os.environ, "BENCH_BACKEND": backend}, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"bench {backend}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        out = proc.stdout.strip().splitlines()
        try:
            line = json.loads(out[-1])
        except (IndexError, ValueError):
            line = None
        check(isinstance(line, dict), f"bench {backend}: no JSON line last: {out[-3:]}")
        missing = [k for k in BENCH_KEYS if k not in line]
        check(not missing, f"bench {backend}: keys missing {missing}")
        check(all((line[k] or 0) > 0 for k in ("value", "h100_step_ms", "e2e_audio_s_per_s")),
              f"bench {backend}: {line}")
        check((line["backend"], line["bank_k"], line["template_len"], line["batch_utts"],
               line["frames_per_utt"]) == (backend, K, L, B, T_BENCH),
              f"bench {backend}: not bench.py's shape: {line}")
        check(line["card"] == card, f"bench {backend}: card {line['card']!r}, not {card!r}")
        launches = line["launches"]
        for stage, names in (("scorer", BENCH_SCORER_KERNELS[backend]),
                             ("frontend", ("frontend_planes", "select_binspread")),
                             ("e2e", SCAN_KERNELS)):
            for name in names:
                check(launches[stage].get(name, 0) > 0,
                      f"bench {backend}: {name} not launched in its {stage} run: {launches}")
        check(BENCH_SCORER_KERNELS[backend] or not launches["scorer"],
              f"bench conv launched {launches['scorer']}")
        for text in out[:-1]:
            say(f"bench {backend}: {text}")
        say(f"bench {backend} ({wall:.1f} s): {out[-1]}")
    say(f"bench phase: {time.perf_counter() - t_phase:.1f} s")


def main(only: str | None = None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import template_speech_recognition_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    use_h100_peaks()
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
    from template_speech_recognition_tpu_torch.align import dtw as dtw_mod
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
        stream_scan,
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

    # ---- the CLI's bench, each backend in a process of its own ---------
    if only in (None, "bench"):
        bench_phase(say, card)
    if only == "bench":
        return finish(torch, card, [], say, t_start)

    # ---- verify_tpu.py's checks against the oracle (verify_cuda.py) ----
    if only in (None, "verify"):
        verify_phase(say, card)
    if only == "verify":
        return finish(torch, card, [], say, t_start)

    # ---- inputs at the scan's shapes ------------------------------------
    cfg = C.PipelineConfig()
    fcfg = cfg.frontend
    corpus = Corpus(SEED)
    rng = np.random.default_rng(SEED)
    templates, background = random_bank(fcfg, rng)
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

    def record_int8(k4, fbank8, xq_r, xq_i, sc8, m_, shape):
        """Kernel 6 as the scan launches it (the bank's K-major copy, the
        padded block spectra, the hi and lo planes): bitwise against its
        plain version, two launches bitwise equal; timed over loops of
        100 launches; no PyTorch call computes a batched int8 x int8 ->
        int32 product."""
        bins_, d_, k_ = xq_r.shape[0], xq_r.shape[-1], fbank8.k
        check(tuple(fbank8.w2_kmajor.shape) == (bins_, 2, k_, k4.int8_row_width(d_))
              and xq_r.stride(-2) == k4.int8_row_width(d_),
              f"int8 operands: w2_kmajor {tuple(fbank8.w2_kmajor.shape)}, xr strides "
              f"{xq_r.stride()}")
        run = lambda: k4.fft_binmm_int8(xq_r, xq_i, fbank8.w2, sc8,  # noqa: E731
                                        w2_kmajor=fbank8.w2_kmajor)
        y8 = run()
        y8_ref = k4.fft_binmm_int8_plain(xq_r, xq_i, fbank8.w2, sc8)
        check(bool(torch.equal(y8, y8_ref)), f"fft_binmm_int8 ({shape}): not bitwise")
        check(bool(torch.equal(run(), y8)), f"fft_binmm_int8 ({shape}): two launches differ")
        record(
            SimpleNamespace(NAME=k4.INT8_NAME, SOURCE=k4.INT8_SOURCE, REPLACES=k4.INT8_REPLACES),
            float((y8.float() - y8_ref.float()).abs().max()), "bitwise",
            time_ms(torch, run, loop=100),
            time_ms(torch, lambda: k4.fft_binmm_int8_plain(xq_r, xq_i, fbank8.w2, sc8)),
            None,
            2 * bins_ * m_ * d_ + fbank8.w2.numel() + sc8.numel() * 4
            + 2 * (2 * bins_ * m_ * k_ * 2),
            2 * (2 * m_) * (2 * d_) * k_ * bins_, INT8_OPS, shape=shape,
        )
        share = rows[-1]["bound_ms"] / rows[-1]["ms"]
        say(f"fft_binmm_int8 ({shape}): one launch between the events (with the wrapper's "
            f"host time) {time_ms(torch, run):.4f} ms; kernel {share:.3f} of its bound")

    def record_dft(k3, x, g, nfft_, hop_, nblk_, shape):
        """Kernel 3 on a scan's own map: within one bf16 step (2^-7) of
        max|ref| of its plain version, two launches bitwise equal; timed
        over loops of 100 launches beside one bf16 ``matmul`` of the
        basis and the unfolded windows.  Returns the kernel's xr, xi."""
        run = lambda: k3.fft_block_dft(x, g, nfft_, hop_, nblk_)     # noqa: E731
        got = run()
        ref = k3.fft_block_dft_plain(x, g, nfft_, hop_, nblk_)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        top = max(float(r.float().abs().max()) for r in ref)
        check(err <= 2.0 ** -7 * top, f"fft_block_dft ({shape}): {err} > 2^-7 * {top}")
        check(all(bool(torch.equal(a, c)) for a, c in zip(got, run())),
              f"fft_block_dft ({shape}): two launches differ")
        del ref
        b_, t_, d_ = x.shape
        bins_, m_ = g.shape[1] // 2, b_ * nblk_
        blocks = torch.nn.functional.pad(x, (0, 0, 0, nblk_ * hop_ + nfft_ - hop_ - t_))
        blocks = blocks.unfold(1, nfft_, hop_).permute(3, 0, 1, 2).reshape(nfft_, m_ * d_)
        blocks = blocks.contiguous()
        g_t = g.t().contiguous()
        record(
            k3, err, "2^-7 * max|ref|", time_ms(torch, run, loop=100),
            time_ms(torch, lambda: k3.fft_block_dft_plain(x, g, nfft_, hop_, nblk_)),
            time_ms(torch, lambda: torch.matmul(g_t, blocks), loop=100),
            b_ * t_ * d_ * 2 + g.numel() * 2 + 2 * bins_ * m_ * d_ * 2,
            2 * (2 * bins_) * nfft_ * m_ * d_, BF16_FLOPS, shape=shape,
        )
        del blocks
        share = rows[-1]["bound_ms"] / rows[-1]["ms"]
        plan = k3.plan(b_, d_, nfft_, nblk_, bins_, k3._sm_count(str(x.device)))
        say(f"fft_block_dft ({shape}): one launch between the events (with the wrapper's "
            f"host time) {time_ms(torch, run):.4f} ms; kernel {share:.3f} of its bound; "
            f"two launches bitwise equal; {plan}")
        return got

    if only == "domain":
        domain_phase(torch, say, dev, wavs, nvalid, record, rows)
        return finish(torch, card, rows, say, t_start)
    multichip_mods = SimpleNamespace(fs=fs, k3=k3, k4=k4, k5=k5, record=record,
                                     record_dft=record_dft)
    if only == "multichip":
        multichip_phase(torch, say, dev, card, multichip_mods, rows)
        return finish(torch, card, rows, say, t_start)
    if only == "soak":
        soak_phase(torch, say, dev, C, SimpleNamespace(fs=fs, k4=k4, k5=k5, record=record,
                                                       record_int8=record_int8), rows)
        return finish(torch, card, rows, say, t_start)

    # kernel 1: response planes (tolerances: check_planes)
    planes = k1.edge_response_planes(frames2, fcfg.nfft)
    planes_ref = k1.edge_response_planes_plain(frames2, fcfg.nfft)
    m1 = check_planes(torch, frames2, fcfg.nfft, planes, planes_ref, "frontend_planes")
    err1 = m1["err"]
    say(f"frontend_planes: {float64_text(m1)}; one launch between the events (with the "
        f"wrapper's host time) "
        f"{time_ms(torch, lambda: k1.edge_response_planes(frames2, fcfg.nfft)):.4f} ms")
    cos_m, sin_m = dft_matrices(fl, fcfg.nfft, dev)
    cs = torch.cat([cos_m, sin_m], dim=1).contiguous()
    record(
        k1, err1, "scaled 1e-5 of float64; error bounds",
        time_ms(torch, lambda: k1.edge_response_planes(frames2, fcfg.nfft), loop=100),
        time_ms(torch, lambda: k1.edge_response_planes_plain(frames2, fcfg.nfft)),
        time_ms(torch, lambda: torch.matmul(frames2, cs), loop=100),
        n_rows * fl * 4 + 2 * fl * (f + 1) * 4 + 4 * n_rows * f * 4,
        2 * 2 * n_rows * fl * (f + 1), FP32_FLOPS, tf32=True,
    )

    # kernel 2: select + binarize + spread; bitwise
    planes4 = planes.reshape(4, B, t_pad, f)
    need = fp._dual_ranks(valid, f, fcfg.edge_quantile)
    args2 = (planes4, need, valid, fcfg.spread_freq, fcfg.spread_time)
    variant2 = k2.route(t_pad, f)
    check(variant2 == "cluster", f"select_binspread: the scan's planes take {variant2}")
    flat, keys = k2.select_binspread(*args2)
    flat_ref, keys_ref = k2.select_binspread_plain(*args2)
    torch.cuda.synchronize()
    n_bad = int((flat != flat_ref).sum()) + int((keys != keys_ref).sum())
    check(n_bad == 0, f"select_binspread: {n_bad} cells or keys differ (bitwise)")
    kth = int(need[0, 0])
    pv = planes4.permute(1, 0, 2, 3).reshape(B * 4, t_pad * f)
    say(f"select_binspread: cudaOccupancyMaxActiveClusters {k2.max_active_clusters()} "
        f"(16-CTA clusters, 1,024 threads and 232,448 bytes of shared memory a CTA); "
        f"{4 * B} (plane, utterance) pairs; one launch between the events (with the "
        f"wrapper's host time) {time_ms(torch, lambda: k2.select_binspread(*args2)):.4f} ms")
    record(
        k2, 0.0, "bitwise",
        time_ms(torch, lambda: k2.select_binspread(*args2), loop=100),
        time_ms(torch, lambda: k2.select_binspread_plain(*args2)),
        time_ms(torch, lambda: torch.kthvalue(pv, kth, dim=1)),
        # only rows below valid are read; the whole map is written
        4 * int(valid.sum()) * f * 4 + B * t_pad * 8 * f + need.numel() * 4
        + valid.numel() * 4 + keys.numel() * 8,
        0, 1.0, shape=SELBIN_BENCH,
    )
    # the multipass variant one row past the cluster variant's capacity
    t_big = 16 * max(r for r in range(1, 400) if k2.route(16 * r, f) == "cluster") + 1
    big = torch.randn(4, B, t_big, f, device=dev)
    vbig = torch.full((B,), t_big - 1, dtype=torch.int32, device=dev)
    args_big = (big, fp._dual_ranks(vbig, f, fcfg.edge_quantile), vbig, fcfg.spread_freq,
                fcfg.spread_time)
    check(k2.route(t_big, f) == "multipass", "select_binspread: T_big must take multipass")
    say(f"select_binspread (multipass variant, P 4, B {B}, T {t_big}, F {f}, random "
        f"planes): {time_ms(torch, lambda: k2.select_binspread(*args_big), loop=100):.4f} ms "
        f"over loops of 100 launches (the kernels line's row is the cluster variant)")
    del big, args_big

    # kernel 3: block DFT; bf16 output -> one bf16 step (2^-7) of max|ref|
    # the scorer's cast of the map (detect/fft_scorer.py: u8 -> bf16),
    # which writes the bf16 map kernel 3 reads
    x = flat.reshape(B, t_pad, d).to(torch.bfloat16)
    cast_ms = time_ms(torch, lambda: flat.reshape(B, t_pad, d).to(torch.bfloat16), loop=100)
    cast_bound = (flat.numel() * flat.element_size() + x.numel() * 2) / HBM_BPS * 1e3
    say(f"the map's {flat.dtype} -> bf16 cast at the scan's shape: {cast_ms:.4f} ms over loops "
        f"of 100 (bound {cast_bound:.4f} ms, bytes)")
    cmat, smat = fs._dft_mats(nfft, torch.bfloat16, dev)
    g = torch.cat([cmat, -smat], dim=1).contiguous()
    xr, xi = record_dft(k3, x, g, nfft, hop, nblk, DFT_BENCH)

    # kernel 4: bin matmul; the hi and lo bf16 planes of the scan
    check((bins, m, d, K) == (80, 192, 2048, 1024), f"bin matmul shape {(bins, m, d, K)}")
    ycat = binmm_row(torch, k4, record, xr, xi, fbank.w2, BINMM_BENCH)

    # kernel 5: iDFT epilogue; fp32 output, fp32 summation order only
    y2 = ycat.reshape(-1, m * K)
    imat = fs._idft_basis(nfft, hop, torch.bfloat16, dev, y2.shape[0] // (2 * bins))
    lib5_call = idft_row(torch, k5, record, y2, imat, fbank.c, nblk, None)
    rows[-1]["library_call"] = lib5_call
    single5 = time_ms(torch, lambda: k5.fft_idft(y2, imat, fbank.c, nblk))
    say(f"fft_idft: one launch between the events (with the wrapper's host time) "
        f"{single5:.4f} ms; library call {lib5_call}; kernel "
        f"{rows[-1]['bound_ms'] / rows[-1]['ms']:.3f} "
        f"of its bound ({(y2.numel() * 2 + m * hop * K * 4) / rows[-1]['ms'] / 1e6:.1f} GB/s of "
        f"ycat in and scores out)")

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
    # the scorer enqueues without waiting for the device: behind ~100 ms
    # of queued device time, a call that copied from host memory (its
    # DFT bases, before they were made once) would wait it out
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    fs.fft_sliding_scores(flat.reshape(B, t_pad, d), fbank, time_major=True)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    all_s = time.perf_counter() - t0
    check(host_s < 0.5 * all_s, f"the scorer waited for the device: host {host_s:.4f} s of "
                                f"{all_s:.4f} s")
    say(f"the scorer's host time behind a queued device sleep: {host_s * 1e3:.3f} ms of the "
        f"{all_s * 1e3:.3f} ms until the device finished (no wait on the device)")
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
    record_int8(k4, fbank8, xq_r, xq_i, sc8, m, INT8_BENCH)
    del xq_r, xq_i

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
    check(bool(torch.equal(llr, kp.pair_llr(*args_p))), "pair_llr: two launches differ")
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
    _cuda.reset_launches()
    ops_p = device_op_names(torch, lambda: kp.pair_llr(*args_p))
    say(f"pair_llr: {n_rows_p} distinct map rows, {n_ids_p} distinct templates, "
        f"{bytes_p / 1e6:.1f} MB least bytes; host {host_p:.1f} us a call (the looped "
        f"event time is the device's where it is larger); two launches bitwise equal; one "
        f"call enqueues {ops_p}")
    del seg_g, wk_g, covered

    # the DTW kernel on those tiles as the map route hands them over (the
    # LLR tile, the winner ids as c rows): one launch to the scores,
    # bitwise on finite scores, -inf alike
    lens = torch.clamp(valid.long()[:, None] - times, 1, m_seg).reshape(-1).to(torch.int32)
    c32 = c_rows.to(torch.float32).contiguous()
    args_d = (llr, lens, c32, band, ids)
    sc = kd.banded_dtw_scores(*args_d)
    n_unreach = check_scores(torch, sc, kd.banded_dtw_scores_plain(*args_d), "banded_dtw")
    check(bool(torch.equal(sc, kd.banded_dtw_scores(*args_d))), "banded_dtw: two launches differ")
    cells = band_cells(torch, L, m_llr, lens, band)
    n_ids_d = int(torch.unique(ids).numel())
    ms_d = time_ms(torch, lambda: kd.banded_dtw_scores(*args_d), loop=100)
    record(
        kd, 0.0, "bitwise on finite scores, -inf alike", ms_d,
        time_ms(torch, lambda: kd.banded_dtw_scores_plain(*args_d)),
        None,      # no single PyTorch call computes a banded DTW
        # least bytes: the in-band LLR cells before seg_len, the c rows the
        # ids name, lens, ids and the scores
        cells * 4 + n_ids_d * L * 4 + n_pairs * 12,
        5 * cells, FP32_FLOPS,     # two adds and three minimums per in-band cell
    )

    def old_stage():
        """The stage unfused: the cost prologue, the kernel on the cost
        tile (raw mode, terminals), the score's elementwise ops."""
        cost_ = -(llr + c32[ids.long()][:, :, None])
        return kd.scores_from_terminals(kd.banded_dtw(cost_, lens, band), lens, L)

    check(bool(torch.equal(old_stage(), sc)), "banded_dtw: raw mode + elementwise ops != fused")
    ms_old = time_ms(torch, old_stage, loop=100)
    ops_old = device_op_names(torch, old_stage) or []
    ops_new = device_op_names(torch, lambda: kd.banded_dtw_scores(*args_d)) or []
    cost = -(llr + c32[ids.long()][:, :, None])
    check_terminals(torch, kd.banded_dtw(cost, lens, band), kd.banded_dtw_plain(cost, lens, band),
                    "banded_dtw (raw mode)")
    ms_raw = time_ms(torch, lambda: kd.banded_dtw(cost, lens, band), loop=100)
    host_d = host_us(torch, lambda: kd.banded_dtw_scores(*args_d))
    say(f"banded_dtw: {n_pairs} pairs, {cells} in-band cells, {n_unreach} unreachable; fused "
        f"(LLR tile in, scores out) {ms_d:.4f} ms, raw mode on the cost tile {ms_raw:.4f} ms "
        f"(loops of 100; row 12's target <= 0.006 ms); the unfused stage (prologue, raw "
        f"kernel, score ops) {ms_old:.4f} ms in "
        f"{len(ops_old)} device ops against {len(ops_new)}; host {host_d:.1f} us a call; the "
        f"chain is L + seg_len - 1 = {L + m_seg - 1} dependent diagonals a pair")
    # the map route as the scan calls it: nothing between the two kernels
    w_flat = filters_to_flat(w_rows)
    ids_bp = ids.reshape(B, top_k)

    def map_route():
        return dtw_mod.dtw_pairwise_scores_from_map(fmap, times, ids_bp, w_flat, c_rows, valid,
                                                    m_seg, band)

    check(bool(torch.equal(map_route().reshape(-1), sc)), "map route: scores differ from the "
          "kernels' on the same operands")
    names_r = device_op_names(torch, map_route)
    if names_r is None:
        say("map route: device ops not measured (the trace holds no device event)")
    else:
        i_llr = max(i for i, nm in enumerate(names_r) if "pair_llr" in nm)
        check(names_r[i_llr + 1:] == [nm for nm in names_r[i_llr + 1:] if "banded_dtw" in nm]
              and len(names_r) == i_llr + 2,
              f"map route: after pair_llr's kernel run {names_r[i_llr + 1:]}")
        say(f"map route: {len(names_r)} device ops a call, pair_llr's kernel then banded_dtw's "
            f"and nothing between or after: " + ", ".join(nm[:40] for nm in names_r))
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
    args96 = (-cost96, lens96, torch.randn(K, l96, device=dev), band, ids)
    check_scores(torch, kd.banded_dtw_scores(*args96), kd.banded_dtw_scores_plain(*args96),
                 "banded_dtw fused (L=96)")
    ms96_f = time_ms(torch, lambda: kd.banded_dtw_scores(*args96), loop=100)
    cells96 = band_cells(torch, l96, m96, lens96, band)
    b96, _by = bound_ms(cells96 * 4 + n_pairs * 8, 4 * cells96, FP32_FLOPS)
    say(f"banded_dtw at L = {l96} ({n_pairs} pairs, band {band}, M = {m96}): bitwise; "
        f"kernel {ms96:.4f} ms (raw mode; row 13's target <= 0.012 ms), fused {ms96_f:.4f} "
        f"ms; plain {plain96:.4f} ms; bound "
        f"{b96:.4f} ms (bytes; the chain is up to {l96 + l96 + band - 1} diagonals)")
    del llr, llr_ref, cost, cost96, args96, fbank8
    torch.cuda.empty_cache()

    # ---- the log-mel scan's kernels ------------------------------------
    mf = C.FrontendConfig(use_mel=True).feature_freqs
    templates_mel = rng.uniform(0.01, 0.99, (K, L, mf, 8)).astype(np.float32)
    background_mel = rng.uniform(0.01, 0.99, (mf, 8)).astype(np.float32)
    bank_mel = bank_from_numpy(templates_mel, background_mel, [f"k{i}" for i in range(K)], dev)
    mods = SimpleNamespace(C=C, fp=fp, fs=fs, k1=k1, k3=k3, k4=k4, kp=kp, k8=k8, k9=k9,
                           record_int8=record_int8, record_dft=record_dft)
    mel_kernel_checks(torch, mods, dev, wavs, nvalid, valid, frames2, bank_mel, record, say)
    torch.cuda.empty_cache()

    small_shape_checks(torch, dev, frames2, k1, k2, k3, k4, k5, kp, kd, k8, k9, kc, fp, fs,
                       say)
    say("small ragged shapes: all eleven kernels agree with their plain versions")
    wide_frontend_check(torch, C, fp, k8, _cuda, wavs, nvalid, say)

    # the map cells the kernels set otherwise than the plain run over the
    # corpus, in both frontend modes (the scans' score classes exempt the
    # windows that hold one)
    flips = {}
    for label, fc in (("default", fcfg), ("log-mel", C.FrontendConfig(use_mel=True))):
        flips[label], n_diff, n_all = map_flips(torch, fp, stream_scan, corpus, fc, B, dev)
        say(f"{label} frontend over the corpus: {n_diff} of {n_all} binary-map cells "
            f"({n_diff / n_all:.3g}) differ from the plain run's (tolerance 1e-3), in "
            f"{sum(len(v) for v in flips[label].values())} frames")
        check(n_diff <= 1e-3 * n_all, f"{label} frontend: the maps differ in too many cells")

    # ---- the scan at full width ---------------------------------------
    scan_cfg = C.PipelineConfig(detect=C.DetectConfig(batch_size=B))
    # one warm-up batch: first calls of PyTorch's own kernels (masking,
    # NMS, top-K) load their modules lazily
    detect_corpus_stream(corpus.head(B), bank, scan_cfg, target_phone="aa")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    k2.route_launches.update(cluster=0, multipass=0)
    t0 = time.perf_counter()
    res = detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    for name in SCAN_KERNELS:
        check(counts.get(name, 0) > 0, f"{name} was not launched by the scan")
    check(k2.route_launches == {"cluster": counts["select_binspread"], "multipass": 0},
          f"the scan's select_binspread launches by variant: {k2.route_launches}")
    take_launches(rows, SCAN_KERNELS, counts)
    ctr = res.counters
    check(ctr["batches"] == 3, f"expected 3 batches, got {ctr['batches']}")
    say(f"scan: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} audio-s, "
        f"{ctr['audio_s_per_s']:.1f} audio-s/s (scan loop {ctr['time_scan_s']:.4f} s; "
        f"with the bank build {wall:.4f} s; {ctr['batches']:.0f} batches); "
        f"launches {counts}")

    def bank_build(b, int8_dtw=False):
        """What ``detect_corpus_stream`` does before its loop: the bf16
        bank, or (``int8_dtw``) the int8 bank with its K-major copy and
        the rescore's bf16 filters."""
        def build():
            w_, c_ = b.llr()
            if not int8_dtw:
                return fs.build_fft_bank(filters_to_flat(w_), c_, mm_dtype=None)
            w_rows_, _c_rows = b.llr_rows()
            return (fs.build_fft_bank(filters_to_flat(w_), c_, mm_dtype=torch.int8),
                    filters_to_flat(w_rows_).to(torch.bfloat16).contiguous())
        return build

    report_busy(torch, say, "scan",
                lambda: detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa"),
                bank_build(bank), ctr)
    ref = detect_corpus_stream(corpus, bank, scan_cfg, target_phone="aa", plain=True)
    dk, dp = res.detections, ref.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no detections")
    frac, id_frac, *_ = match_detections(dk, dp)
    say(f"scan vs plain scan: {len(dk.scores)} vs {len(dp.scores)} detections, "
        f"{frac:.4f} matched peaks, {id_frac:.4f} same template on matched")
    check(frac >= 0.99, f"matched peaks {frac} < 0.99")
    check(id_frac >= 0.99, f"template ids agree on {id_frac} < 0.99 of matched")
    fft_dets = dk
    del res, ref

    # ---- the default scan resumed from a manifest; the PCM16 upload ----
    resume_phase(torch, say, corpus, bank, scan_cfg, fft_dets, ctr, _cuda)
    pcm16_phase(torch, say, corpus, bank, scan_cfg, _cuda)

    # ---- the DTW + int8 scan at full width (configs 4 and 5) -----------
    dtw_cfg = C.PipelineConfig(detect=C.DetectConfig(
        batch_size=B, dtw_rescore=True, int8_spectra=True))
    check(dtw_cfg.dtw.top_r == 1, "verify-the-winner is the default")
    # the warm-up batch's pair LLR operands, as the scan hands them over,
    # held against the plain version
    seen = []
    real_llr = dtw_mod.pair_llr

    def recording_llr(*a):
        seen.append([x.clone() if torch.is_tensor(x) else x for x in a])
        return real_llr(*a)

    dtw_mod.pair_llr = recording_llr
    try:
        detect_corpus_stream(corpus.head(B), bank, dtw_cfg, target_phone="aa")   # warm-up
    finally:
        dtw_mod.pair_llr = real_llr
    check(len(seen) == 1, f"the warm-up batch called pair_llr {len(seen)} times")
    a_s = seen[0]
    got_s, want_s = kp.pair_llr(*a_s), kp.pair_llr_plain(*a_s)
    err_s, top_s = float((got_s - want_s).abs().max()), float(want_s.abs().max())
    check(err_s <= 1e-5 * top_s, f"pair_llr on the DTW scan's ids: {err_s} > 1e-5 * {top_s}")
    ms_s = time_ms(torch, lambda: kp.pair_llr(*a_s), loop=100)
    say(f"pair_llr on the DTW scan's own operands ({a_s[2].numel()} pairs, "
        f"{int(torch.unique(a_s[3]).numel())} distinct ids): max error {err_s:.3g} "
        f"(1e-5 x {top_s:.4g} allowed); {ms_s:.4f} ms (loops of 100)")
    del seen, a_s, got_s, want_s
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
    take_launches(rows, ("pair_llr", "banded_dtw"), counts)
    take_launches(rows, ("fft_binmm_int8",), counts, shape=INT8_BENCH)
    ctr = res.counters
    say(f"DTW + int8 scan: {ctr['utterances']:.0f} utterances, "
        f"{ctr['audio_seconds']:.1f} audio-s, {ctr['audio_s_per_s']:.1f} audio-s/s (scan "
        f"loop {ctr['time_scan_s']:.4f} s; with the bank build {wall:.4f} s; "
        f"{ctr['batches']:.0f} batches); launches {counts}")
    ops_dtw = report_busy(torch, say, "DTW + int8 scan",
                          lambda: detect_corpus_stream(corpus, bank, dtw_cfg, target_phone="aa"),
                          bank_build(bank, int8_dtw=True), ctr)
    if ops_dtw is not None:
        say(f"DTW + int8 scan: {ops_dtw:.1f} device ops a batch (118.7 with the cost prologue "
            f"and the score's ops outside the DTW kernel; target <= 111.7)")
    ref = detect_corpus_stream(corpus, bank, dtw_cfg, target_phone="aa", plain=True)
    check_scan_scores(res.detections, ref.detections, flips["default"], m_seg, 1e-4,
                      "DTW + int8 scan", say)
    dtw_dets = res.detections
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
    ref = detect_corpus_stream(head, bank, ex_cfg, target_phone="aa", plain=True)
    say(f"exhaustive rescore (top_r 0, {B} x {top_k} peaks x {K} templates): {wall:.3f} s, "
        f"launches {counts}")
    total_ex, names_ex, n_ex = traced_device_ms(
        torch, lambda: detect_corpus_stream(head, bank, ex_cfg, target_phone="aa"))
    if total_ex is None:
        say("exhaustive rescore: device time by name not measured (no device event traced)")
    else:
        gemm = sum(ms for nm, ms in names_ex.items() if "gemm" in nm.lower())
        dtw_ex = sum(ms for nm, ms in names_ex.items() if "banded_dtw" in nm)
        copies = sum(ms for nm, ms in names_ex.items()
                     if "elementwise" in nm or "copy" in nm.lower())
        say(f"exhaustive rescore, traced (one batch, bank build included): {total_ex:.3f} ms of "
            f"device time in {n_ex} device ops; fp32 GEMM kernels {gemm:.3f} ms "
            f"({gemm / total_ex:.3f}), banded_dtw {dtw_ex:.3f} ms ({counts.get('banded_dtw', 0)} "
            f"launches), elementwise and copy kernels {copies:.3f} ms")
    check_scan_scores(res.detections, ref.detections, flips["default"], m_seg, 1e-4,
                      "exhaustive rescore", say)
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
        check(counts.get("radix_select", 0) == ctr["batches"],
              f"{label}: {counts.get('radix_select', 0)} radix_select calls for "
              f"{ctr['batches']} batches")
        check(counts.get("binspread", 0) == ctr["batches"],
              f"{label}: {counts.get('binspread', 0)} binspread calls for "
              f"{ctr['batches']} batches")
        if not dkw:
            take_launches(rows, ("frontend_planes_mel", "radix_select", "binspread"), counts)
            take_launches(rows, ("fft_binmm",), counts, shape=BINMM_MEL)
            take_launches(rows, ("fft_block_dft",), counts, shape=DFT_MEL)
        else:
            take_launches(rows, ("fft_binmm_int8",), counts, shape=INT8_MEL)
        say(f"{label}: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} "
            f"audio-s, {ctr['audio_s_per_s']:.1f} audio-s/s (scan loop "
            f"{ctr['time_scan_s']:.4f} s; with the bank build {wall:.4f} s; "
            f"{ctr['batches']:.0f} batches); launches {counts}")
        report_busy(torch, say, label,
                    lambda: detect_corpus_stream(corpus, bank_mel, mcfg, target_phone="aa"),
                    bank_build(bank_mel, int8_dtw=bool(dkw)), ctr)
        ref = detect_corpus_stream(corpus, bank_mel, mcfg, target_phone="aa", plain=True)
        # the sliding score at t reads frames [t, t + L); the DTW rescore
        # [t, t + L + band)
        check_scan_scores(res.detections, ref.detections, flips["log-mel"],
                          m_seg if dkw else L, 4e-3, label, say)
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
    dk = res.detections
    check(len(dk.scores) > 0 and bool(np.isfinite(dk.scores).all()), "no conv detections")
    # printed only: the bf16 FFT scorer moves borderline NMS peaks, so
    # this measures the fft scan's error, not the conv's
    frac, id_frac, diff, top, _ = match_detections(dk, fft_dets)
    say(f"conv scan: {ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} audio-s, "
        f"{ctr['audio_s_per_s']:.1f} audio-s/s (scan loop {ctr['time_scan_s']:.4f} s; with the "
        f"bank build {wall:.4f} s; {ctr['batches']:.0f} batches); launches {counts}; "
        f"vs the fft scan (not a "
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

    # ---- config-3 training, then scans with the banks it builds --------
    t0 = time.perf_counter()
    em_input, soak_utts, trained = training_phase(torch, dev, C, say, corpus, scan_cfg,
                                                  flips["default"], record, rows)
    say(f"training phase: {time.perf_counter() - t0:.1f} s")

    # ---- soak.py and soak_bank10k.py: the corpus-scale runs ------------
    soak_mods = SimpleNamespace(fs=fs, k4=k4, k5=k5, record=record, record_int8=record_int8)
    soak_phase(torch, say, dev, C, soak_mods, rows, soak_utts, trained)
    del soak_utts, trained
    torch.cuda.empty_cache()

    # ---- the FFT scan at template lengths past one-pass plans ----------
    mods = SimpleNamespace(fs=fs, k3=k3, k4=k4, k5=k5, kd=kd, kp=kp, _cuda=_cuda,
                           bank_from_numpy=bank_from_numpy, filters_to_flat=filters_to_flat,
                           detect_corpus_stream=detect_corpus_stream, dtw_mod=dtw_mod,
                           record_int8=record_int8, record_dft=record_dft)
    shapes_phase(torch, say, dev, C, corpus, flat.reshape(B, t_pad, d).to(torch.bfloat16),
                 flips["default"], record, rows, mods)
    torch.cuda.empty_cache()

    # ---- inputs that only the reference scored before -------------------
    domain_phase(torch, say, dev, wavs, nvalid, record, rows)

    # ---- the sharded scan and EM: parallel/ on torch.distributed -------
    t0 = time.perf_counter()
    sharded_phase(torch, say, dev, C, corpus, bank,
                  {"default": fft_dets, "DTW + int8": dtw_dets}, flips["default"], em_input,
                  _cuda)
    say(f"sharded phase: {time.perf_counter() - t0:.1f} s")

    # ---- the multi-device entry points: scaling, dry run, fake mesh ----
    multichip_phase(torch, say, dev, card, multichip_mods, rows)

    # ---- TIMIT input: the tree, decode, train, scan, trace, CLI --------
    t0 = time.perf_counter()
    timit_phase(torch, say, dev, C, bank, bank_build, rows, _cuda)
    say(f"TIMIT phase: {time.perf_counter() - t0:.1f} s")

    return finish(torch, card, rows, say, t_start)


def finish(torch, card, rows, say, t_start) -> int:
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(sys.argv[2]))
    try:
        sys.exit(main(only=sys.argv[1][2:] if sys.argv[1:] in (
            ["--domain"], ["--bench"], ["--verify"], ["--soak"], ["--multichip"]) else None))
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
