#!/usr/bin/env python3
"""Config 5 at spec scale on one GPU: ``soak_bank10k.py`` on the card.

    python3 soak_bank10k_cuda.py [--device cpu] [--out PATH]

A bank of ``SOAK_BANK_K`` (10,000) templates streamed by
``parallel.detect_corpus_sharded`` at mesh (1, 1, 1) over ``soak.py``'s
~1 h corpus (``soak_cuda.build_corpus``, ``SOAK_UTTS_PER_GROUP`` 75:
300 utterances) in batches of ``SOAK_BATCH`` (8).  The bank is the aa /
iy bank trained on that corpus, inflated to K templates by
``inflate_bank`` (the reference's, bit for bit: the trained templates
tiled, ``normal(0, 0.05)`` noise from ``default_rng(seed)``, clipped to
[0.01, 0.99], labels ``kw00000``...).  The scan runs on bf16 spectra
(kernels 3, 4, 5) and on int8 spectra (``soak_bank10k.py``'s
``SOAK_INT8=1``: kernels 3, 6, 5).  Each records the corpus audio-s/s,
the detections and the peak ``torch.cuda.max_memory_allocated`` (from
the bank's spectra to the last batch) beside what was allocated before
the scan, with the card's name and power limit.

Each scan is held three ways (``bank10k_soak``):

* against the same scan with ``plain=True`` (every kernel's plain
  version): >= 99% matched peaks, the same template on >= 99% of them,
  scores within 4e-3 x max|score| on the matches whose window holds no
  map cell the two runs set differently (at most 0.1 of them exempt;
  ``card_checks.check_scan_scores``, the class of its bf16 and int8
  scans); on the CPU the two are one computation;
* against ``scan.detect_corpus_stream`` of the same bank and config, the
  reference's sharded-vs-stream contract (``soak_bank10k.py``): the same
  number of peaks, times and template ids identical, scores allclose at
  rtol 1e-4, atol 1e-3;
* the int8 scan's agreement with the bf16 scan (matched peaks, the same
  template on the matched) is printed, in the terms of the int8 class
  (argmax agreement ~0.99).

Prints one JSON object last and writes it to ``--out`` (default
``SOAK_BANK10K_CUDA.json`` here; not committed).  Runs on the card;
without a CUDA device it exits 2, unless ``--device cpu`` is given (the
plain versions on the CPU, for the tests).  Imports the port and
``oracle/``, nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

K_TOTAL = 10_000
BATCH = 8
SCORE_TOL = 4e-3           # x max|score|: the bf16 / int8 scans' class


def inflate_bank(bank, k_total: int, seed: int = 0):
    """``bank`` inflated to ``k_total`` templates, as the reference's
    ``soak_bank10k.inflate_bank``: each one a clipped perturbation of a
    trained one (a stand-in for 10k distinct keyword templates with the
    same shapes and dynamic range), on the bank's device."""
    import torch

    from template_speech_recognition_tpu_torch.models.bank import TemplateBank

    base = bank.templates.detach().cpu().numpy().astype(np.float32)     # [K0, L, F, E]
    rng = np.random.default_rng(seed)
    reps = -(-k_total // base.shape[0])
    tiled = np.tile(base, (reps, 1, 1, 1))[:k_total]
    noise = rng.normal(0.0, 0.05, tiled.shape).astype(np.float32)
    tpl = np.clip(tiled + noise, 0.01, 0.99)
    labels = [f"kw{i:05d}" for i in range(k_total)]
    return TemplateBank(torch.from_numpy(tpl).to(bank.device), bank.background, labels,
                        bank.parts)


def stream_contract(got, want) -> tuple[bool, str]:
    """The reference's sharded-vs-stream contract on two detection sets:
    as many peaks, in (utterance, time) order times and template ids
    identical, scores allclose at rtol 1e-4, atol 1e-3."""
    og = np.lexsort((got.times, got.utterance_ids))
    ow = np.lexsort((want.times, want.utterance_ids))
    if len(got.scores) != len(want.scores) or not len(got.scores):
        return False, f"{len(got.scores)} vs {len(want.scores)} peaks"
    same = (np.array_equal(got.utterance_ids[og], want.utterance_ids[ow])
            and np.array_equal(got.times[og], want.times[ow])
            and np.array_equal(got.template_ids[og], want.template_ids[ow]))
    diff = float(np.max(np.abs(got.scores[og] - want.scores[ow])))
    close = bool(np.allclose(got.scores[og], want.scores[ow], rtol=1e-4, atol=1e-3))
    return same and close, (f"{len(got.scores)} peaks, times and ids "
                            f"{'identical' if same else 'DIFFER'}, score max diff {diff:.6g}")


def scan_configs(batch: int):
    """(label, config): the bf16 scan and the int8 scan."""
    from template_speech_recognition_tpu_torch import config as C

    return [(label, C.PipelineConfig(detect=C.DetectConfig(batch_size=batch,
                                                           int8_spectra=int8)))
            for label, int8 in (("bf16", False), ("int8", True))]


# the kernels each scan launches on the card
SCAN_KERNELS = {"bf16": ("fft_block_dft", "fft_binmm", "fft_idft"),
                "int8": ("fft_block_dft", "fft_binmm_int8", "fft_idft")}


def bank10k_soak(corpus, bank, batch, mesh, dev, say, flips=None,
                 around_stream=contextlib.nullcontext) -> dict:
    """The bf16 and the int8 scan of ``corpus`` with ``bank`` at ``mesh``,
    each held three ways (the module's docstring; ``flips``: the frames
    holding map cells that the kernels and the plain versions set
    differently, ``card_checks.map_flips`` at this batch) -> {label:
    record}; a record's ``"launches"`` are the scan's on the card, its
    ``"detections_set"`` the clean scan's detections.  A failed hold
    raises ``card_checks.CheckFailed``.  ``around_stream()`` wraps the
    stream scan (a caller's hook: it may read the kernels' operands
    there)."""
    import torch

    from card_checks import check, check_scan_scores, match_detections
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.parallel import detect_corpus_sharded
    from template_speech_recognition_tpu_torch.scan import detect_corpus_stream

    cuda = dev.type == "cuda"
    out = {}
    for label, cfg in scan_configs(batch):
        base = None
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = detect_corpus_sharded(corpus, bank, cfg, mesh, target_phone="aa")
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        ctr = res.counters
        rec = {"audio_s_per_s": ctr["audio_s_per_s"], "wall_s": wall,
               "detections": int(len(res.detections.scores)), "batches": int(ctr["batches"]),
               "peak_bytes": peak, "base_bytes": base, "launches": dict(counts)}
        mem = ("not measured (CPU)" if peak is None else
               f"{peak / 1e9:.3f} GB, of which {base / 1e9:.3f} GB allocated before the scan "
               f"(the bank's templates among them)")
        say(f"K {bank.num_templates} {label} scan (mesh (1, 1, 1), batch {batch}): "
            f"{ctr['utterances']:.0f} utterances, {ctr['audio_seconds']:.1f} audio-s, "
            f"{ctr['batches']:.0f} batches, {ctr['audio_s_per_s']:.1f} audio-s/s (scan loop; "
            f"{wall:.3f} s with the bank's spectra), {rec['detections']} detections, peak "
            f"torch.cuda.max_memory_allocated {mem}; launches {counts}")
        if cuda:
            for name in SCAN_KERNELS[label]:
                check(counts.get(name, 0) == ctr["batches"],
                      f"K {bank.num_templates} {label} scan: {name} launched "
                      f"{counts.get(name, 0)}x in {ctr['batches']:.0f} batches")
        plain = detect_corpus_sharded(corpus, bank, cfg, mesh, target_phone="aa", plain=True)
        check_scan_scores(res.detections, plain.detections, flips, bank.template_length,
                          SCORE_TOL, f"K {bank.num_templates} {label} scan", say)
        del plain
        with around_stream():
            stream = detect_corpus_stream(corpus, bank, cfg, target_phone="aa")
        ok, text = stream_contract(res.detections, stream.detections)
        say(f"K {bank.num_templates} {label} scan vs detect_corpus_stream: {text} (contract: "
            f"times and ids identical, scores rtol 1e-4, atol 1e-3)")
        check(ok, f"K {bank.num_templates} {label} scan: not the stream's detections ({text})")
        del stream
        rec["detections_set"] = res.detections
        out[label] = rec
    frac, id_frac, _d, _t, _e = match_detections(out["int8"]["detections_set"],
                                                 out["bf16"]["detections_set"])
    out["int8"].update(matched_vs_bf16=frac, same_template_vs_bf16=id_frac)
    say(f"K {bank.num_templates} int8 scan vs the bf16 scan: {frac:.4f} matched peaks, "
        f"{id_frac:.4f} same template on matched (the int8 class: argmax agreement ~0.99; "
        f"printed only)")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; exits 2 without a GPU) or cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    p.add_argument("--out", default=os.path.join(here, "SOAK_BANK10K_CUDA.json"))
    args = p.parse_args(argv)
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch

    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("soak_bank10k_cuda: no CUDA device (--device cpu runs the plain versions on "
              "the CPU)", file=sys.stderr)
        return 2
    from card_checks import TRAIN_PHONES, CheckFailed, card_line, map_flips
    from soak_cuda import build_corpus, mesh_of_one, scan_config
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.pipeline import train_bank
    from template_speech_recognition_tpu_torch.scan import stream_scan

    card = None
    if dev.type == "cuda":
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

    k_total = int(os.environ.get("SOAK_BANK_K", K_TOTAL))
    batch = int(os.environ.get("SOAK_BATCH", BATCH))
    corpus = build_corpus(int(os.environ.get("SOAK_UTTS_PER_GROUP", 75)))
    bank = inflate_bank(train_bank(corpus, list(TRAIN_PHONES), scan_config(batch),
                                   device=dev), k_total)
    flips = None
    if dev.type == "cuda":
        flips, n_diff, n_all = map_flips(torch, fp, stream_scan, corpus,
                                         scan_config(batch).frontend, batch, dev)
        say(f"soak corpus at batch {batch}: {n_diff} of {n_all} map cells differ from the "
            f"plain run's")
    try:
        with mesh_of_one(dev) as mesh:
            recs = bank10k_soak(corpus, bank, batch, mesh, dev, say, flips)
    except CheckFailed as exc:
        print(f"soak_bank10k_cuda: FAILED: {exc}", file=sys.stderr)
        return 1
    utts = corpus.corpus.utterances
    out = {"card": card, "bank_k": k_total, "template_length": bank.template_length,
           "corpus": {"utterances": len(utts),
                      "audio_seconds": sum(len(u.waveform) for u in utts) / corpus.sample_rate},
           "mesh": [1, 1, 1], "batch_size": batch,
           "scans": {label: {k: v for k, v in rec.items() if k != "detections_set"}
                     for label, rec in recs.items()}}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    if card:
        print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
