#!/usr/bin/env python3
"""Corpus-scale soak of the port's sharded scan on one GPU: ``soak.py``
on the card.

    python3 soak_cuda.py [--device cpu] [--out PATH]

Builds ``soak.py``'s synthetic corpus (``build_corpus``: four groups of
utterances of 25, 50, 75 and 100 phones, ~5/10/14/19 s, seeds 100-103,
interleaved; 300 utterances, ~3,624 audio-s by default), trains an aa /
iy bank on it (``pipeline.train_bank``), then runs
``parallel.detect_corpus_sharded`` at mesh (1, 1, 1) over the whole
corpus three times (``fault_resume_clean``):

1. fault: with a ``checkpoint.ScanManifest``; ``sharded_scan_step`` is
   replaced by one that raises after half of the scan's batches, so the
   scan fails part way and records the batches it ran;
2. resume: the same manifest; the recorded shards load from disk and
   the rest are computed;
3. clean: no manifest; its ``audio_s_per_s`` counter is the corpus
   throughput.

The resumed detections must equal the clean ones bitwise (scores,
times, template ids, utterance ids), the fault must have fired after
half the batches, the resume must compute only the shards the fault
left and load the others.

Knobs (``soak.py``'s, with its defaults): ``SOAK_UTTS_PER_GROUP`` (75),
``SOAK_BATCH`` (32), ``SOAK_DTW=1`` (DTW rescoring, verify-the-winner),
``SOAK_INT8=1`` (int8 template spectra), ``SCAN_FETCH_GROUP`` and
``SCAN_UPLOAD_INT16`` (read by the scan); ``SOAK_MESH`` takes only
``1,1,1`` (one card).

Writes one JSON object with ``SOAK_r05.json``'s keys to ``--out``
(default ``SOAK_CUDA.json`` here; its throughput is the card's, so the
file carries the card's ``nvidia-smi`` name and power limit and is not
committed) and prints it as its last line.  Runs on the card; without a
CUDA device it exits 2, unless ``--device cpu`` is given (the plain
versions on the CPU, for the tests).  Imports the port and ``oracle/``,
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

UTTS_PER_GROUP = 75
GROUP_PHONES = (25, 50, 75, 100)   # phones an utterance, group by group
GROUP_SEED = 100                   # group g draws from seed 100 + g


class SoakFailed(Exception):
    pass


def build_corpus(utts_per_group: int):
    """``soak.py``'s corpus: four groups of synthetic utterances of
    25/50/75/100 phones (``oracle.fixtures``, seeds 100-103), interleaved
    so every length bucket mixes groups, as a port ``SyntheticAdapter``."""
    from oracle.fixtures import make_synthetic_corpus
    from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter

    groups = [make_synthetic_corpus(num_utterances=utts_per_group, phones_per_utterance=ppu,
                                    seed=GROUP_SEED + gi)
              for gi, ppu in enumerate(GROUP_PHONES)]
    utts = [g.utterances[i] for i in range(utts_per_group) for g in groups]
    return SyntheticAdapter(type(groups[0])(utts, groups[0].sample_rate,
                                            groups[0].phone_names))


def count_batches(corpus, batch: int) -> int:
    """The batches a scan of ``corpus`` runs (``scan.stream_scan``'s
    bucketing: a batch each time a length bucket fills, then one tail
    batch a bucket with utterances left)."""
    from template_speech_recognition_tpu_torch.scan import bucket_length

    sizes: dict[int, int] = {}
    for _u, wav, _p in corpus.iter_utterances():
        pad = bucket_length(len(wav))
        sizes[pad] = sizes.get(pad, 0) + 1
    return sum(-(-n // batch) for n in sizes.values())


def scan_config(batch: int, dtw: bool = False, int8: bool = False):
    """``soak.py``'s scan config: batches of ``batch``; with ``dtw``,
    DTW rescoring (verify-the-winner, ``DTWConfig``'s default ``top_r``
    1)."""
    from template_speech_recognition_tpu_torch import config as C

    return C.PipelineConfig(detect=C.DetectConfig(batch_size=batch, dtw_rescore=dtw,
                                                  int8_spectra=int8))


@contextlib.contextmanager
def mesh_of_one(dev):
    """Mesh (1, 1, 1) of this process: the process group already started,
    or a world of one (NCCL on the card, gloo on the CPU) over an
    in-process store, destroyed on exit."""
    import torch.distributed as dist

    from template_speech_recognition_tpu_torch.config import MeshConfig
    from template_speech_recognition_tpu_torch.parallel import build_mesh

    started = not dist.is_initialized()
    if started:
        cuda = dev.type == "cuda"
        if cuda and dev.index is None:
            import torch

            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev if cuda else None)
    try:
        yield build_mesh(MeshConfig(1, 1, 1))
    finally:
        if started:
            dist.destroy_process_group()


def _timed(dev, fn):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def fault_resume_clean(corpus, bank, cfg, mesh, dev, target_phone: str = "aa") -> dict:
    """``soak.py``'s three runs of ``detect_corpus_sharded`` (the module's
    docstring) -> their record (``fault_run``, ``resume_run``,
    ``clean_run``: walls, counters, the clean scan's launch counts) and,
    under ``"clean"``, the clean scan's ``CorpusDetections``.  Raises
    ``SoakFailed`` when the fault did not fire after half the batches,
    the manifest does not hold the batches run before it, the resume
    computed another set of shards, or the resumed detections are not
    bitwise the clean ones."""
    from card_checks import same_detections
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.parallel import detect_sharded as ds

    n_batches = count_batches(corpus, cfg.detect.batch_size)
    fault_at = max(n_batches // 2, 1)
    calls = {"n": 0}
    real = ds.sharded_scan_step

    def faulty(*a, **k):
        calls["n"] += 1
        if calls["n"] > fault_at:
            raise RuntimeError("soak: injected fault")
        return real(*a, **k)

    def scan(manifest=None):
        return ds.detect_corpus_sharded(corpus, bank, cfg, mesh, target_phone=target_phone,
                                        manifest=manifest)

    with tempfile.TemporaryDirectory() as mdir:
        ds.sharded_scan_step = faulty
        t0 = time.perf_counter()
        try:
            scan(ScanManifest(mdir))
            raise SoakFailed("soak: the injected fault never fired")
        except RuntimeError as err:
            if "injected fault" not in str(err):
                raise
        finally:
            ds.sharded_scan_step = real
        t_fault = time.perf_counter() - t0
        recorded = sorted(ScanManifest(mdir).completed())
        if calls["n"] != fault_at + 1 or recorded != list(range(fault_at)):
            raise SoakFailed(f"soak: the fault fired at call {calls['n']} of {n_batches} "
                             f"batches; shards recorded {recorded}, {fault_at} expected")
        resumed, t_resume = _timed(dev, lambda: scan(ScanManifest(mdir)))
    _cuda.reset_launches()
    clean, t_clean = _timed(dev, scan)
    launches = _cuda.launch_counts()
    rc = resumed.counters
    if (int(rc["batches"]), int(rc["shards_loaded"])) != (n_batches - fault_at, fault_at):
        raise SoakFailed(f"soak: the resume computed {rc['batches']:.0f} and loaded "
                         f"{rc['shards_loaded']:.0f} of {n_batches} shards")
    if len(clean.detections.scores) == 0 or not same_detections(resumed.detections,
                                                                  clean.detections):
        raise SoakFailed("soak: the resumed detections are not bitwise the clean scan's")
    return {
        "fault_run": {"batches": n_batches, "killed_after_batches": fault_at,
                      "shards_recorded": len(recorded), "wall_s": t_fault},
        "resume_run": {"wall_s": t_resume, "batches_computed": int(rc["batches"]),
                       "shards_loaded": int(rc["shards_loaded"]),
                       "audio_s_per_s": rc["audio_s_per_s"], "resume_matches_clean": True},
        "clean_run": {"wall_s": t_clean, "audio_s_per_s": clean.counters["audio_s_per_s"],
                      "detections": int(len(clean.detections.scores)), "launches": launches},
        "counters": dict(clean.counters),
        "clean": clean,
    }


def soak_record(corpus, bank, cfg, mesh, dev, card) -> dict:
    """``fault_resume_clean`` with ``soak.py``'s record around it: the
    corpus, the knobs, EER and best TPR of the clean scan, the card."""
    from template_speech_recognition_tpu_torch.pipeline import evaluate_detections

    runs = fault_resume_clean(corpus, bank, cfg, mesh, dev)
    clean = runs.pop("clean")
    metrics = evaluate_detections(clean, cfg.detect.match_tolerance)
    runs["clean_run"].update(eer=float(metrics["eer"]), best_tpr=float(metrics["best_tpr"]))
    utts = corpus.corpus.utterances
    return {
        "card": card,
        "batch_size": cfg.detect.batch_size,
        "fetch_group": int(os.environ.get("SCAN_FETCH_GROUP", "8")),
        "upload_int16": os.environ.get("SCAN_UPLOAD_INT16", "0") == "1",
        "int8_spectra": cfg.detect.int8_spectra,
        "dtw_rescore_top_r1": cfg.detect.dtw_rescore,
        "corpus": {"utterances": len(utts),
                   "audio_seconds": sum(len(u.waveform) for u in utts) / corpus.sample_rate,
                   "length_groups_s": "~5/10/14/19"},
        "mesh": {"data": 1, "bank": 1, "time": 1},
        "bank": {"k": bank.num_templates, "template_length": bank.template_length},
        **runs,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; exits 2 without a GPU) or cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    p.add_argument("--out", default=os.path.join(here, "SOAK_CUDA.json"))
    args = p.parse_args(argv)
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch

    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("soak_cuda: no CUDA device (--device cpu runs the plain versions on the CPU)",
              file=sys.stderr)
        return 2
    if os.environ.get("SOAK_MESH", "1,1,1").replace(" ", "") != "1,1,1":
        print("soak_cuda: SOAK_MESH takes only 1,1,1 (one card)", file=sys.stderr)
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
        card = card_line()
        enable_compile_cache()
    from card_checks import TRAIN_PHONES
    from template_speech_recognition_tpu_torch.pipeline import train_bank

    upg = int(os.environ.get("SOAK_UTTS_PER_GROUP", UTTS_PER_GROUP))
    cfg = scan_config(int(os.environ.get("SOAK_BATCH", 32)),
                      os.environ.get("SOAK_DTW", "0") == "1",
                      os.environ.get("SOAK_INT8", "0") == "1")
    corpus = build_corpus(upg)
    bank = train_bank(corpus, list(TRAIN_PHONES), cfg, device=dev)
    with mesh_of_one(dev) as mesh:
        out = soak_record(corpus, bank, cfg, mesh, dev, card)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    if card:
        print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
