"""CLI of the port: the ``train``, ``detect``, ``evaluate``, ``classify``
and ``bench`` subcommands.

    python -m template_speech_recognition_tpu_torch train \\
        --corpus synthetic --phones aa,iy --bank bank.npz [--components N] [--parts N]
    python -m template_speech_recognition_tpu_torch detect \\
        --corpus synthetic --bank bank.npz --phone aa --out dets.npz
    python -m template_speech_recognition_tpu_torch evaluate \\
        --corpus synthetic --bank bank.npz --phone aa --artifacts out/
    python -m template_speech_recognition_tpu_torch classify \\
        --corpus synthetic --bank bank.npz [--dtw]
    python -m template_speech_recognition_tpu_torch bench \\
        [--bench-script bench_cuda.py] [--device cpu]

``--corpus synthetic`` builds the in-memory fixture corpus;
``--corpus timit:<root>`` reads every record of a TIMIT tree
(``io.corpus.TimitCorpus`` through ``corpus.TimitAdapter``), as the
reference does.

``--bank`` is the ``.npz`` that ``TemplateBank.save`` writes: ``train``
writes it and ``detect`` and ``evaluate`` read it.  The reference's CLI
writes and reads an orbax *directory* there instead, so a bank crosses
between the two CLIs only as ``.npz`` (either package's
``TemplateBank.save``).  The flags and the one JSON line printed match
the reference's ``train``, ``detect``, ``evaluate`` and ``classify``:
``train``'s ``--phones``, ``--components`` and ``--parts N``;
``--dtw-rescore`` (config 4), ``--dtw-top-r``, ``--int8-spectra``,
``--exact`` (int32 scores), ``--score-backend``, ``--manifest DIR`` (a
``checkpoint.ScanManifest``: the stream records its shards there and a
rerun resumes from them), ``evaluate``'s ``--artifacts`` (``roc.npz``,
``detections.npz``, ``metrics.json``) and ``--tensorboard DIR`` (the
reference's scalars through torch's ``SummaryWriter``, where the
``tensorboard`` package is installed), and ``classify``'s ``--dtw``.
``bench`` runs a benchmark script through ``runpy``, as the reference's
does: ``--bench-script`` (default ``bench_cuda.py`` beside the package)
with ``--device`` passed on, its exit code the subcommand's.  Every
subcommand runs on the GPU unless ``--device cpu`` is given; on the GPU
``main`` first builds every kernel not built yet, all at once
(``utils.compile_cache``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# the benchmark script ``bench`` runs by default: at the root of the checkout
BENCH_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "bench_cuda.py")


def _build_corpus(spec: str, seed: int):
    from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter, TimitAdapter

    if spec == "synthetic":
        from oracle.fixtures import make_synthetic_corpus

        return SyntheticAdapter(
            make_synthetic_corpus(
                num_utterances=6, phones_per_utterance=5, seed=seed
            )
        )
    if spec.startswith("timit:"):
        from template_speech_recognition_tpu_torch.io.corpus import TimitCorpus

        return TimitAdapter(TimitCorpus(spec.split(":", 1)[1]))
    raise SystemExit(f"unknown corpus spec {spec!r} (synthetic | timit:<root>)")


def _load_config(args):
    from template_speech_recognition_tpu_torch import config as C

    if args.config:
        with open(args.config) as f:
            cfg = C.from_json(f.read())
    else:
        cfg = C.PipelineConfig()
    if getattr(args, "components", None):
        cfg = C.override(cfg, template=C.override(cfg.template,
                                                  num_components=args.components))
    if getattr(args, "parts", 0):
        cfg = C.override(cfg, parts=C.override(cfg.parts, enabled=True,
                                               num_parts=args.parts))
    if getattr(args, "dtw_rescore", False):
        cfg = C.override(cfg, detect=C.override(cfg.detect, dtw_rescore=True))
    if getattr(args, "dtw_top_r", None) is not None:
        cfg = C.override(cfg, dtw=C.override(cfg.dtw, top_r=args.dtw_top_r))
    if getattr(args, "exact", False):
        cfg = C.override(cfg, detect=C.override(cfg.detect, exact_scores=True))
    if getattr(args, "score_backend", None):
        cfg = C.override(cfg, detect=C.override(cfg.detect,
                                                score_backend=args.score_backend))
    if getattr(args, "int8_spectra", False):
        cfg = C.override(cfg, detect=C.override(cfg.detect, int8_spectra=True))
    return cfg


def _scan(args):
    """The corpus scan both subcommands run -> (config, result)."""
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest
    from template_speech_recognition_tpu_torch.pipeline import detect_corpus

    cfg = _load_config(args)
    corpus = _build_corpus(args.corpus, args.seed)
    bank = TemplateBank.load(args.bank, device=args.device)
    manifest = ScanManifest(args.manifest) if args.manifest else None
    return cfg, detect_corpus(corpus, bank, cfg, target_phone=args.phone,
                              manifest=manifest)


def cmd_train(args) -> int:
    from template_speech_recognition_tpu_torch.pipeline import train_bank

    cfg = _load_config(args)
    corpus = _build_corpus(args.corpus, args.seed)
    phones = args.phones.split(",")
    bank = train_bank(corpus, phones, cfg, device=args.device)
    bank.save(args.bank)
    print(
        json.dumps(
            {
                "trained": phones,
                "num_templates": bank.num_templates,
                "template_length": bank.template_length,
                "bank": args.bank,
            }
        )
    )
    return 0


def _save_detections(path: str, d) -> None:
    np.savez(path, scores=d.scores, times=d.times, template_ids=d.template_ids,
             utterance_ids=d.utterance_ids)


def cmd_detect(args) -> int:
    _cfg, result = _scan(args)
    d = result.detections
    if args.out:
        _save_detections(args.out, d)
    print(
        json.dumps(
            {
                "num_detections": int(len(d.scores)),
                "audio_seconds": round(result.audio_seconds, 2),
                "audio_s_per_s": round(result.counters.get("audio_s_per_s", 0.0), 2),
                "out": args.out,
            }
        )
    )
    return 0


def cmd_evaluate(args) -> int:
    from template_speech_recognition_tpu_torch.pipeline import evaluate_detections

    cfg, result = _scan(args)
    metrics = evaluate_detections(result, cfg.detect.match_tolerance)
    summary = {
        "phone": args.phone,
        "eer": round(float(metrics["eer"]), 4),
        "best_tpr": round(float(metrics["best_tpr"]), 4),
        "num_labels": int(metrics["num_labels"]),
        "num_detections": int(metrics["num_detections"]),
    }
    if args.artifacts:
        # the ROC curve arrays, the detections, and the summary with the
        # scan's counters
        os.makedirs(args.artifacts, exist_ok=True)
        np.savez(
            os.path.join(args.artifacts, "roc.npz"),
            thresholds=metrics["thresholds"],
            tpr=metrics["tpr"],
            fp_per_sec=metrics["fp_per_sec"],
            eer=np.float64(metrics["eer"]),
        )
        _save_detections(os.path.join(args.artifacts, "detections.npz"),
                         result.detections)
        with open(os.path.join(args.artifacts, "metrics.json"), "w") as f:
            json.dump({**summary, "counters": result.counters}, f, indent=2)
        summary["artifacts"] = args.artifacts
    if args.tensorboard:
        # the reference's scalars and tags; the package stays optional
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as exc:
            print(f"tensorboard unavailable: {exc}", file=sys.stderr)
        else:
            tw = SummaryWriter(args.tensorboard)
            tw.add_scalar("eval/eer", float(metrics["eer"]))
            tw.add_scalar("eval/best_tpr", float(metrics["best_tpr"]))
            tw.add_scalar("eval/audio_s_per_s",
                          float(result.counters.get("audio_s_per_s", 0.0)))
            for i in range(len(metrics["tpr"])):
                tw.add_scalar("roc/tpr", float(metrics["tpr"][i]), i)
                tw.add_scalar("roc/fp_per_sec", float(metrics["fp_per_sec"][i]), i)
            tw.close()
            summary["tensorboard"] = args.tensorboard
    print(json.dumps(summary))
    return 0


def cmd_classify(args) -> int:
    """Isolated-segment classification over the corpus's labelled spans
    of the bank's classes, at least ``frame_length + 3 * hop_length``
    samples long, as in the reference.  The maps come from the batched
    frontend (``pipeline._clip_feature_maps``: 128 clips a call); with a
    parts-coded bank a segment whose coded length
    ``(valid - patch_time) // stride_time + 1`` is below 1 is skipped."""
    from template_speech_recognition_tpu_torch.detect.classify import classify_segments
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.pipeline import _clip_maps_kept, _code_map_list

    cfg = _load_config(args)
    corpus = _build_corpus(args.corpus, args.seed)
    bank = TemplateBank.load(args.bank, device=args.device)
    classes = sorted(set(bank.labels))
    min_samples = cfg.frontend.frame_length + 3 * cfg.frontend.hop_length
    clips = [(phone, wav[s0:e0]) for _u, wav, phones in corpus.iter_utterances()
             for phone, s0, e0 in phones if phone in classes and e0 - s0 >= min_samples]
    if not clips:
        raise SystemExit("no scoreable segments found")
    stack, lengths, kept = _clip_maps_kept([c for _p, c in clips], cfg, bank.device)
    truth = [clips[i][0] for i in kept]
    if bank.parts is not None:
        pcfg = cfg.parts
        ok = np.flatnonzero((lengths - pcfg.patch_time) // pcfg.stride_time + 1 >= 1)
        if not len(ok):
            raise SystemExit("no scoreable segments found")
        stack, lengths = _code_map_list(stack[ok], lengths[ok], bank.parts, pcfg)
        truth = [truth[i] for i in ok]
    preds, _ = classify_segments(stack[:, : int(lengths.max())], lengths, bank,
                                 use_dtw=args.dtw, band=cfg.dtw.band)
    acc = float(np.mean([p == t for p, t in zip(preds, truth)]))
    print(json.dumps({"num_segments": len(truth), "accuracy": round(acc, 4),
                      "classes": classes, "dtw": bool(args.dtw)}))
    return 0


def cmd_bench(args) -> int:
    """Run ``args.bench_script`` as ``__main__`` with ``--device`` passed
    on; its exit code is the subcommand's."""
    import runpy

    argv = sys.argv
    sys.argv = [args.bench_script] + (["--device", args.device] if args.device else [])
    try:
        runpy.run_path(args.bench_script, run_name="__main__")
    except SystemExit as exc:
        if exc.code is None or isinstance(exc.code, int):
            return exc.code or 0
        print(exc.code, file=sys.stderr)
        return 1
    finally:
        sys.argv = argv
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="template_speech_recognition_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def base(sp):
        sp.add_argument("--corpus", default="synthetic", help="synthetic | timit:<root>")
        sp.add_argument("--config", default=None, help="JSON PipelineConfig")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default=None,
                        help="cuda (default; raises without a GPU) or cpu")

    t = sub.add_parser("train", help="train a template bank (config 3)")
    base(t)
    t.add_argument("--phones", required=True, help="comma-separated classes")
    t.add_argument("--bank", required=True, help="output bank .npz")
    t.add_argument("--components", type=int, default=None,
                   help="mixture components per class")
    t.add_argument("--parts", type=int, default=0,
                   help="build the bank over N-part coded features")
    t.set_defaults(fn=cmd_train)

    def common(sp):
        base(sp)
        sp.add_argument("--bank", required=True, help="bank .npz")
        sp.add_argument("--phone", required=True, help="target phone for labels")
        sp.add_argument("--dtw-rescore", action="store_true",
                        help="config 4: DTW-rescore the top-K peaks")
        sp.add_argument("--exact", action="store_true",
                        help="int32 fixed-point scoring (bit-parity path)")
        sp.add_argument("--score-backend", default=None,
                        choices=["conv", "fft", "pallas"],
                        help="scoring kernel (fft = frequency-domain fast path)")
        sp.add_argument("--manifest", default=None,
                        help="scan-manifest directory: crash-tolerant "
                             "resumable corpus scan")

    d = sub.add_parser("detect", help="scan a corpus (configs 1-2, 4)")
    common(d)
    d.add_argument("--out", default=None, help="detections .npz path")
    d.add_argument("--dtw-top-r", type=int, default=None,
                   help="DTW rescore scope: 0 exhaustive, 1 verify-the-winner "
                        "(the config default; constant in bank size)")
    d.add_argument("--int8-spectra", action="store_true",
                   help="int8-quantized template spectra (config-5 bank "
                        "scale; half the W2 stream)")
    d.set_defaults(fn=cmd_detect)

    e = sub.add_parser("evaluate", help="ROC / EER over a corpus scan")
    common(e)
    e.add_argument("--artifacts", default=None,
                   help="directory for roc.npz / detections.npz / "
                        "metrics.json artifacts")
    e.add_argument("--tensorboard", default=None,
                   help="directory for tensorboard scalars (ROC, EER)")
    e.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser("classify", help="isolated-segment classification")
    base(c)
    c.add_argument("--bank", required=True, help="bank .npz")
    c.add_argument("--phone", default=None, help="unused; kept for symmetry")
    c.add_argument("--dtw", action="store_true", help="DTW-aligned scoring")
    c.set_defaults(fn=cmd_classify)

    b = sub.add_parser("bench", help="run the scoring benchmark")
    b.add_argument("--bench-script", default=BENCH_SCRIPT)
    b.add_argument("--device", default=None,
                   help="cuda (default; the script exits 2 without a GPU) or cpu")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device is None or str(args.device).startswith("cuda"):
        from template_speech_recognition_tpu_torch.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
