"""CLI of the port: the ``detect`` subcommand.

    python -m template_speech_recognition_tpu_torch detect \\
        --corpus synthetic --bank bank.npz --phone aa --out dets.npz

``--bank`` is the ``.npz`` that ``TemplateBank.save`` writes.  The flags
and the one JSON line printed match the reference's ``detect``,
including ``--dtw-rescore`` (config 4), ``--dtw-top-r`` and
``--int8-spectra``; ``--exact``, ``--score-backend`` and ``--manifest``
are not ported yet, and the other subcommands are later work
(ROADMAP.md Queue 1, item 10).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _build_corpus(spec: str, seed: int):
    if spec == "synthetic":
        from oracle.fixtures import make_synthetic_corpus

        from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter

        return SyntheticAdapter(
            make_synthetic_corpus(
                num_utterances=6, phones_per_utterance=5, seed=seed
            )
        )
    raise SystemExit(
        f"unknown corpus spec {spec!r} (synthetic; TIMIT input is not "
        "ported yet)"
    )


def _load_config(args):
    from template_speech_recognition_tpu_torch import config as C

    if args.config:
        with open(args.config) as f:
            cfg = C.from_json(f.read())
    else:
        cfg = C.PipelineConfig()
    if args.dtw_rescore:
        cfg = C.override(cfg, detect=C.override(cfg.detect, dtw_rescore=True))
    if args.dtw_top_r is not None:
        cfg = C.override(cfg, dtw=C.override(cfg.dtw, top_r=args.dtw_top_r))
    if args.int8_spectra:
        cfg = C.override(cfg, detect=C.override(cfg.detect, int8_spectra=True))
    return cfg


def cmd_detect(args) -> int:
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank
    from template_speech_recognition_tpu_torch.scan import detect_corpus_stream

    cfg = _load_config(args)
    corpus = _build_corpus(args.corpus, args.seed)
    bank = TemplateBank.load(args.bank, device=args.device)
    result = detect_corpus_stream(corpus, bank, cfg, target_phone=args.phone)
    d = result.detections
    if args.out:
        np.savez(
            args.out,
            scores=d.scores,
            times=d.times,
            template_ids=d.template_ids,
            utterance_ids=d.utterance_ids,
        )
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="template_speech_recognition_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("detect", help="scan a corpus (configs 1-2, 4)")
    d.add_argument("--corpus", default="synthetic", help="synthetic")
    d.add_argument("--config", default=None, help="JSON PipelineConfig")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--bank", required=True, help="bank .npz")
    d.add_argument("--phone", required=True, help="target phone for labels")
    d.add_argument("--out", default=None, help="detections .npz path")
    d.add_argument("--dtw-top-r", type=int, default=None,
                   help="DTW rescore scope: 0 exhaustive, 1 verify-the-winner "
                        "(the config default; constant in bank size)")
    d.add_argument("--dtw-rescore", action="store_true",
                   help="config 4: DTW-rescore the top-K peaks")
    d.add_argument("--int8-spectra", action="store_true",
                   help="int8-quantized template spectra (config-5 bank "
                        "scale; half the W2 stream)")
    d.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    d.set_defaults(fn=cmd_detect)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
