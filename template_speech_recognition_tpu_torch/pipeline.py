"""Corpus detection and evaluation.

Counterpart of ``template_speech_recognition_tpu.pipeline``:

* ``detect_corpus`` -- the router: the streaming batch scan
  (``scan.detect_corpus_stream``) for the ``fft`` and ``conv`` scorers,
  the per-utterance loop below for exact int32 scores and for
  ``score_backend="pallas"``;
* ``_detect_corpus_loop`` -- per utterance: frontend -> scores (the FFT
  scorer, the f32 ``sliding_scores``, or int32 ``sliding_scores_int``
  divided by ``quant_scale``) -> masking -> NMS top-K [-> DTW rescore];
* ``evaluate_detections`` -- ROC / EER against the labels.

As in the reference, ``pallas`` scores the loop with the f32 conv
``sliding_scores``: the correlation kernel is reached through
``detect.scorer.sliding_scores_backend(backend="pallas")``.  The port's
``TemplateBank`` has no parts-coded form (``TemplateBank.load`` refuses
one), so the loop serves raw-edge banks.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from template_speech_recognition_tpu_torch.config import PipelineConfig
from template_speech_recognition_tpu_torch.detect import evaluate as ev
from template_speech_recognition_tpu_torch.detect.fft_scorer import (
    build_fft_bank,
    fft_sliding_scores,
)
from template_speech_recognition_tpu_torch.detect.nms import top_detections
from template_speech_recognition_tpu_torch.detect.scorer import (
    masked_scores,
    sliding_scores,
    sliding_scores_int,
)
from template_speech_recognition_tpu_torch.frontend import frontend_batch_flat
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat
from template_speech_recognition_tpu_torch.scan import (
    CorpusDetections,
    bucket_length,
    detect_corpus_stream,
    dtw_rescore_batched,
)
from template_speech_recognition_tpu_torch.utils.metrics import StageCounters


def dtw_rescore_detections(binary_map, valid_frames, scores, times, w_rows, c_rows,
                           m_seg: int, band: int, ids, top_r: int = 0):
    """Config 4 for one utterance: re-score its top-K peaks [P] with
    banded DTW over segments of up to ``m_seg`` frames of the flat map
    [T', D]; returns (scores [P], template ids [P]); empty slots stay
    -inf.  ``top_r=1`` rescores each peak against its winner only, on
    f32 filters at full precision on every device (the gathered route),
    as the reference's loop does; only the stream takes bf16 filters."""
    s, k = dtw_rescore_batched(
        binary_map[None], valid_frames.reshape(1), scores[None], times[None], ids[None],
        w_rows, c_rows, m_seg, band, top_r=top_r, route="gathered",
    )
    return s[0], k[0]


def detect_corpus(
    corpus,
    bank: TemplateBank,
    cfg: PipelineConfig,
    target_phone: str | None = None,
    manifest=None,
) -> CorpusDetections:
    """Scan every utterance with the bank; fixed top-K detections per
    utterance; labels for ``target_phone``.  The streaming batch scan
    serves the ``fft`` and ``conv`` scorers; exact int32 scores and
    the ``pallas`` backend run the per-utterance loop."""
    if manifest is not None:
        raise NotImplementedError(
            "manifest: scan resume is not ported yet (ROADMAP.md Queue 1, "
            "item 2, 'Manifest resume')"
        )
    dcfg = cfg.detect
    if not dcfg.exact_scores and dcfg.score_backend in ("fft", "conv"):
        return detect_corpus_stream(corpus, bank, cfg, target_phone)
    return _detect_corpus_loop(corpus, bank, cfg, target_phone)


def _detect_corpus_loop(
    corpus,
    bank: TemplateBank,
    cfg: PipelineConfig,
    target_phone: str | None = None,
) -> CorpusDetections:
    """Per-utterance scan (exact int32 and pallas-conv paths) on the
    bank's device.  Features and filters are flat channel-major
    (``ops.layout``), as in the reference's conv and FFT branches."""
    stats = StageCounters()
    fcfg, dcfg = cfg.frontend, cfg.detect
    dev = bank.device
    if dcfg.exact_scores:
        # int32 fixed point: order-independent modular arithmetic, so
        # the scores are bit-identical to the oracle's sliding_score_int
        w_int, c_int = bank.llr_quantized(dcfg.quant_scale)
        w_int = filters_to_flat(w_int)
    w, c = bank.llr()
    w_flat = filters_to_flat(w)
    fft_bank = None
    if dcfg.score_backend == "fft" and not dcfg.exact_scores:
        fft_bank = build_fft_bank(w_flat, c)
    if dcfg.dtw_rescore:
        w_rows, c_rows = bank.llr_rows()
        w_rows = filters_to_flat(w_rows)
    per_utt, labels, utt_ids = [], [], []
    total_samples = 0
    stats.start("scan")
    for utt_id, wav, phones in corpus.iter_utterances():
        total_samples += len(wav)
        pad = bucket_length(len(wav))
        buf = torch.zeros((1, pad), dtype=torch.float32)
        buf[0, : len(wav)] = torch.from_numpy(np.asarray(wav, np.float32))
        nv = torch.tensor([len(wav)], dtype=torch.int32)
        with record_function("frontend"):
            fm = frontend_batch_flat(buf.to(dev), nv.to(dev), fcfg)
        feat_map = fm.binary[0, : fcfg.num_feature_frames(pad)]      # [T', D]
        valid = fm.valid_frames[0]
        nf = ((len(wav) - fcfg.frame_length) // fcfg.hop_length
              if len(wav) >= fcfg.frame_length else 0)
        stats.add("frames", float(nf))
        with record_function("score"):
            if dcfg.exact_scores:
                scores = sliding_scores_int(feat_map, w_int, c_int)
                scores = scores.to(torch.float32) / float(dcfg.quant_scale)
            elif fft_bank is not None:
                # time-major end to end, untrimmed: padded window starts
                # are masked like any other invalid start
                scores = fft_sliding_scores(feat_map[None], fft_bank,
                                            time_major=True, trim=False)[0]
            else:
                scores = sliding_scores(feat_map, w_flat, c)
            scores = masked_scores(scores, valid, bank.template_length,
                                   time_major=fft_bank is not None)
        stats.add("windows_scored", float(nf) * bank.num_templates)
        with record_function("nms"):
            s, t, k = top_detections(
                scores, dcfg.nms_radius, dcfg.effective_top_k(pad, fcfg.sample_rate),
                time_major=fft_bank is not None,
            )
        if dcfg.dtw_rescore:
            with record_function("dtw"):
                s, k = dtw_rescore_detections(
                    feat_map, valid, s, t, w_rows, c_rows,
                    bank.template_length + cfg.dtw.band, cfg.dtw.band,
                    ids=k, top_r=cfg.dtw.top_r,
                )
        per_utt.append((s.cpu().numpy(), t.cpu().numpy(), k.cpu().numpy()))
        if target_phone is not None:
            labels.append(np.asarray(
                [s0 // fcfg.hop_length for (ph, s0, _e) in phones if ph == target_phone],
                dtype=np.int64,
            ))
        else:
            labels.append(np.zeros(0, np.int64))
        utt_ids.append(utt_id)
    dets = ev.DetectionSet.from_per_utterance(per_utt)
    stats.stop("scan")
    stats.add("utterances", float(len(utt_ids)))
    stats.add("audio_seconds", total_samples / corpus.sample_rate)
    stats.add("detections", float(len(dets.scores)))
    counters = stats.to_dict()
    counters["audio_s_per_s"] = stats.rate("audio_seconds", "scan")
    stats.log("detect_corpus ")
    return CorpusDetections(
        dets, labels, total_samples / corpus.sample_rate, utt_ids, counters
    )


def evaluate_detections(
    result: CorpusDetections,
    tolerance: int,
    template_mask: np.ndarray | None = None,
) -> dict[str, float | np.ndarray]:
    """ROC / EER over a corpus scan (host-side).

    ``template_mask``: optional bool array over template ids; with a
    multi-class bank, pass ``[lbl == phone for lbl in bank.labels]`` to
    keep only the target class's detections (otherwise every
    foreign-class peak counts as a false positive of the target).
    """
    dets = result.detections
    if template_mask is not None:
        keep = np.asarray(template_mask, dtype=bool)[
            np.asarray(dets.template_ids, dtype=np.int64)]
        dets = ev.DetectionSet(
            dets.scores[keep], dets.times[keep],
            dets.template_ids[keep], dets.utterance_ids[keep],
        )
    is_tp, num_labels = ev.match_detection_set(
        dets, result.labels_per_utterance, tolerance
    )
    thr, tpr, fps = ev.roc_curve(
        dets.scores, is_tp, num_labels, result.audio_seconds
    )
    return {
        "num_detections": float(len(dets.scores)),
        "num_labels": float(num_labels),
        "thresholds": thr,
        "tpr": tpr,
        "fp_per_sec": fps,
        "eer": ev.eer(tpr, fps),
        "best_tpr": float(tpr.max()) if len(tpr) else 0.0,
    }
