"""Training, corpus detection and evaluation.

Counterpart of ``template_speech_recognition_tpu.pipeline``:

* ``train_bank`` -- config 3: exemplar clips -> the batched frontend
  (``_clip_feature_maps``) [-> a part dictionary and part-coded maps,
  ``_code_map_list``] -> registered stacks -> a template, or a
  Bernoulli mixture by EM with restarts, per class -> background ->
  ``TemplateBank``;
* ``detect_corpus`` -- the router: the streaming batch scan
  (``scan.detect_corpus_stream``) for the ``fft`` and ``conv`` scorers
  on raw-edge banks, the per-utterance loop below for exact int32
  scores, ``score_backend="pallas"`` and parts-coded banks;
* ``_detect_corpus_loop`` -- per utterance: frontend [-> part codes]
  -> scores (the FFT scorer, the f32 ``sliding_scores``, or int32
  ``sliding_scores_int`` divided by ``quant_scale``) -> masking -> NMS
  top-K [-> DTW rescore];
* ``evaluate_detections`` -- ROC / EER against the labels.

As in the reference, ``pallas`` scores the loop with the f32 conv
``sliding_scores``: the correlation kernel is reached through
``detect.scorer.sliding_scores_backend(backend="pallas")``.  A
parts-coded bank scores its part maps channels-last ([T', F', J]
flattened in that order, filters alike) with the f32 conv or the int32
scorer: no FFT bank, no flat layout.
"""

from __future__ import annotations

import numpy as np
import torch

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
from template_speech_recognition_tpu_torch.frontend import frontend_batch, frontend_batch_flat
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.models.mixture import (
    bernoulli_mixture_em,
    bernoulli_mixture_em_restarts,
)
from template_speech_recognition_tpu_torch.models.parts import (
    code_parts,
    code_parts_batch,
    learn_parts,
)
from template_speech_recognition_tpu_torch.models.template import (
    estimate_background,
    estimate_template,
    register_exemplars,
)
from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat, flat_to_channels
from template_speech_recognition_tpu_torch.scan import (
    CorpusDetections,
    bucket_length,
    detect_corpus_stream,
    dtw_rescore_batched,
)
from template_speech_recognition_tpu_torch.utils.device import resolve_device
from template_speech_recognition_tpu_torch.utils.metrics import StageCounters
from template_speech_recognition_tpu_torch.utils.profiling import named_scope


def _clip_feature_maps(clips, cfg: PipelineConfig, device=None, batch: int = 128,
                       plain: bool = False):
    """Frontend over variable-length clips -> (stack [N, T', F', 8] bool
    on ``device``, valid frames [N] int64 numpy).

    Clips run through the batched frontend ``batch`` at a time, all
    padded to one length (the reference's shapes: the last chunk is
    filled with rows of 0 valid samples, which are dropped, as are
    clips shorter than one frame).  Rows past a map's valid frames are
    False, so the stack is the reference's list of maps padded with
    zeros.  ``plain=True`` runs the kernels' plain versions."""
    stack, lengths, _kept = _clip_maps_kept(clips, cfg, device, batch, plain)
    return stack, lengths


def _clip_maps_kept(clips, cfg: PipelineConfig, device=None, batch: int = 128,
                    plain: bool = False):
    """``_clip_feature_maps`` -> (stack, valid frames, the indices into
    ``clips`` of the maps kept [N] int64 numpy)."""
    fcfg = cfg.frontend
    dev = resolve_device(device)
    min_len = fcfg.frame_length + fcfg.hop_length  # >= 1 feature frame
    usable = np.asarray([i for i, c in enumerate(clips) if len(c) >= min_len], np.int64)
    if not len(usable):
        raise ValueError("no usable clips (all shorter than one frame)")
    pad = bucket_length(max(len(clips[i]) for i in usable), quantum=4096)
    stacks, lengths, kept = [], [], []
    for i0 in range(0, len(usable), batch):
        chunk = usable[i0 : i0 + batch]
        wavs = np.zeros((batch, pad), np.float32)
        vs = np.zeros((batch,), np.int32)
        for r, ci in enumerate(chunk):
            wavs[r, : len(clips[ci])] = clips[ci]
            vs[r] = len(clips[ci])
        fm = frontend_batch(torch.from_numpy(wavs).to(dev), torch.from_numpy(vs).to(dev),
                            fcfg, plain=plain)
        vfs = fm.valid_frames.cpu().numpy()
        keep = np.flatnonzero(vfs >= 1)
        stacks.append(fm.binary[torch.from_numpy(keep).to(dev)])
        lengths.append(vfs[keep])
        kept.append(chunk[keep])
    return (torch.cat(stacks), np.concatenate(lengths).astype(np.int64),
            np.concatenate(kept))


def _code_map_list(stack, lengths, parts, pcfg):
    """Re-code a stack of edge maps as part-indicator maps -> (coded
    stack [N, T'', F'', J] bool, coded valid frames [N] int64 numpy):
    ``(valid - patch_time) // stride_time + 1``, at least 1; rows past
    them are False, as in the reference's re-padded list."""
    new_lengths = np.maximum(
        (np.asarray(lengths) - pcfg.patch_time) // pcfg.stride_time + 1, 1
    ).astype(np.int64)
    coded = code_parts_batch(stack, parts, pcfg.loglik_threshold, pcfg.stride_time,
                             pcfg.stride_freq)[:, : int(new_lengths.max())]
    rows = torch.arange(coded.shape[1], device=coded.device)
    ok = rows[None, :] < torch.from_numpy(new_lengths).to(coded.device)[:, None]
    return coded & ok[:, :, None, None], new_lengths


def _host_maps(stack, lengths) -> list[np.ndarray]:
    """A stack on any device -> host maps, each cut to its valid frames."""
    host = stack.cpu().numpy()
    return [host[i, :ln] for i, ln in enumerate(lengths)]


def train_bank(corpus, phones: list[str], cfg: PipelineConfig, device=None) -> TemplateBank:
    """Config 3: per-phone Bernoulli templates (a mixture per phone with
    ``num_components`` > 1, from ``em_restarts`` deterministic inits)
    plus a shared background, on ``device``.  With ``cfg.parts.enabled``
    a patch dictionary is learned from the pooled exemplar maps, every
    map is re-coded, and templates and background are estimated on the
    coded maps.  Initial responsibilities are the oracle's
    ``init_responsibilities``, as in the reference."""
    from oracle.mixture import init_responsibilities

    dev = resolve_device(device)
    tcfg = cfg.template
    per_phone = {ph: _clip_feature_maps(corpus.exemplar_clips(ph), cfg, dev) for ph in phones}
    parts = None
    if cfg.parts.enabled:
        pcfg = cfg.parts
        pooled = [m for stack, ln in per_phone.values() for m in _host_maps(stack, ln)]
        parts = learn_parts(pooled, pcfg.num_parts, pcfg.patch_time, pcfg.patch_freq,
                            pcfg.num_patches, pcfg.seed, pcfg.em_iters, device=dev)
        per_phone = {ph: _code_map_list(stack, ln, parts, pcfg)
                     for ph, (stack, ln) in per_phone.items()}
    # one registered length for the whole bank, so that the templates
    # stack on one [K, L, F, E] tensor: the median over every exemplar
    target_len = tcfg.template_length or int(
        np.median(np.concatenate([ln for _, ln in per_phone.values()]))
    )
    class_templates = {}
    for phone in phones:
        stack, lengths = per_phone[phone]
        reg = register_exemplars(stack, lengths, target_len)
        if tcfg.num_components <= 1:
            class_templates[phone] = estimate_template(reg, tcfg.prob_clip_eps)
            continue
        n, k = reg.shape[0], tcfg.num_components
        x = reg.reshape(n, -1).to(torch.float32)
        em = dict(num_iters=tcfg.em_max_iters, eps=tcfg.prob_clip_eps, tol=tcfg.em_tol)
        if tcfg.em_restarts > 1:
            resps = np.stack([init_responsibilities(n, k, tcfg.em_seed + r)
                              for r in range(tcfg.em_restarts)])
            state, _best = bernoulli_mixture_em_restarts(x, resps, **em)
        else:
            state = bernoulli_mixture_em(x, init_responsibilities(n, k, tcfg.em_seed), **em)
        class_templates[phone] = state.means.reshape((k,) + tuple(reg.shape[1:]))
    bg_stack, bg_lengths = _clip_feature_maps(corpus.background_clips(phones[0]), cfg, dev)
    if parts is not None:
        bg_stack, bg_lengths = _code_map_list(bg_stack, bg_lengths, parts, cfg.parts)
    background = estimate_background(bg_stack, torch.from_numpy(bg_lengths).to(dev),
                                     tcfg.prob_clip_eps)
    return TemplateBank.from_classes(class_templates, background, parts=parts, device=dev)


def dtw_rescore_detections(binary_map, valid_frames, scores, times, w_rows, c_rows,
                           m_seg: int, band: int, ids, top_r: int = 0,
                           plain: bool = False):
    """Config 4 for one utterance: re-score its top-K peaks [P] with
    banded DTW over segments of up to ``m_seg`` frames of the flat map
    [T', D]; returns (scores [P], template ids [P]); empty slots stay
    -inf.  ``top_r=1`` rescores each peak against its winner only, on
    f32 filters at full precision on every device (the gathered route),
    as the reference's loop does; only the stream takes bf16 filters."""
    s, k = dtw_rescore_batched(
        binary_map[None], valid_frames.reshape(1), scores[None], times[None], ids[None],
        w_rows, c_rows, m_seg, band, top_r=top_r, route="gathered", plain=plain,
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
    serves the ``fft`` and ``conv`` scorers on raw-edge banks, with an
    optional ``manifest`` (``checkpoint.ScanManifest``) to resume from;
    exact int32 scores, the ``pallas`` backend and parts-coded banks run
    the per-utterance loop, which does not resume and ignores
    ``manifest``, as in the reference."""
    dcfg = cfg.detect
    if (not dcfg.exact_scores and bank.parts is None
            and dcfg.score_backend in ("fft", "conv")):
        return detect_corpus_stream(corpus, bank, cfg, target_phone, manifest)
    return _detect_corpus_loop(corpus, bank, cfg, target_phone)


def _detect_corpus_loop(
    corpus,
    bank: TemplateBank,
    cfg: PipelineConfig,
    target_phone: str | None = None,
    plain: bool = False,
) -> CorpusDetections:
    """Per-utterance scan (exact int32, pallas-conv and parts paths) on
    the bank's device.  Raw-edge features and filters are flat
    channel-major (``ops.layout``), as in the reference's conv and FFT
    branches; part maps and their filters are flattened channels-last.
    ``plain=True`` runs the kernels' plain versions."""
    stats = StageCounters()
    fcfg, dcfg, pcfg = cfg.frontend, cfg.detect, cfg.parts
    dev = bank.device
    parts = bank.parts

    def flat(w):
        # [K, L, F, E] -> [K, L, D] in the layout of the loop's maps
        return filters_to_flat(w) if parts is None else w.reshape(w.shape[:2] + (-1,))

    if dcfg.exact_scores:
        # int32 fixed point: order-independent modular arithmetic, so
        # the scores are bit-identical to the oracle's sliding_score_int
        w_int, c_int = bank.llr_quantized(dcfg.quant_scale)
        w_int = flat(w_int)
    w, c = bank.llr()
    w_flat = flat(w)
    fft_bank = None
    if dcfg.score_backend == "fft" and not dcfg.exact_scores and parts is None:
        fft_bank = build_fft_bank(w_flat, c)
    if dcfg.dtw_rescore:
        w_rows, c_rows = bank.llr_rows()
        w_rows = flat(w_rows)
    per_utt, labels, utt_ids = [], [], []
    total_samples = 0
    stats.start("scan")
    for utt_id, wav, phones in corpus.iter_utterances():
        total_samples += len(wav)
        pad = bucket_length(len(wav))
        buf = torch.zeros((1, pad), dtype=torch.float32)
        buf[0, : len(wav)] = torch.from_numpy(np.asarray(wav, np.float32))
        nv = torch.tensor([len(wav)], dtype=torch.int32)
        with named_scope("frontend"):
            fm = frontend_batch_flat(buf.to(dev), nv.to(dev), fcfg, plain=plain)
        feat_map = fm.binary[0, : fcfg.num_feature_frames(pad)]      # [T', D]
        valid = fm.valid_frames[0]
        nf = ((len(wav) - fcfg.frame_length) // fcfg.hop_length
              if len(wav) >= fcfg.frame_length else 0)
        stats.add("frames", float(nf))
        if parts is not None:
            with named_scope("parts"):
                coded = code_parts(flat_to_channels(feat_map, fcfg.feature_freqs), parts,
                                   pcfg.loglik_threshold, pcfg.stride_time,
                                   pcfg.stride_freq)                 # [T'', F'', J]
            feat_map = coded.reshape(coded.shape[0], -1)
            valid = ((valid - pcfg.patch_time) // pcfg.stride_time + 1).clamp(min=0)
            nf = max((nf - pcfg.patch_time) // pcfg.stride_time + 1, 0)
        with named_scope("score"):
            if dcfg.exact_scores:
                scores = sliding_scores_int(feat_map, w_int, c_int)
                scores = scores.to(torch.float32) / float(dcfg.quant_scale)
            elif fft_bank is not None:
                # time-major end to end, untrimmed: padded window starts
                # are masked like any other invalid start
                scores = fft_sliding_scores(feat_map[None], fft_bank,
                                            time_major=True, trim=False, plain=plain)[0]
            else:
                scores = sliding_scores(feat_map, w_flat, c)
            scores = masked_scores(scores, valid, bank.template_length,
                                   time_major=fft_bank is not None)
        stats.add("windows_scored", float(nf) * bank.num_templates)
        with named_scope("nms"):
            s, t, k = top_detections(
                scores, dcfg.nms_radius, dcfg.effective_top_k(pad, fcfg.sample_rate),
                time_major=fft_bank is not None,
            )
        if dcfg.dtw_rescore:
            with named_scope("dtw"):
                s, k = dtw_rescore_detections(
                    feat_map, valid, s, t, w_rows, c_rows,
                    bank.template_length + cfg.dtw.band, cfg.dtw.band,
                    ids=k, top_r=cfg.dtw.top_r, plain=plain,
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
