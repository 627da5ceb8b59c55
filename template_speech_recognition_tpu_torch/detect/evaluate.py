"""Detection-label matching, ROC / EER (host-side, SURVEY.md 2a).

A copy of ``template_speech_recognition_tpu.detect.evaluate``: the port
imports nothing of the JAX package.  Evaluation consumes small per-utterance detection lists, so it runs on
host in NumPy.  Semantics are identical to ``oracle.detect`` (greedy
score-desc matching, threshold sweep, interpolated EER) and are tested
for equality against it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DetectionSet:
    """Flat detections for one evaluation run."""

    scores: np.ndarray      # [M] float
    times: np.ndarray       # [M] int, frame index of window start
    template_ids: np.ndarray  # [M] int
    utterance_ids: np.ndarray  # [M] int

    @classmethod
    def from_per_utterance(cls, per_utt: list[tuple[np.ndarray, np.ndarray, np.ndarray]]):
        """per_utt: list of (scores, times, template_ids) fixed-size
        arrays; -inf slots dropped."""
        scores, times, tids, uids = [], [], [], []
        for ui, (s, t, k) in enumerate(per_utt):
            m = np.isfinite(np.asarray(s, dtype=np.float64))
            scores.append(np.asarray(s)[m])
            times.append(np.asarray(t)[m])
            tids.append(np.asarray(k)[m])
            uids.append(np.full(int(m.sum()), ui, dtype=np.int64))
        return cls(
            np.concatenate(scores) if scores else np.zeros(0),
            np.concatenate(times) if times else np.zeros(0, np.int64),
            np.concatenate(tids) if tids else np.zeros(0, np.int64),
            np.concatenate(uids) if uids else np.zeros(0, np.int64),
        )


def match_detections(
    det_times: np.ndarray,
    det_scores: np.ndarray,
    label_times: np.ndarray,
    tolerance: int,
) -> np.ndarray:
    """Greedy (score desc, time asc) one-to-one matching; bool is_tp."""
    det_times = np.asarray(det_times)
    det_scores = np.asarray(det_scores)
    label_times = np.asarray(label_times)
    order = np.lexsort((det_times, -det_scores))
    used = np.zeros(len(label_times), dtype=bool)
    is_tp = np.zeros(len(det_times), dtype=bool)
    for idx in order:
        if len(label_times) == 0:
            break
        d = np.abs(label_times - det_times[idx])
        d = np.where(used, np.iinfo(np.int64).max, d)
        j = int(np.argmin(d))
        if d[j] <= tolerance:
            used[j] = True
            is_tp[idx] = True
    return is_tp


def match_detection_set(
    dets: DetectionSet,
    labels_per_utterance: list[np.ndarray],
    tolerance: int,
) -> tuple[np.ndarray, int]:
    """Match each utterance's detections; returns (is_tp, num_labels)."""
    is_tp = np.zeros(len(dets.scores), dtype=bool)
    total_labels = 0
    for ui, labels in enumerate(labels_per_utterance):
        sel = dets.utterance_ids == ui
        total_labels += len(labels)
        if sel.any():
            is_tp[sel] = match_detections(
                dets.times[sel], dets.scores[sel], labels, tolerance
            )
    return is_tp, total_labels


def roc_curve(
    det_scores: np.ndarray,
    det_is_tp: np.ndarray,
    num_labels: int,
    audio_seconds: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threshold sweep -> (thresholds desc, tpr, fp_per_second)."""
    det_scores = np.asarray(det_scores, dtype=np.float64)
    det_is_tp = np.asarray(det_is_tp, dtype=bool)
    order = np.argsort(-det_scores, kind="stable")
    s = det_scores[order]
    tp = np.cumsum(det_is_tp[order])
    fp = np.cumsum(~det_is_tp[order])
    last = np.ones(len(s), dtype=bool)
    if len(s) > 1:
        last[:-1] = s[:-1] != s[1:]
    return (
        s[last],
        tp[last] / max(num_labels, 1),
        fp[last] / max(audio_seconds, 1e-9),
    )


def eer(tpr: np.ndarray, fp_rate: np.ndarray) -> float:
    """Equal error rate via linear interpolation (oracle-identical)."""
    tpr = np.asarray(tpr, dtype=np.float64)
    fa = np.asarray(fp_rate, dtype=np.float64)
    if fa.max() > 0:
        fa = fa / fa.max()
    miss = 1.0 - tpr
    diff = miss - fa
    idx = int(np.argmin(np.abs(diff)))
    sign_change = np.nonzero(np.diff(np.sign(diff)))[0]
    if len(sign_change):
        i = int(sign_change[0])
        d0, d1 = diff[i], diff[i + 1]
        t = 0.0 if d1 == d0 else d0 / (d0 - d1)
        return float(miss[i] + t * (miss[i + 1] - miss[i]))
    return float((miss[idx] + fa[idx]) / 2.0)
