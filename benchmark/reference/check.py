"""The check of a window: the reference worked out for every utterance
that the window scanned, and the judge's numbers.

It takes from the run the waveforms and the bank's probabilities that
the benchmark made and handed to the program, and the detections that
the program returned; it imports nothing of the program.  Each distinct
waveform is scored once, and every scan of it judged against that.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.reference import control as ctl
from benchmark.reference.frontend import edge_map
from benchmark.reference.judge import utterance_gaps, verdict
from benchmark.reference.score import interval_scores, llr_rows, sliding_scores

QUANTUM = 16384


def top_k_of(n_samples: int, detect: dict, sample_rate: int) -> int:
    """The detections a scan returns for an utterance of ``n_samples``:
    ``max(top_k, ceil(bucket seconds x top_k_per_second))``, the bucket
    being the length rounded up to 16,384 samples."""
    pad = max(QUANTUM, -(-n_samples // QUANTUM) * QUANTUM)
    if detect["top_k_per_second"] <= 0:
        return detect["top_k"]
    return max(detect["top_k"], int(math.ceil(pad / sample_rate * detect["top_k_per_second"])))


def split_detections(dets, n_utts: int, top_k: list[int]):
    """A ``DetectionSet`` (utterance ids ascending) -> per utterance
    (scores, times, ids), padded to its ``top_k`` with -inf."""
    uids = np.asarray(dets.utterance_ids)
    bounds = np.searchsorted(uids, np.arange(n_utts + 1))
    out = []
    for i in range(n_utts):
        a, b = bounds[i], bounds[i + 1]
        k = max(top_k[i], b - a)
        s = np.full(k, -np.inf, np.float32)
        t = np.zeros(k, np.int64)
        kid = np.zeros(k, np.int64)
        s[: b - a] = dets.scores[a:b]
        t[: b - a] = dets.times[a:b]
        kid[: b - a] = dets.template_ids[a:b]
        out.append((s, t, kid))
    return out


def judge_window(*, pool, fed, dets, templates, background, config: dict, mix: dict,
                 limits: dict, reference_bits: int | None = None) -> dict:
    """The verdict on a window's detections (``reference.judge``) under
    the cell's ``limits``; with ``reference_bits`` the detections judged
    are the reference's own at that precision (``reference.control``)."""
    t_start = time.perf_counter()
    fcfg = config["pipeline"]["frontend"]
    detect = config["pipeline"]["detect"]
    sr = mix["sample_rate"]
    top_k = [top_k_of(len(pool[fed[i]]), detect, sr) for i in range(len(fed))]
    per_utt = split_detections(dets, len(fed), top_k)
    by_item: dict[int, list[int]] = {}
    for i, item in enumerate(fed):
        by_item.setdefault(item, []).append(i)
    wt, c = llr_rows(templates, background)
    wq = ctl.quantized_rows(wt.clone(), reference_bits) if reference_bits else None
    dev = templates.device
    gaps, scale = [], 0.0
    n_amb = 0
    for item, scans in sorted(by_item.items()):
        wave = torch.from_numpy(pool[item]).to(dev)
        lo, amb = edge_map(wave, fcfg, config["check"]["delta"])
        lo, amb = lo.reshape(lo.shape[0], -1), amb.reshape(amb.shape[0], -1)
        n_amb += int(amb.sum())
        s_lo, s_hi = interval_scores(lo, amb, wt, c)
        scale = max(scale, float(s_lo.abs().amax()), float(s_hi.abs().amax()))
        k = top_k[scans[0]]
        if wq is not None:
            one = ctl.top_detections(sliding_scores(lo, wq, c), detect["nms_radius"], k)
            rows = [one for _ in scans]
        else:
            rows = [per_utt[i] for i in scans]
        width = max(len(r[0]) for r in rows)
        dets_np = tuple(np.stack([np.pad(r[j], (0, width - len(r[j])),
                                         constant_values=(-np.inf if j == 0 else 0))
                                  for r in rows]) for j in range(3))
        gaps.append(utterance_gaps(s_lo, s_hi, dets_np, k, detect["nms_radius"]).cpu().numpy())
        del s_lo, s_hi, lo, amb
    gaps = np.concatenate(gaps) if gaps else np.zeros((0, 11))
    out = verdict(gaps, scale, limits)
    out.update(judged=len(fed), distinct=len(by_item), scale=scale,
               ambiguous_cells=n_amb, seconds=time.perf_counter() - t_start)
    return out
