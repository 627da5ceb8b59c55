"""Multi-class segment classification.

Counterpart of ``template_speech_recognition_tpu.detect.classify``: a
padded batch of segments [B, M_pad, F, E] with valid lengths is scored
against every template of the bank at once, then each segment takes the
class of its best template.  Per (segment, template) pair:

* sliding (the default): ``seg_len >= L``: the best window score
  ``max_t sliding_score(segment, W_k, c_k)`` over the valid starts (the
  f32 ``sliding_scores_batch`` over the padded batch, ``masked_scores``
  with each row's length, a max); ``seg_len < L``: the segment
  registered to L rows (the nearest-neighbour map of
  ``models.template.register_exemplars``) and scored by one dot
  product.  Both are computed and selected per segment;
* DTW (``use_dtw``): ``align.dtw.dtw_keyword_scores_batch`` on the
  bank's per-row filter, which on the card is the banded DTW kernel
  (``ops.dtw_kernel``, from the LLR tile to the score); out-of-band pairs
  score -inf.

The sliding products and the DTW route's LLR GEMM are XLA operations in
the reference, outside any Pallas kernel: here they are ``conv1d`` and
``matmul`` in full float32 (TF32 off, ``utils.precision.full_fp32``).
Ties between classes break toward the lower class id, the classes in
sorted-name order, as the reference's ``argmax``.
"""

from __future__ import annotations

import numpy as np
import torch

from template_speech_recognition_tpu_torch.align.dtw import dtw_keyword_scores_batch
from template_speech_recognition_tpu_torch.detect.scorer import (
    masked_scores,
    sliding_scores_batch,
)
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.utils.precision import full_fp32


def _register_to_length(segments: torch.Tensor, seg_lens: torch.Tensor,
                        length: int) -> torch.Tensor:
    """[B, M_pad, ...] -> [B, L, ...]: each valid prefix resampled to
    ``length`` rows, row i from row ``i * seg_len // length``."""
    idx = (torch.arange(length, device=segments.device)[None, :]
           * seg_lens.to(torch.int64)[:, None]) // length                  # [B, L]
    rows = torch.arange(segments.shape[0], device=segments.device)[:, None]
    return segments[rows, idx]


def _pair_scores_sliding(segments: torch.Tensor, seg_lens: torch.Tensor,
                         w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, M_pad, F, E] float32, [B] lengths, W [K, L, F, E], c [K] ->
    [B, K]: the best window score, or the registered dot product where
    the segment is shorter than L."""
    b, m_pad = segments.shape[0], segments.shape[1]
    k, length = w.shape[0], w.shape[1]
    c = c.to(torch.float32)
    with full_fp32():
        reg = _register_to_length(segments, seg_lens, length).reshape(b, -1)
        reg_score = reg @ w.reshape(k, -1).to(torch.float32).T + c[None]
        if m_pad < length:       # no segment has a whole window
            return reg_score
        scores = sliding_scores_batch(segments, w, c)                     # [B, K, T'']
    best = masked_scores(scores, seg_lens, length).amax(dim=-1)
    return torch.where((seg_lens < length)[:, None], reg_score, best)


def _per_class_best(pair_scores: torch.Tensor, class_ids: torch.Tensor,
                    num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, K] x [K] -> (best class [B], best score per class [B, C]);
    ties go to the lower class id (``argmax`` takes the first maximum)."""
    onehot = class_ids[None, :] == torch.arange(num_classes, device=class_ids.device)[:, None]
    per_class = torch.where(onehot[None], pair_scores[:, None, :],
                            float("-inf")).amax(dim=-1)                   # [B, C]
    return torch.argmax(per_class, dim=-1), per_class


def classify_segments(segments, seg_lens, bank: TemplateBank, use_dtw: bool = False,
                      band: int = 6, plain: bool = False) -> tuple[list[str], np.ndarray]:
    """Classify a padded batch [B, M_pad, F, E] (array or tensor, any
    dtype) with valid lengths [B] (1 <= seg_len <= M_pad) on the bank's
    device -> (predicted class names, best score per class [B, C]), the
    classes in sorted-name order (``sorted(set(bank.labels))``).
    ``plain=True`` runs the DTW kernel's plain version (the sliding route
    runs no kernel of the port)."""
    dev = bank.device
    classes = sorted(set(bank.labels))
    class_ids = torch.tensor([classes.index(lbl) for lbl in bank.labels], device=dev)
    segs = torch.as_tensor(segments).to(device=dev, dtype=torch.float32)
    lens = torch.as_tensor(seg_lens).to(device=dev, dtype=torch.int32)
    if use_dtw:
        w, c_rows = bank.llr_rows()
        with full_fp32():
            pair = dtw_keyword_scores_batch(segs, lens, w, c_rows, band, plain=plain)
    else:
        w, c = bank.llr()
        pair = _pair_scores_sliding(segs, lens, w, c)
    pred, per_class = _per_class_best(pair, class_ids, len(classes))
    return [classes[int(i)] for i in pred.cpu()], per_class.cpu().numpy()


def pad_segments(segments: list[np.ndarray],
                 pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length [M_i, F, E] maps into a zero-padded float32
    batch [B, M_pad, F, E] and their lengths [B] int32 (cut to
    ``pad_to`` where given)."""
    m_pad = pad_to or max(s.shape[0] for s in segments)
    out = np.zeros((len(segments), m_pad) + segments[0].shape[1:], np.float32)
    lens = np.zeros(len(segments), np.int32)
    for i, s in enumerate(segments):
        m = min(s.shape[0], m_pad)
        out[i, :m] = s[:m]
        lens[i] = m
    return out, lens
