"""Sliding-window LLR correlation and score masking.

Counterpart of ``template_speech_recognition_tpu.detect.scorer``:

    scores[k, t] = sum_{tau, f, e} W[k, tau, f, e] X[t + tau, f, e] + c[k]

a valid cross-correlation over time with full (F, E) support, i.e. a
1-D convolution with D = F*E input channels and K output channels.

* ``sliding_scores`` / ``_batch`` / ``_blockwise``: float32 by default,
  through ``torch.nn.functional.conv1d`` with TF32 off (the reference
  runs its XLA conv at HIGHEST precision, outside any Pallas kernel).
  A ``compute_dtype`` of bfloat16 rounds both operands to bf16 and
  still sums in float32, as the reference's bf16 conv with f32 output.
* ``sliding_scores_int``: int32 modular arithmetic, bitwise equal to
  ``oracle.score.sliding_score_int``.
* ``sliding_scores_backend``: ``fft`` (``detect.fft_scorer``), ``conv``
  and ``pallas`` -- the hand-written correlation kernel
  (``ops.correlation_kernel``) on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from template_speech_recognition_tpu_torch.detect.fft_scorer import (
    build_fft_bank,
    fft_sliding_scores,
)
from template_speech_recognition_tpu_torch.ops.correlation_kernel import (
    correlation_scores,
)
from template_speech_recognition_tpu_torch.utils.precision import full_fp32 as _full_fp32

# float64 represents every integer below 2**53 exactly
_EXACT_F64 = 2**53


def _conv_input(feats: torch.Tensor, d: int, compute_dtype) -> torch.Tensor:
    """feats [B, T, ...] -> conv1d's input [B, D, T], rounded to
    ``compute_dtype`` and held in float32."""
    b, t = feats.shape[0], feats.shape[1]
    return feats.reshape(b, t, d).to(compute_dtype).to(torch.float32).transpose(1, 2)


def _conv_weight(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """W [K, L, ...] (trailing dims flattened in the feature map's order,
    ``ops.layout``) -> conv1d's weight [K, D, L], as ``_conv_input``."""
    k, length = w.shape[0], w.shape[1]
    wk = w.reshape(k, length, -1).to(compute_dtype).to(torch.float32)
    return wk.transpose(1, 2).contiguous()


def _conv(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    with _full_fp32():
        return F.conv1d(x, wk)


def sliding_scores_batch(feats, w, c, compute_dtype=torch.float32) -> torch.Tensor:
    """feats [B, T', F, E] (or pre-flattened [B, T', D]), W [K, L, F, E]
    (or [K, L, D]), c [K] -> [B, K, T'-L+1] float32, one batched conv.
    Scores at window starts overlapping padded rows are garbage by
    construction; ``masked_scores`` fills them."""
    wk = _conv_weight(w, compute_dtype)
    out = _conv(_conv_input(feats, wk.shape[1], compute_dtype), wk)
    return out + c.to(torch.float32)[None, :, None]


def sliding_scores(feats, w, c, compute_dtype=torch.float32) -> torch.Tensor:
    """feats [T', F, E] (or [T', D]) -> [K, T'-L+1]; per-utterance twin
    of ``sliding_scores_batch``."""
    return sliding_scores_batch(feats[None], w, c, compute_dtype)[0]


def sliding_scores_int(feats, w_int, c_int) -> torch.Tensor:
    """Exact int32 path: binary feats [T', F, E] (or [T', D]), W_int
    [K, L, F, E] (or [K, L, D]) int32, c_int [K] int32 -> [K, T'-L+1]
    int32, bitwise equal to ``oracle.score.sliding_score_int``.

    int32 addition is modular, so any order of the same terms gives the
    same bits.  PyTorch has no int32 matmul on CUDA, and the reference's
    unfold ([T'', L*D] int32, ~0.78 GB for a 30 s utterance at D = 2048)
    is not needed: the sum over tau of ``X[tau : tau + T''] @
    W[:, tau]^T`` runs in float64, where with |x| <= 1 and |w| < 2**31
    every partial sum of the L*D terms is an integer of magnitude below
    L*D * 2**31 <= 2**53 (checked), hence exact in any order; the int64
    total plus c, wrapped to 32 bits, is the modular int32 result."""
    k, length = w_int.shape[0], w_int.shape[1]
    t = feats.shape[0]
    d = int(np.prod(w_int.shape[2:]))
    if length * d * 2**31 > _EXACT_F64:
        raise ValueError(f"L*D = {length * d} terms can exceed 2**53 in float64")
    x = feats.reshape(t, d)
    if x.dtype != torch.bool and bool((x.abs() > 1).any()):
        raise ValueError("sliding_scores_int takes binary features (|x| <= 1)")
    x = x.to(torch.float64)
    wf = w_int.reshape(k, length, d).to(torch.float64)
    tv = t - length + 1
    acc = x[:tv] @ wf[:, 0].T
    for tau in range(1, length):
        acc += x[tau : tau + tv] @ wf[:, tau].T                  # [T'', K]
    total = acc.T.to(torch.int64) + c_int.to(torch.int64)[:, None]
    return (torch.remainder(total + 2**31, 2**32) - 2**31).to(torch.int32)


def sliding_scores_blockwise(feats, w, c, block_t: int = 512,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """Streaming twin of ``sliding_scores`` for long audio: T in
    ``block_t``-frame chunks, each extended by the next chunk's first
    L-1 frames (zeros past the end), so the live conv input is
    O(block_t * D) instead of O(T * D).  Output [K, T'-L+1] equals
    ``sliding_scores`` (the same per-window conv)."""
    t = feats.shape[0]
    k, length = w.shape[0], w.shape[1]
    if length - 1 > block_t:
        raise ValueError(
            f"template length {length} needs halo {length - 1} > "
            f"block_t {block_t}; raise block_t"
        )
    d = int(np.prod(w.shape[2:]))
    x = feats.reshape(t, d)
    wk = _conv_weight(w, compute_dtype)
    blocks = []
    for s in range(0, t, block_t):
        ext = x[s : s + block_t + length - 1]
        ext = F.pad(ext.to(compute_dtype).to(torch.float32),
                    (0, 0, 0, block_t + length - 1 - ext.shape[0]))
        blocks.append(_conv(ext.T[None], wk)[0])                 # [K, block_t]
    scores = torch.cat(blocks, dim=1)
    return scores[:, : t - length + 1] + c.to(torch.float32)[:, None]


def sliding_scores_backend(feats, w, c, backend: str = "conv",
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Backend-selectable scorer: feats [T', F, E], W [K, L, F, E], c
    [K] -> [K, T'-L+1] float32.

    ``fft``: the overlap-save FFT scorer (``detect.fft_scorer``), its
    bank built per call.  ``conv``: ``sliding_scores`` on operands
    rounded to ``compute_dtype``.  ``pallas``: the correlation kernel
    (``ops.correlation_kernel``), which on the card takes bf16 operands
    only; on CPU tensors its plain float32 version on operands rounded
    to ``compute_dtype``.  All three return one layout."""
    if backend == "fft":
        bank = build_fft_bank(w, c, mm_dtype=compute_dtype)
        return fft_sliding_scores(feats[None], bank)[0]
    if backend == "conv":
        return sliding_scores(feats, w, c, compute_dtype=compute_dtype)
    if backend != "pallas":
        raise ValueError(f"unknown scoring backend {backend!r}")
    t = feats.shape[0]
    k, length = w.shape[0], w.shape[1]
    d = int(np.prod(w.shape[2:]))
    x = feats.reshape(1, t, d).to(compute_dtype).contiguous()
    wk = w.reshape(k, length, d).to(compute_dtype).contiguous()
    return correlation_scores(x, wk, c.to(torch.float32).contiguous())[0]


def masked_scores(
    scores: torch.Tensor,
    valid_frames: torch.Tensor,
    template_length: int,
    fill: float = float("-inf"),
    time_major: bool = False,
) -> torch.Tensor:
    """``fill`` where the window overruns the valid region.

    Valid window starts: t <= valid_frames - template_length.  One
    utterance: scores [K, T''] (or [T'', K] with ``time_major``) and a
    scalar valid; batched: scores [B, K, T''] (or [B, T'', K]) and valid
    [B].
    """
    t_axis = -2 if time_major else -1
    n_win = scores.shape[t_axis]
    t_idx = torch.arange(n_win, device=scores.device, dtype=torch.int32)
    limit = torch.as_tensor(valid_frames, device=scores.device).to(torch.int32)
    ok = t_idx <= (limit - template_length)[..., None]       # [(B,) T'']
    if time_major:
        ok = ok[..., None]
    elif ok.dim() == 2:
        ok = ok[:, None, :]
    return torch.where(ok, scores, torch.full_like(scores, fill))
