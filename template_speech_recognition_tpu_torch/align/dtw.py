"""Banded DTW rescoring (config 4).

Counterpart of ``template_speech_recognition_tpu.align.dtw``.  The DP

    D[i, j] = cost[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

runs over the band ``|j*(L-1) - i*(M-1)| <= band*(L-1)`` (M the valid
segment length) with cost = -frame LLR, and a segment scores
``-D[L-1, M-1] / (L + M)``; an out-of-band pair scores -inf.  Every
route hands its LLR product to ``ops.dtw_kernel.banded_dtw_scores`` (one
CUDA kernel on the card: the cost, the DP and the score), with no
elementwise op of its own between them; the verify-the-winner tiles come
straight from the feature map through ``ops.pair_llr_kernel.pair_llr``.
The other products, which the reference leaves to XLA, are fp32
``torch`` products: they assume PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False``.

``plain=True`` runs the kernels' plain PyTorch versions on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from template_speech_recognition_tpu_torch.ops.dtw_kernel import (
    banded_dtw_plain,
    banded_dtw_scores,
    banded_dtw_scores_plain,
)
from template_speech_recognition_tpu_torch.ops.pair_llr_kernel import (
    pair_llr,
    pair_llr_plain,
)

# f32 cost cells per chunk of the exhaustive rescore (~256 MB)
MAX_CELLS = 64 * 1024 * 1024


def _scores_fn(plain: bool):
    return banded_dtw_scores_plain if plain else banded_dtw_scores


def banded_dtw(cost: torch.Tensor, seg_len, band: int) -> torch.Tensor:
    """cost [L, M_pad] -> D[L-1, seg_len-1] (float32 scalar), +inf
    where the terminal cell is out of band or unreachable."""
    lens = torch.as_tensor(seg_len, dtype=torch.int32, device=cost.device).reshape(1)
    total = banded_dtw_plain(cost[None], lens, band)[0]
    return torch.where(total > 1e37, float("inf"), total)


def frame_llr_matrix(segment: torch.Tensor, w: torch.Tensor,
                     c_rows: torch.Tensor) -> torch.Tensor:
    """segment [M, F, E], W [L, F, E], c_rows [L] -> LLR [L, M] (fp32)."""
    seg = segment.reshape(segment.shape[0], -1).to(torch.float32)
    wf = w.reshape(w.shape[0], -1).to(torch.float32)
    return wf @ seg.T + c_rows.to(torch.float32)[:, None]


def dtw_keyword_score(segment, seg_len, w, c_rows, band: int) -> torch.Tensor:
    """DTW match score of one (padded) segment; higher = better."""
    llr = frame_llr_matrix(segment, w, c_rows)
    total = banded_dtw(-llr, seg_len, band)
    return -total / float(w.shape[0] + int(seg_len))


def _keyword_chunk(segments, seg_lens, w, c_rows, band, plain):
    nb, m_pad = segments.shape[0], segments.shape[1]
    k, num_rows = w.shape[0], w.shape[1]
    seg = segments.reshape(nb * m_pad, -1).to(torch.float32)
    wf = w.reshape(k * num_rows, -1).to(torch.float32)
    # the GEMM's [nb, M, K, L] output, read in place as [nb, K, L, M]
    llr = (seg @ wf.T).reshape(nb, m_pad, k, num_rows).permute(0, 2, 3, 1)
    return _scores_fn(plain)(llr, seg_lens.to(torch.int32),
                             c_rows.to(torch.float32).contiguous(), band)


def dtw_keyword_scores_batch(segments, seg_lens, w, c_rows, band: int,
                             plain: bool = False,
                             _max_cells: int = MAX_CELLS) -> torch.Tensor:
    """[B, M_pad, F, E] (or [B, M_pad, D]) x [K, L, ...] -> scores [B, K]
    (exhaustive: every segment against every template).

    The [B, M_pad, K, L] LLR product is the memory hazard at scan scale
    (~5 GB for one 30 s batch at K = 1024), so segments go through in
    chunks of at most ``_max_cells`` cells; each chunk is one GEMM and
    one DTW launch that reads the GEMM's output through its strides, the
    same computation on fewer rows, so the result equals the unchunked
    one."""
    b, k = segments.shape[0], w.shape[0]
    num_rows, m_pad = w.shape[1], segments.shape[1]
    chunk = max(1, min(b, _max_cells // max(k * num_rows * m_pad, 1)))
    parts = [
        _keyword_chunk(segments[s:s + chunk], seg_lens[s:s + chunk], w, c_rows,
                       band, plain)
        for s in range(0, b, chunk)
    ]
    if not parts:
        return torch.zeros((0, k), dtype=torch.float32, device=segments.device)
    return torch.cat(parts)


def dtw_pairwise_scores(segments, seg_lens, w_pairs, c_pairs, band: int,
                        plain: bool = False) -> torch.Tensor:
    """DTW score of segment i against its own template rows i (the
    verify-the-winner rescore over gathered segments): [N, M_pad, ...]
    x [N, L, ...] -> [N]; one fp32 batched product."""
    n, num_rows = segments.shape[0], w_pairs.shape[1]
    seg = segments.reshape(n, segments.shape[1], -1)
    wf = w_pairs.reshape(n, num_rows, -1)
    llr = torch.bmm(wf.to(torch.float32), seg.to(torch.float32).transpose(1, 2))
    return _scores_fn(plain)(llr, seg_lens.to(torch.int32),
                             c_pairs.to(torch.float32).contiguous(), band)


def dtw_pairwise_scores_from_map(
    binary_flat: torch.Tensor,   # [B, T, D] bool feature map (or [B, T, F, E])
    times: torch.Tensor,         # [B, P] int32 window starts (pre-clipped)
    ids: torch.Tensor,           # [B, P] int32 winner template ids
    w_rows: torch.Tensor,        # [K, L, D] per-row filters
    c_rows: torch.Tensor,        # [K, L]
    valid_frames: torch.Tensor,  # [B] int32
    m_seg: int,
    band: int,
    plain: bool = False,
) -> torch.Tensor:               # [B, P]
    """Verify-the-winner rescore straight from the feature map: each
    pair's [L, m] LLR tile comes from ``pair_llr`` (m = m_seg rounded
    up to 8), with no gathered segment or filter copies, and goes to the
    DTW kernel as it is, with the winner ids as its c rows; the filters
    enter as bf16, as in the reference.  Scores as
    ``dtw_pairwise_scores`` over gathered segments."""
    b, tdim = binary_flat.shape[0], binary_flat.shape[1]
    d = int(np.prod(binary_flat.shape[2:]))
    k, num_rows = w_rows.shape[0], w_rows.shape[1]
    dev = binary_flat.device
    m = -(-m_seg // 8) * 8
    t_idx = times.to(torch.int64).clamp(0, tdim - 1)
    rowstart = (torch.arange(b, device=dev)[:, None] * tdim + t_idx).reshape(-1)
    safe = ids.reshape(-1).to(torch.int64).clamp(0, k - 1).to(torch.int32)
    lens = torch.clamp(valid_frames.to(torch.int64)[:, None] - t_idx, 1, m_seg)
    lens = lens.reshape(-1).to(torch.int32)
    c32 = c_rows.to(torch.float32).contiguous()
    w16 = w_rows.reshape(k, num_rows, d).to(torch.bfloat16)
    llr_fn = pair_llr_plain if plain else pair_llr
    llr = llr_fn(binary_flat.reshape(b, tdim, d), w16, rowstart.to(torch.int32),
                 safe, m)                                       # [B*P, L, m]
    # the winner's c row is read inside the kernel (cid): nothing runs
    # between the two kernels
    return _scores_fn(plain)(llr, lens, c32, band, cid=safe).reshape(times.shape)
