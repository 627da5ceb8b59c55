"""Banded DTW terminal costs, batched over (segment, template) pairs.

Replaces ``template_speech_recognition_tpu/ops/dtw_pallas.py``
``_banded_dtw_packed`` (``_kernel_packed``; its ``pallas_call`` at line
688, the default for L <= 64) and ``banded_dtw_pallas``'s ``"full"`` /
``"band"`` layouts (``_kernel_full``, ``_kernel_band``; ``pallas_call``
at line 474, L > 64): one recurrence, one kernel.

    D[i, j] = cost[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

over the band ``|j*lm1 - i*mm1| <= band*lm1`` (``lm1 = max(L-1, 1)``,
``mm1 = max(seg_len-1, 1)``, integers), cells with ``j >= seg_len``
out, ``D[0, 0] = cost[0, 0]``; out-of-band and unreachable cells hold
3e38, a finite stand-in for +inf, as the TPU kernel's do.  Output:
``D[L-1, seg_len-1]`` per pair.

CUDA design (``csrc/banded_dtw.cu``): one warp per pair, lanes over
template rows (``ceil(L/32)`` registers a lane, so L <= 256), the row
above through a warp shuffle, the cost staged 32 diagonals at a time in
shared memory with coalesced loads; each pair stops at its own terminal
diagonal.  Terminals are bitwise those of ``banded_dtw_plain``: one
fp32 add and exact minimums per cell, in the same order.

What bounds it on the H100: the chain of L + seg_len - 1 dependent
diagonals per pair (69 at the scan's shapes), not bytes (about 1.6 MB
of in-band cost cells, 0.0005 ms at 3.35 TB/s) or operations.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "banded_dtw"
SOURCE = "template_speech_recognition_tpu_torch/csrc/banded_dtw.cu"
REPLACES = "template_speech_recognition_tpu/ops/dtw_pallas.py:688"
UNREACHABLE = 3.0e38
MAX_LENGTH = 256


def banded_dtw_plain(cost: torch.Tensor, seg_lens: torch.Tensor,
                     band: int) -> torch.Tensor:
    """Plain PyTorch version: a loop over the L + M - 1 diagonals,
    vectorised over pairs and template rows."""
    n, length, m = cost.shape
    dev = cost.device
    cost = cost.to(torch.float32)
    lens = seg_lens.to(device=dev, dtype=torch.int64)[:, None]          # [N, 1]
    i = torch.arange(length, device=dev)[None, :]                       # [1, L]
    lm1 = max(length - 1, 1)
    mm1 = torch.clamp(lens - 1, min=1)
    jlim = torch.clamp(lens, max=m)
    final_k = length - 1 + lens[:, 0] - 1                               # [N]
    unreachable = torch.full((n, 1), UNREACHABLE, device=dev)
    prev = torch.full((n, length), UNREACHABLE, device=dev)
    prev2 = prev.clone()
    out = torch.full((n,), UNREACHABLE, device=dev)
    for k in range(length + m - 1):
        j = k - i                                                       # [1, L]
        valid = (j >= 0) & (j < jlim) & ((j * lm1 - i * mm1).abs() <= band * lm1)
        idx = j.clamp(0, m - 1).expand(n, length)[:, :, None]
        cost_d = torch.gather(cost, 2, idx)[:, :, 0]                    # [N, L]
        up = torch.cat([unreachable, prev[:, :-1]], dim=1)              # D[i-1, j]
        up2 = torch.cat([unreachable, prev2[:, :-1]], dim=1)            # D[i-1, j-1]
        best = torch.minimum(torch.minimum(up, prev), up2)
        best = torch.where((i == 0) & (j == 0), 0.0, best)
        diag = torch.minimum(
            torch.where(valid, cost_d + best, UNREACHABLE), unreachable
        )
        out = torch.where(final_k == k, diag[:, -1], out)
        prev2, prev = prev, diag
    return out


def banded_dtw(cost: torch.Tensor, seg_lens: torch.Tensor, band: int) -> torch.Tensor:
    """cost [N, L, M] f32 + seg_lens [N] int32 (1 <= seg_len <= M) ->
    terminal costs [N] f32 (3e38 where unreachable).  CPU tensors take
    the plain version; CUDA tensors launch the kernel (L <= 256)."""
    if _cuda.on_cpu(cost, seg_lens):
        return banded_dtw_plain(cost, seg_lens, band)
    _cuda.require(cost, "cost", torch.float32, 3)
    _cuda.require(seg_lens, "seg_lens", torch.int32, 1)
    n, length, m = cost.shape
    if not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"L={length}: the kernel takes 1 <= L <= {MAX_LENGTH}")
    if tuple(seg_lens.shape) != (n,) or band < 0:
        raise ValueError(f"seg_lens must be [{n}] and band >= 0 (band={band})")
    out = torch.empty((n,), dtype=torch.float32, device=cost.device)
    if n == 0:
        return out
    # |j*lm1 - i*mm1| never exceeds (L + M) * lm1: a wider band is the
    # same band, and the clamp keeps band * lm1 inside int32
    band = min(band, length + m)
    lib = _cuda.load("banded_dtw")
    fn = _cuda.declare(lib, "tsr_banded_dtw", 3, 4)
    err = fn(
        _cuda.ptr(cost), _cuda.ptr(seg_lens), _cuda.ptr(out),
        n, length, m, band, _cuda.stream_ptr(cost.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
