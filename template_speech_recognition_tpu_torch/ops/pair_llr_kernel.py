"""Per-pair LLR cost tiles for verify-the-winner DTW rescoring.

Replaces ``template_speech_recognition_tpu/ops/dtw_pallas.py``
``pair_llr_pallas`` (``_pair_llr_kernel``; its ``pallas_call`` at line
590).

``out[n, i, j] = sum_d w[ids[n], i, d] * map[rowstart[n] + j, d]`` for
j < m, with the map read flat ([B*T, D]) and as zero past its last row:
a window near an utterance's end runs on into the next utterance's
rows, as in the reference; those cells lie at ``j >= seg_len`` and the
DP masks them.  The TPU kernel's 8-row alignment of the window start
(a Mosaic constraint) is not carried over: each pair gathers its exact
rows.

CUDA design (``csrc/pair_llr.cu``): one block of 4 warps a pair walks
D in stages of 128; cp.async copies each stage's filter rows [32, 128]
and window rows [40, 128] into a ring of 3 slots in shared memory (zero
fill past D and outside the map), so the bytes in flight hold no
registers and 4 blocks share an SM.  mma.sync bf16 with fp32
accumulation, each stage split across the warps in 32-wide chunks (D
need only be a multiple of 8, as D = 8F' always is: the last stage is
zero-filled), 16 bytes of filter row and 8 bool bytes of map row a
lane; the bools turn into bf16 in registers, so no bf16 copy of the map
is ever made.

What bounds it on the H100: bytes, counting each distinct map row the
windows cover and each distinct filter the ids name once.  At the
scan's shapes (984 pairs, m = 40, L = 32, D = 2048) with peaks spread
at random, about 40 MB of map rows + 83 MB of filter rows (~630
distinct templates) + 5 MB of output take about 0.04 ms at 3.35 TB/s;
5.2 GFLOP of bf16 take 0.005 ms.  The kernel reads a filter and a
window for every pair (210 MB): grouping a template's pairs to read its
filter once cost more warps than it saved bytes (``PERF.md``).
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "pair_llr"
SOURCE = "template_speech_recognition_tpu_torch/csrc/pair_llr.cu"
REPLACES = "template_speech_recognition_tpu/ops/dtw_pallas.py:590"


def pair_llr_plain(feats, w, rowstart, ids, m: int) -> torch.Tensor:
    """Plain PyTorch version: gather the windows and filter rows, one
    fp32 batched product (TF32 off, PyTorch's default)."""
    b, t, d = feats.shape
    k = w.shape[0]
    rows_total = b * t
    flat = torch.cat([feats.reshape(rows_total, d),
                      torch.zeros((1, d), dtype=feats.dtype, device=feats.device)])
    rows = rowstart.to(torch.int64)[:, None] + torch.arange(m, device=feats.device)
    rows = torch.where((rows >= 0) & (rows < rows_total), rows, rows_total)
    seg = flat[rows].to(torch.float32)                            # [N, m, D]
    wk = w[ids.to(torch.int64).clamp(0, k - 1)].to(torch.float32)  # [N, L, D]
    return torch.bmm(wk, seg.transpose(1, 2))


def pair_llr(feats, w, rowstart, ids, m: int) -> torch.Tensor:
    """feats [B, T, D] bool, w [K, L, D] bf16, rowstart [N] int32 (flat
    row of each window's first frame), ids [N] int32 -> [N, L, m] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if _cuda.on_cpu(feats, w, rowstart, ids):
        return pair_llr_plain(feats, w, rowstart, ids, m)
    _cuda.require(feats, "feats", torch.bool, 3)
    _cuda.require(w, "w", torch.bfloat16, 3)
    _cuda.require(rowstart, "rowstart", torch.int32, 1)
    _cuda.require(ids, "ids", torch.int32, 1)
    b, t, d = feats.shape
    k, length, dw = w.shape
    n = rowstart.shape[0]
    if dw != d or tuple(ids.shape) != (n,):
        raise ValueError(f"bad shapes: feats {tuple(feats.shape)}, w {tuple(w.shape)}, "
                         f"rowstart {tuple(rowstart.shape)}, ids {tuple(ids.shape)}")
    if d % 8 or feats.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"D={d} must be a multiple of 8 and the bases 16-byte aligned")
    dev = feats.device
    out = torch.empty((n, length, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0 or length == 0:
        return out
    lib = _cuda.load("pair_llr")
    fn = _cuda.declare(lib, "tsr_pair_llr", 5, 6)
    err = fn(_cuda.ptr(feats), _cuda.ptr(w), _cuda.ptr(rowstart), _cuda.ptr(ids),
             _cuda.ptr(out), b * t, n, k, length, d, m, _cuda.stream_ptr(dev))
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
