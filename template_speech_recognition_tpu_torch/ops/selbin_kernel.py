"""Kernel 2: exact dual-rank select + binarize + spread.

Replaces ``template_speech_recognition_tpu/ops/selbin_pallas.py``
``select_binspread_pallas`` -- both its variants, the all-planes
``_kernel_allplanes`` (``pallas_call`` at line 312) and the per-plane
``_kernel`` (line 346): they compute one function.

Per (plane p, utterance b): the order keys of the valid cells (rows
< valid) are the monotone uint32 image of the float32 responses; the
selected keys are the ``need[b, 0]``-th and ``need[b, 1]``-th smallest
(1-based ranks; 0 selects key 0, a rank past the valid count selects
the masked key 0xFFFFFFFF, exactly as the TPU kernel's bisection).
Then channel 2p keeps ``key > v_hi`` and channel 2p+1 keeps ``key <
v_lo`` on canonicalized keys (-0.0 maps onto +0.0, so key order is
float order), both are dilated by ``spread_freq`` along frequency and
``spread_time`` along time, and rows >= valid are cleared before and
after.  Output: the flat channel-major map ``[B, T, 2PF]`` u8 and the
selected keys ``[B, P, 2]`` (int64 holding uint32), bitwise equal to
the TPU kernel's.

CUDA design (``csrc/select_binspread.cu``): the TPU kernel keeps a
whole ~3 MB plane resident in VMEM; an SM has 227 KB of shared memory.
So the select runs as four histogram radix passes of 8-bit digits over
all (plane, utterance) pairs at once: many blocks per pair count their
slice of the keys into shared-memory histograms (warp-aggregated
atomics) and add them into one global histogram per pair and rank;
a tiny kernel then picks each rank's digit.  Both ranks are counted in
the same pass.  Any digit schedule selects the same element, so the
keys are bitwise those of the 32-level bisection.  An epilogue kernel
reads the planes once more and writes the final map with both
dilations and the row mask.

What bounds it on the H100: bytes.  The planes in once and the map out
once (101 + 50 MB at B=8, T_pad=3072, F=256) take 0.045 ms at 3.35
TB/s; this design reads the planes five times (four passes and the
epilogue), so 0.17 ms is its own floor.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.edges import (
    MASKED_KEY,
    _dilate_axis,
    order_keys,
)

NAME = "select_binspread"
SOURCE = "template_speech_recognition_tpu_torch/csrc/select_binspread.cu"
REPLACES = "template_speech_recognition_tpu/ops/selbin_pallas.py:312"

_NEG_ZERO_KEY = 0x7FFFFFFF
_POS_ZERO_KEY = 0x80000000


def _canon(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k == _NEG_ZERO_KEY, torch.full_like(k, _POS_ZERO_KEY), k)


def select_binspread_plain(
    planes: torch.Tensor,        # [P, B, T, F] f32
    need: torch.Tensor,          # [B, 2] int: rank+1 for (k, n-1-k)
    valid_frames: torch.Tensor,  # [B] int
    spread_freq: int,
    spread_time: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a sort selects the keys."""
    p, b, t, f = planes.shape
    dev = planes.device
    keys = order_keys(planes)                                   # int64
    rv = torch.arange(t, device=dev)[None, :] < valid_frames.to(dev)[:, None]
    cell_valid = rv[None, :, :, None].expand(p, b, t, f)
    masked = torch.where(cell_valid, keys, torch.full_like(keys, MASKED_KEY))
    srt = torch.sort(masked.reshape(p, b, t * f), dim=-1).values
    need = need.to(device=dev, dtype=torch.int64)               # [B, 2]
    idx = (need - 1).clamp(min=0)[None].expand(p, b, 2)
    sel = torch.gather(srt, -1, idx)
    sel = torch.where(need[None] == 0, torch.zeros_like(sel), sel)  # [P, B, 2]
    ck = _canon(keys)
    v_hi = _canon(sel[..., 0])[..., None, None]
    v_lo = _canon(sel[..., 1])[..., None, None]
    pos = (ck > v_hi) & cell_valid
    neg = (ck < v_lo) & cell_valid
    # [P, 2, B, T, F] -> [B, T, 2P, F]: channel 2i = pos_i, 2i+1 = neg_i
    ch = torch.stack([pos, neg], dim=1).permute(2, 3, 0, 1, 4).reshape(
        b, t, 2 * p, f
    )
    if spread_freq:
        ch = _dilate_axis(ch, spread_freq, 3)
    if spread_time:
        ch = _dilate_axis(ch, spread_time, 1)
    ch = ch & rv[:, :, None, None]
    flat = ch.reshape(b, t, 2 * p * f).to(torch.uint8)
    return flat, sel.permute(1, 0, 2).contiguous()


def select_binspread(
    planes: torch.Tensor,
    need: torch.Tensor,
    valid_frames: torch.Tensor,
    spread_freq: int,
    spread_time: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[P, B, T, F] f32 planes -> (flat [B, T, 2PF] u8, keys [B, P, 2]
    int64).  CPU tensors take the plain version; CUDA tensors launch
    the kernels."""
    if _cuda.on_cpu(planes, need, valid_frames):
        return select_binspread_plain(
            planes, need, valid_frames, spread_freq, spread_time
        )
    _cuda.require(planes, "planes", torch.float32, 4)
    _cuda.require(need, "need", torch.int32, 2)
    _cuda.require(valid_frames, "valid_frames", torch.int32, 1)
    p, b, t, f = planes.shape
    if f % 4:
        raise ValueError(f"F={f} must be a multiple of 4")
    if tuple(need.shape) != (b, 2) or tuple(valid_frames.shape) != (b,):
        raise ValueError("need must be [B, 2] and valid_frames [B]")
    dev = planes.device
    q = p * b
    flat = torch.empty((b, t, 2 * p * f), dtype=torch.uint8, device=dev)
    keys = torch.empty((b, p, 2), dtype=torch.int32, device=dev)
    hist = torch.empty((4 * q * 512,), dtype=torch.int32, device=dev)
    state = torch.empty((q * 6,), dtype=torch.int32, device=dev)
    lib = _cuda.load("select_binspread")
    fn = _cuda.declare(lib, "tsr_select_binspread", 7, 6)
    err = fn(
        _cuda.ptr(planes), _cuda.ptr(need), _cuda.ptr(valid_frames),
        _cuda.ptr(flat), _cuda.ptr(keys), _cuda.ptr(hist), _cuda.ptr(state),
        p, b, t, f, spread_freq, spread_time, _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return flat, keys.to(torch.int64) & 0xFFFFFFFF
