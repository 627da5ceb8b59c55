"""Kernel 9: binarize + frequency spread of the layered frontend.

Replaces ``template_speech_recognition_tpu/ops/binspread_pallas.py``
``binarize_freqspread_pallas`` (``_kernel``; its ``pallas_call`` at
line 84).

For planes ``[B, P, T, F]`` f32 and the two order statistics ``os_hi,
os_lo [B, P]``: channel 2p keeps ``plane > os_hi`` and channel 2p+1
keeps ``plane < os_lo`` (float compares), rows ``>= valid`` cleared,
each channel dilated by ``+-spread_freq`` along F with zero fill at the
plane's own edges, written into the flat channel-major map ``[B, T,
2PF]`` u8.  Time dilation stays with the caller
(``frontend.planes.binarize_spread_flat``).

CUDA design (``csrc/binspread.cu``): one block per (utterance, plane,
32-row time tile) stages both binarized channels of its tile in shared
memory and writes the dilated rows, one byte per cell (a 504-byte flat
row at F = 63 is not 16-byte aligned).  The planes may be a strided
``[B, P]`` view of ``[.., T, F]``-contiguous storage: the layered
frontend hands kernel 1's plane-major output over without a copy.

What bounds it on the H100: bytes.  At the log-mel scan's shapes (B =
8, P = 4, T = 3072, F = 63) 24.8 MB of planes in and 12.4 MB of map out
take 0.011 ms at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.edges import _dilate_axis

NAME = "binspread"
SOURCE = "template_speech_recognition_tpu_torch/csrc/binspread.cu"
REPLACES = "template_speech_recognition_tpu/ops/binspread_pallas.py:84"


def binarize_freqspread_plain(planes, os_hi, os_lo, valid_frames, spread_freq):
    """Plain PyTorch version, as the reference kernel computes it."""
    b, p, t, f = planes.shape
    dev = planes.device
    rv = (torch.arange(t, device=dev)[None, :] < valid_frames.to(dev)[:, None])
    rv = rv[:, None, :, None]                                       # [B, 1, T, 1]
    pos = (planes > os_hi[:, :, None, None]) & rv
    neg = (planes < os_lo[:, :, None, None]) & rv
    if spread_freq:
        pos = _dilate_axis(pos, spread_freq, -1)
        neg = _dilate_axis(neg, spread_freq, -1)
    # [B, P, 2, T, F] -> [B, T, P, 2, F]: channel 2i = pos_i, 2i+1 = neg_i
    ch = torch.stack([pos, neg], dim=2).permute(0, 3, 1, 2, 4)
    return ch.reshape(b, t, 2 * p * f).to(torch.uint8)


def binarize_freqspread(planes, os_hi, os_lo, valid_frames, spread_freq):
    """planes [B, P, T, F] f32 (any strides over B and P; T, F
    contiguous), os_hi/os_lo [B, P] f32, valid_frames [B] int32 ->
    [B, T, 2PF] uint8.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _cuda.on_cpu(planes, os_hi, os_lo, valid_frames):
        return binarize_freqspread_plain(planes, os_hi, os_lo, valid_frames, spread_freq)
    b, p, t, f = planes.shape
    if planes.dtype != torch.float32 or planes.stride()[2:] != (f, 1):
        raise ValueError(
            f"planes: expected float32 with [T, F] contiguous, got {planes.dtype} "
            f"strides {planes.stride()}"
        )
    _cuda.require(os_hi, "os_hi", torch.float32, 2)
    _cuda.require(os_lo, "os_lo", torch.float32, 2)
    _cuda.require(valid_frames, "valid_frames", torch.int32, 1)
    if (tuple(os_hi.shape) != (b, p) or tuple(os_lo.shape) != (b, p)
            or tuple(valid_frames.shape) != (b,) or spread_freq < 0):
        raise ValueError("os_hi/os_lo must be [B, P], valid_frames [B], spread_freq >= 0")
    flat = torch.empty((b, t, 2 * p * f), dtype=torch.uint8, device=planes.device)
    lib = _cuda.load("binspread")
    fn = _cuda.declare(lib, "tsr_binspread", 5, 5, n_long=2)
    err = fn(
        _cuda.ptr(planes), _cuda.ptr(os_hi), _cuda.ptr(os_lo), _cuda.ptr(valid_frames),
        _cuda.ptr(flat), planes.stride(0), planes.stride(1), b, p, t, f, spread_freq,
        _cuda.stream_ptr(planes.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return flat
