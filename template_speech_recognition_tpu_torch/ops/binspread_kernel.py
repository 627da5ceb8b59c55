"""Kernel 9: binarize + frequency spread of the layered frontend.

Replaces ``template_speech_recognition_tpu/ops/binspread_pallas.py``
``binarize_freqspread_pallas`` (``_kernel``; its ``pallas_call`` at
line 84).

For planes ``[B, P, T, F]`` f32 and the two order statistics ``os_hi,
os_lo [B, P]``: channel 2p keeps ``plane > os_hi`` and channel 2p+1
keeps ``plane < os_lo`` (float compares), rows ``>= valid`` cleared,
each channel dilated by ``+-spread_freq`` along F with zero fill at the
plane's own edges and by ``+-spread_time`` along T (rows outside [0,
valid) are zero), written into the flat channel-major map ``[B, T,
2PF]`` u8 with rows ``>= valid`` zero.  At ``spread_time = 0`` this is
the TPU kernel's function; above it, the reference's whole
``frontend.planes.binarize_spread_flat`` (its time dilation and row
mask after the kernel).

CUDA design (``csrc/binspread.cu``): one block per (utterance, tile of
``tile_rows`` time rows, 64 at the log-mel scan's shape) holds all P
planes, so it writes whole flat rows, one contiguous run of bytes.  It
copies each plane's halo span into shared memory with 16-byte loads,
eight in flight a thread; warps binarize 32-wide words of each (halo
row, plane) with two ballots; the frequency spread is funnel shifts of
a channel's word string, the time spread an OR over the halo rows; the
words are ORed into a bit string of the tile in flat order, and each
thread turns 16 of its bits into 16 bytes for one 16-byte store.
``binarize_freqspread_bits`` emulates those word operations on the CPU.
The planes may be a strided ``[B, P]`` view of ``[.., T,
F]``-contiguous storage: the layered frontend hands kernel 1's
plane-major output over without a copy.

What bounds it on the H100: bytes.  At the log-mel scan's shapes (B =
8, P = 4, T = 3072, F = 63) the valid rows of the planes (24.2 MB) in
and 12.4 MB of map out take 0.011 ms at 3.35 TB/s, with or without the
time spread.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.edges import _dilate_axis

NAME = "binspread"
SOURCE = "template_speech_recognition_tpu_torch/csrc/binspread.cu"
REPLACES = "template_speech_recognition_tpu/ops/binspread_pallas.py:84"
MAX_TILE_ROWS = 64          # rows a block of the kernel writes, at most
SMEM_TARGET = 75 * 1024     # a block's shared memory, so that three share an SM


def _smem_bytes(tb: int, p: int, f: int, rt: int) -> int:
    """Shared memory of a block of ``tb`` rows (as ``csrc/binspread.cu``'s
    ``smem_bytes``): the planes' halo spans, the masks, the bit string."""
    plane = ((tb + 2 * rt) * f + 6) // 4 * 4
    masks = (tb + 2 * rt) * 2 * p * (-(-f // 32))
    bits = (tb * 2 * p * f + 31) // 32 + 1
    return (p * plane + masks + bits) * 4


def tile_rows(p: int, f: int, rt: int) -> int:
    """Rows a block of the kernel writes at (P, F, rt): the most, a
    multiple of 4 up to 64 (a tile then starts on a 32-byte boundary of
    its utterance's rows), whose block fits 75 KB of shared memory (64 at
    the log-mel scan's P 4, F 63, rt 1; 4 at F 512); else 4."""
    for tb in range(MAX_TILE_ROWS, 4, -4):
        if _smem_bytes(tb, p, f, rt) <= SMEM_TARGET:
            return tb
    return 4


def _row_valid(valid_frames, t, dev):
    return torch.arange(t, device=dev)[None, :] < valid_frames.to(dev)[:, None]   # [B, T]


def binarize_freqspread_plain(planes, os_hi, os_lo, valid_frames, spread_freq,
                              spread_time=0):
    """Plain PyTorch version, as the reference kernel computes it (and,
    with ``spread_time``, the reference's time dilation and row mask)."""
    b, p, t, f = planes.shape
    rv = _row_valid(valid_frames, t, planes.device)[:, None, :, None]  # [B, 1, T, 1]
    pos = (planes > os_hi[:, :, None, None]) & rv
    neg = (planes < os_lo[:, :, None, None]) & rv
    if spread_freq:
        pos = _dilate_axis(pos, spread_freq, -1)
        neg = _dilate_axis(neg, spread_freq, -1)
    # [B, P, 2, T, F] -> [B, T, P, 2, F]: channel 2i = pos_i, 2i+1 = neg_i
    ch = torch.stack([pos, neg], dim=2).permute(0, 3, 1, 2, 4)
    flat = ch.reshape(b, t, 2 * p * f)
    if spread_time:
        flat = _dilate_axis(flat, spread_time, 1) & rv[:, 0]
    return flat.to(torch.uint8)


def _bits_at(words: torch.Tensor, pos) -> torch.Tensor:
    """32 bits of each word string (last dim, values < 2**32 in int64)
    from bit ``pos`` on (an int, or a tensor of offsets into one
    string), zeros outside it: the kernel's funnel shift."""
    nw = words.shape[-1]
    pad = torch.zeros(words.shape[:-1] + (nw + 3,), dtype=torch.int64)
    pad[..., 1:nw + 1] = words
    pos = torch.as_tensor(pos, dtype=torch.int64)
    q = ((pos >> 5) + 1).clamp(-1, nw + 1)         # pad[-1], pad[0]: zero words
    r = pos & 31
    lo, hi = pad[..., q], pad[..., q + 1]
    return torch.where(r > 0, (lo >> r) | (hi << (32 - r).clamp(max=31)), lo) & 0xFFFFFFFF


def _spread4(x: torch.Tensor) -> torch.Tensor:
    """4 bits -> 4 bytes (bit i to the low bit of byte i), in one word."""
    return ((x & 0xF) * 0x00204081) & 0x01010101


def binarize_freqspread_bits(planes, os_hi, os_lo, valid_frames, spread_freq,
                             spread_time=0):
    """The kernel's word operations in PyTorch (int64 holding uint32):
    32-bit masks of each (row, plane, polarity) as the ballots make them,
    the frequency spread as funnel shifts across word boundaries, the
    time spread as an OR over the halo rows, the words ORed into each
    utterance's bit string in flat order, then 16 bits to 16 bytes with
    the nibble multiply.  Bitwise the plain version."""
    b, p, t, f = planes.shape
    nw, e_n, rowlen = -(-f // 32), 2 * p, 2 * p * f
    rv = _row_valid(valid_frames, t, planes.device)[:, None, :, None].cpu()
    pos = (planes.cpu() > os_hi.cpu()[:, :, None, None]) & rv
    neg = (planes.cpu() < os_lo.cpu()[:, :, None, None]) & rv
    ch = torch.stack([pos, neg], dim=2).reshape(b, e_n, t, f)      # [B, E, T, F]
    bits = torch.zeros((b, e_n, t, nw * 32), dtype=torch.int64)
    bits[..., :f] = ch.to(torch.int64)
    masks = (bits.reshape(b, e_n, t, nw, 32) << torch.arange(32)).sum(-1)   # the ballots
    last = (1 << (f & 31)) - 1 if f & 31 else 0xFFFFFFFF
    fsp = torch.zeros_like(masks)
    for w in range(nw):
        for s in range(-spread_freq, spread_freq + 1):
            fsp[..., w] |= _bits_at(masks, 32 * w + s)
    fsp[..., nw - 1] &= last
    tsp = fsp.clone()
    for s in range(1, spread_time + 1):
        tsp[:, :, s:] |= fsp[:, :, :-s]
        tsp[:, :, :-s] |= fsp[:, :, s:]
    tsp = tsp * rv[:, :, :, 0, None]                              # the row mask
    # OR into the bit string: bit t * rowlen + e * F + f; the words'
    # bits never overlap, so the OR is a sum
    pos0 = (torch.arange(t)[:, None, None] * rowlen + torch.arange(e_n)[None, :, None] * f
            + 32 * torch.arange(nw)[None, None, :])                # [T, E, nw]
    n_fb = (t * rowlen + 31) // 32 + 2
    fb = torch.zeros((b, n_fb), dtype=torch.int64)
    v = tsp.permute(0, 2, 1, 3)                                   # [B, T, E, nw]
    q, sh = (pos0 >> 5).reshape(-1), (pos0 & 31).reshape(-1)
    vv = v.reshape(b, -1)
    fb.index_add_(1, q, (vv << sh) & 0xFFFFFFFF)
    fb.index_add_(1, q + 1, torch.where(sh > 0, vv >> (32 - sh).clamp(max=31), 0))
    # 16 bits -> 16 bytes: each block's tile of tile_rows rows, in
    # 16-byte chunks aligned to the map's address (the tile's first byte
    # is not, where the utterance's rows before it fill an odd number of
    # 8-byte units)
    tb = tile_rows(p, f, spread_time)
    out = torch.zeros((b * t * rowlen,), dtype=torch.uint8)
    for bi in range(b):
        for t0 in range(0, t, tb):
            nbytes = min(tb, t - t0) * rowlen
            g0 = (bi * t + t0) * rowlen
            tile = fb[bi, t0 * rowlen // 32:]                  # t0 * rowlen % 32 == 0
            tile = torch.cat([tile[: -(-nbytes // 32)], torch.zeros(2, dtype=torch.int64)])
            tile[nbytes // 32] &= (1 << (nbytes % 32)) - 1     # bits past the tile: zero
            c = torch.arange(g0 >> 4, (g0 + nbytes + 15) >> 4)
            o = 16 * c - g0
            full = (o >= 0) & (o + 16 <= nbytes)
            of = o[full]
            b16 = _bits_at(tile, of) & 0xFFFF
            words = _spread4(b16[:, None] >> (4 * torch.arange(4)))        # [chunks, 4]
            vals = (words[..., None] >> (8 * torch.arange(4))) & 1         # [chunks, 4, 4]
            out[(16 * c[full])[:, None] + torch.arange(16)] = vals.reshape(-1, 16).to(
                torch.uint8)
            for oo in [int(x) + i for x in o[~full] for i in range(16)]:  # byte by byte
                if 0 <= oo < nbytes:
                    out[g0 + oo] = int(tile[oo >> 5] >> (oo & 31)) & 1
    return out.reshape(b, t, rowlen)


def binarize_freqspread(planes, os_hi, os_lo, valid_frames, spread_freq, spread_time=0):
    """planes [B, P, T, F] f32 (any strides over B and P; T, F
    contiguous), os_hi/os_lo [B, P] f32, valid_frames [B] int32 ->
    [B, T, 2PF] uint8.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _cuda.on_cpu(planes, os_hi, os_lo, valid_frames):
        return binarize_freqspread_plain(planes, os_hi, os_lo, valid_frames, spread_freq,
                                         spread_time)
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
            or tuple(valid_frames.shape) != (b,) or spread_freq < 0 or spread_time < 0):
        raise ValueError("os_hi/os_lo must be [B, P], valid_frames [B], spreads >= 0")
    if planes.data_ptr() % 16:
        raise ValueError("planes: the storage must be 16-byte aligned")
    flat = torch.empty((b, t, 2 * p * f), dtype=torch.uint8, device=planes.device)
    lib = _cuda.load("binspread")
    fn = _cuda.declare(lib, "tsr_binspread", 5, 6, n_long=2)
    err = fn(
        _cuda.ptr(planes), _cuda.ptr(os_hi), _cuda.ptr(os_lo), _cuda.ptr(valid_frames),
        _cuda.ptr(flat), planes.stride(0), planes.stride(1), b, p, t, f, spread_freq,
        spread_time, _cuda.stream_ptr(planes.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return flat
