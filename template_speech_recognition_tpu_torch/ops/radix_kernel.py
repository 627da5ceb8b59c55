"""Kernel 8: the layered radix select of the layered frontend.

Replaces ``template_speech_recognition_tpu/ops/radix_pallas.py``
``radix_level_counts_pallas`` (``_count_kernel``; its ``pallas_call`` at
line 85), one counting pass of the reference's select, and the level
loop around it (``frontend/planes.py`` ``plane_order_statistics``).

``radix_select(planes_pm, valid_frames, need)``: for the plane-major
planes ``[P, B, T, F]`` f32, the valid frames ``[B]`` and the 1-based
dual ranks ``need [B, 2]`` (``frontend.planes._dual_ranks``), the
elements of those ranks among each (plane, utterance)'s valid cells
(rows ``< valid``): ``(os_hi, os_lo)``, each ``[B, P]`` f32.  Every
digit schedule selects the same element, so three versions agree bit
for bit:

* ``radix_select_plain``: the reference's kernel schedule (digits of 2
  + 3 x 10 bits, ``RADIX_WIDTHS``), each level counting the monotone
  uint32 keys (masked cells 0xFFFFFFFF) against every candidate
  extension of the prefix (``radix_level_counts_plain``, the counting
  pass of the TPU kernel) and descending into the first candidate
  whose count reaches the rank;
* ``radix_select_tiled``: the CUDA kernel's schedule in PyTorch, for the
  CPU tests: a histogram of each digit (11, 11 and 10 bits,
  ``SELECT_WIDTHS``) summed over chunks of a row, only the valid cells
  counted; level 1 counted once for both ranks; a digit pick that takes
  the last digit when no cumulative count reaches the rank (only an
  utterance with no valid cell, where the reference descends into its
  masked all-ones keys);
* ``radix_select``: the CUDA kernel (``csrc/radix_select.cu``), one call
  of four launches (no memset), no host sync.

PyTorch has no uint32 arithmetic: the keys are int32 tensors holding
the 32-bit patterns (``ops.edges.order_keys32``) or int64 ones holding
their values (``as_uint32``).

CUDA design: four launches.  A small kernel zeroes level 1's histogram.
Levels 1 and 2 run over a grid of (chunks of a row, rows); each block
makes the keys from the float planes as it reads them (16-byte loads;
rows past valid are not read).  Level 1 builds each chunk's histogram of
the top 11 bits in shared memory (one private copy a warp) and adds its
nonzero bins into a global histogram with atomics.  Level 2's blocks
pick the row's level-1 digits themselves (a block prefix sum over that
histogram) and collect the keys in either rank's level-1 bin.  The last
launch, one block a row, counts levels 2 and 3 over those keys in shared
memory, picks there and writes the floats.

What bounds it on the H100: bytes.  At the log-mel scan's shape (32 rows
of 2997 x 63 valid cells) one read of the valid planes is 24.2 MB,
0.0072 ms at 3.35 TB/s.
"""

from __future__ import annotations

import functools
import math

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.edges import (
    key_to_float,
    order_keys,
    order_keys32,
)

NAME = "radix_select"
SOURCE = "template_speech_recognition_tpu_torch/csrc/radix_select.cu"
REPLACES = "template_speech_recognition_tpu/ops/radix_pallas.py:85"

# The reference's kernel schedule of digit widths (its XLA path takes
# 8 x 4 bits): the plain version's, so that each level's counts can be
# held against the TPU kernel's counting pass.
RADIX_WIDTHS = (2,) + (3,) * 10
# The CUDA kernel's: three 2048-bin histograms.
SELECT_WIDTHS = (11, 11, 10)
MAX_BITS = 11                 # 2048 bins: the kernel's shared histograms
THREADS = 256
BLOCKS_PER_SM = 3             # level 1's 64 KB of shared memory a block
H100_SMS = 132


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_bits32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits as int32 (the
    narrowing cast wraps modulo 2**32 on the CPU and on CUDA)."""
    return x.to(torch.int32)


def radix_level_counts_plain(keys: torch.Tensor, cand: torch.Tensor,
                             shift: int) -> torch.Tensor:
    """One counting pass of the TPU kernel: ``out[r, j] = #{n : (keys[r,
    n] >> shift) <= cand[r, j]}`` over keys [R, N] and candidates [R, NC]
    (int32 tensors of uint32 bits), as the reference's XLA counting path
    computes it, in int64 (exact uint32 order)."""
    hi = as_uint32(keys) >> shift                                  # [R, N]
    c = as_uint32(cand)                                            # [R, NC]
    return (hi[:, None, :] <= c[:, :, None]).sum(-1).to(torch.int32)


def radix_select_plain(planes_pm: torch.Tensor, valid_frames: torch.Tensor,
                       need: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's layered select with the
    digit widths ``RADIX_WIDTHS``.  Each level counts, per (plane, rank),
    the keys whose top bits are <= each candidate extension of the prefix
    and descends into the first candidate whose count reaches the rank;
    every step stays on the device."""
    p, b, t, f = planes_pm.shape
    dev = planes_pm.device
    rv = torch.arange(t, device=dev)[None, :] < valid_frames.to(dev)[:, None]
    keys = order_keys32(planes_pm).masked_fill(~rv[None, :, :, None], -1)
    keys = keys.reshape(p * b, t * f)
    want = need.to(device=dev, dtype=torch.int64)[None, :, :, None]   # [1, B, 2, 1]
    iota = {w: torch.arange(1 << w, device=dev) for w in set(RADIX_WIDTHS)}
    prefix = torch.zeros((p, b, 2), dtype=torch.int64, device=dev)
    bits_done = 0
    for w in RADIX_WIDTHS:
        bits_done += w
        base = prefix << w
        cand = base[..., None] + iota[w]                           # [P, B, 2, 2^w]
        cnt = radix_level_counts_plain(keys, to_bits32(cand.reshape(p * b, 2 << w)),
                                       32 - bits_done)
        # the counts rise with the candidate and the widest reaches the
        # rank, so the first candidate that does is the number that do not
        prefix = base + (cnt.reshape(p, b, 2, 1 << w) < want).sum(-1)
    os_ = key_to_float(prefix).permute(2, 1, 0)                  # [2, B, P]
    return os_[0].contiguous(), os_[1].contiguous()


def _derive(hist: torch.Tensor, widths, levels: int, need_rows: torch.Tensor):
    """Both ranks' prefixes and remaining ranks [R, 2] after ``levels``
    levels of the histograms ``hist [levels, R, 2, 2^MAX_BITS]``: the
    kernel's digit pick.  Slot 1 holds a rank's counts only where its
    prefix differs from rank 0's; otherwise both read slot 0."""
    r = hist.shape[1]
    pre = torch.zeros((r, 2), dtype=torch.int64)
    rem = need_rows.to(torch.int64).clone()
    rows = torch.arange(r)
    for level in range(levels):
        w = widths[level]
        nb = 1 << w
        slot1 = (pre[:, 1] != pre[:, 0]).to(torch.int64)
        h = torch.stack([hist[level, :, 0, :nb], hist[level, rows, slot1, :nb]], dim=1)
        cum = h.cumsum(-1)                                         # [R, 2, nb]
        reach = cum >= rem[..., None]
        digit = torch.where(reach.any(-1), reach.to(torch.int32).argmax(-1),
                            torch.full_like(rem, nb - 1))
        below = torch.where(
            digit > 0, cum.gather(-1, (digit - 1).clamp(min=0)[..., None])[..., 0],
            torch.zeros_like(rem))
        rem = rem - below
        pre = (pre << w) | digit
    return pre, rem


def radix_select_tiled(planes_pm: torch.Tensor, valid_frames: torch.Tensor,
                       need: torch.Tensor, widths=SELECT_WIDTHS,
                       chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's schedule in PyTorch (CPU tests): for each level,
    each chunk of ``chunk`` cells of a row adds its histogram of the
    level's digit (``scatter_add_``) over the cells whose prefix matches a
    rank's, once for both ranks where their prefixes are equal (always at
    level 1); then the digit pick of ``_derive``.  Level 1 reads the
    valid cells; the kernel's level 2 collects those in either rank's
    level-1 bin, and the later levels read only the collected ones."""
    p, b, t, f = planes_pm.shape
    r = p * b
    keys = order_keys(planes_pm.reshape(r, t * f).cpu())           # [R, T*F] int64
    n = (valid_frames.to(torch.int64).cpu().clamp(0, t) * f).repeat(p)   # [R]
    cell_ok = torch.arange(t * f)[None, :] < n[:, None]
    need_rows = need.to(torch.int64).cpu().repeat(p, 1)            # [R, 2]
    hist = torch.zeros((len(widths), r, 2, 1 << MAX_BITS), dtype=torch.int64)
    bits_before = 0
    collected = torch.zeros_like(cell_ok)
    for level, w in enumerate(widths):
        pre, _ = _derive(hist, widths, level, need_rows)
        shift = 32 - bits_before - w
        src_ok = cell_ok if level < 2 else collected
        for start in range(0, t * f, chunk):
            k = keys[:, start:start + chunk]
            ok = src_ok[:, start:start + chunk]
            d = (k >> shift) & ((1 << w) - 1)
            if level == 0:
                in0, in1 = ok, torch.zeros_like(ok)
            else:
                top = k >> (32 - bits_before)
                in0 = ok & (top == pre[:, :1])
                in1 = ok & (top == pre[:, 1:]) & (pre[:, 1:] != pre[:, :1])
            part = torch.zeros((r, 2, 1 << MAX_BITS), dtype=torch.int64)
            part[:, 0].scatter_add_(1, d, in0.to(torch.int64))
            part[:, 1].scatter_add_(1, d, in1.to(torch.int64))
            hist[level] += part
            if level == 1:
                collected[:, start:start + chunk] = in0 | in1
        bits_before += w
    pre, _ = _derive(hist, widths, len(widths), need_rows)
    os_ = key_to_float(pre.reshape(p, b, 2)).permute(2, 1, 0)    # [2, B, P]
    dev = planes_pm.device
    return os_[0].contiguous().to(dev), os_[1].contiguous().to(dev)


@functools.lru_cache(maxsize=64)
def plan_chunk(cells: int, rows: int, sms: int = H100_SMS) -> int:
    """Cells a block: enough chunks of each row that the rows' blocks
    fill the SMs once at ``BLOCKS_PER_SM``, as a multiple of 4 x THREADS
    cells (whole 16-byte loads for every thread)."""
    per_row = max(1, math.ceil(BLOCKS_PER_SM * sms / max(rows, 1)))
    step = 4 * THREADS
    return max(step, math.ceil(cells / per_row / step) * step)


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def scratch_ints(rows: int, cells: int) -> int:
    """The kernel's int32 scratch: two collected counts a row (padded to
    4) and level 1's histogram [R, 2048], then the stage and compact
    buffers of ``cells`` keys a row, each row rounded up to 4."""
    return (-(-2 * rows // 4) * 4 + rows * (1 << MAX_BITS)
            + 2 * rows * (-(-cells // 4) * 4))


def radix_select(planes_pm: torch.Tensor, valid_frames: torch.Tensor,
                 need: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """planes_pm [P, B, T, F] f32 contiguous, valid_frames [B] int32,
    need [B, 2] int32 -> (os_hi, os_lo), each [B, P] f32 contiguous.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    The kernel reads at most T rows of a plane; a ``valid_frames`` above
    T is refused where its values are on the host (on the card, checking
    them would wait for the device; ``plane_order_statistics`` clamps
    them to T first)."""
    if _cuda.on_cpu(planes_pm, valid_frames, need):
        return radix_select_plain(planes_pm, valid_frames, need)
    _cuda.require(planes_pm, "planes", torch.float32, 4)
    _cuda.require(valid_frames, "valid_frames", torch.int32, 1)
    _cuda.require(need, "need", torch.int32, 2)
    p, b, t, f = planes_pm.shape
    if t == 0 or f == 0 or t * f >= 1 << 31:
        raise ValueError(f"planes {tuple(planes_pm.shape)}: no cell to select, or a plane "
                         f"of 2^31 cells or more")
    if tuple(valid_frames.shape) != (b,) or tuple(need.shape) != (b, 2):
        raise ValueError(f"valid_frames must be [{b}] and need [{b}, 2], got "
                         f"{tuple(valid_frames.shape)} and {tuple(need.shape)}")
    if valid_frames.device.type == "cpu" and bool((valid_frames > t).any()):
        raise ValueError(f"valid_frames above T = {t}")
    os_hi, os_lo = torch.empty((2, b, p), dtype=torch.float32, device=planes_pm.device).unbind(0)
    r = p * b
    if r == 0:
        return os_hi, os_lo
    chunk = plan_chunk(t * f, r, _sm_count(str(planes_pm.device)))
    scratch = torch.empty(scratch_ints(r, t * f), dtype=torch.int32, device=planes_pm.device)
    lib = _cuda.load(NAME)
    fn = _cuda.declare(lib, "tsr_radix_select", 6, 5)
    err = fn(
        _cuda.ptr(planes_pm), _cuda.ptr(valid_frames), _cuda.ptr(need), _cuda.ptr(os_hi),
        _cuda.ptr(os_lo), _cuda.ptr(scratch), p, b, t, f, chunk,
        _cuda.stream_ptr(planes_pm.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return os_hi, os_lo
