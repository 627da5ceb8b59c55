"""Kernel 8: one counting pass of the layered radix select.

Replaces ``template_speech_recognition_tpu/ops/radix_pallas.py``
``radix_level_counts_pallas`` (``_count_kernel``; its ``pallas_call`` at
line 85).

``out[r, j] = #{n : (keys[r, n] >> shift) <= cand[r, j]}`` over uint32
order keys ``[R, N]`` (masked cells hold 0xFFFFFFFF) and uint32
candidate prefixes ``[R, NC]``.  PyTorch has no uint32 arithmetic, so
both cross as int32 tensors holding the 32-bit patterns (half the bytes
of the int64 keys of ``ops.edges``); the kernel shifts and compares them
as unsigned.  The reference pads N up to its block with 0xFFFFFFFF
keys, which count toward a candidate only when it is the all-ones
prefix ``0xFFFFFFFF >> shift``; here nothing is padded.  The select
(``frontend.planes.plane_order_statistics``) picks the same digit
either way: the widest candidate reaches the rank with or without them.

CUDA design (``csrc/radix_counts.cu``): a grid of (8192-key chunks,
rows); each thread compares its keys against all NC <= 16 candidates of
its row held in registers, the counts are summed within the warp and
the block, and each block adds one atomic per (row, candidate).  The
keys are read once per launch.

What bounds it on the H100: bytes.  At the log-mel scan's shapes (32
rows of 193,536 keys) one launch reads 24.8 MB, 0.0074 ms at 3.35 TB/s;
the select makes 11 launches a batch.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "radix_counts"
SOURCE = "template_speech_recognition_tpu_torch/csrc/radix_counts.cu"
REPLACES = "template_speech_recognition_tpu/ops/radix_pallas.py:85"

MAX_CANDIDATES = 16


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_bits32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits as int32 (the
    narrowing cast wraps modulo 2**32 on the CPU and on CUDA)."""
    return x.to(torch.int32)


def radix_level_counts_plain(keys: torch.Tensor, cand: torch.Tensor,
                             shift: int) -> torch.Tensor:
    """Plain PyTorch version: the broadcast compare of the reference's
    XLA counting path, in int64 (exact uint32 order)."""
    hi = as_uint32(keys) >> shift                                  # [R, N]
    c = as_uint32(cand)                                            # [R, NC]
    return (hi[:, None, :] <= c[:, :, None]).sum(-1).to(torch.int32)


def radix_level_counts(keys: torch.Tensor, cand: torch.Tensor,
                       shift: int) -> torch.Tensor:
    """keys [R, N] int32 (uint32 bits), cand [R, NC] int32 (uint32
    bits), 0 <= shift < 32 -> [R, NC] int32 counts.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if _cuda.on_cpu(keys, cand):
        return radix_level_counts_plain(keys, cand, shift)
    _cuda.require(keys, "keys", torch.int32, 2)
    _cuda.require(cand, "cand", torch.int32, 2)
    r, n = keys.shape
    nc = cand.shape[1]
    if cand.shape[0] != r or not 1 <= nc <= MAX_CANDIDATES or not 0 <= shift < 32:
        raise ValueError(f"bad shapes: keys {tuple(keys.shape)}, cand "
                         f"{tuple(cand.shape)} (NC <= {MAX_CANDIDATES}), shift {shift}")
    out = torch.empty((r, nc), dtype=torch.int32, device=keys.device)
    if r == 0:
        return out
    lib = _cuda.load("radix_counts")
    fn = _cuda.declare(lib, "tsr_radix_counts", 3, 4)
    err = fn(
        _cuda.ptr(keys), _cuda.ptr(cand), _cuda.ptr(out), r, n, nc, shift,
        _cuda.stream_ptr(keys.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
