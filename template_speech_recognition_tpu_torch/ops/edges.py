"""Order keys, edge responses and binary dilation helpers.

Counterpart of ``template_speech_recognition_tpu.ops.edges``.  PyTorch
has no full uint32 arithmetic, so the monotone uint32 order keys are
held in int64 tensors (values 0 .. 2**32-1); every comparison on them
is then exactly the uint32 comparison.  ``order_keys32`` gives the same
keys as int32 bit patterns, for the radix counting kernel.
"""

from __future__ import annotations

import torch

_SIGN = 0x80000000
_MASK32 = 0xFFFFFFFF
MASKED_KEY = 0xFFFFFFFF


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection float32 -> uint32 (held in int64):
    a < b  <=>  key(a) < key(b); -0.0 -> 0x7FFFFFFF, +0.0 -> 0x80000000."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _MASK32
    return torch.where(bits >= _SIGN, (~bits) & _MASK32, bits | _SIGN)


def order_keys32(x: torch.Tensor) -> torch.Tensor:
    """``order_keys`` as int32 tensors holding the uint32 bits, in three
    elementwise passes: ``bits ^ ((bits >> 31) | 0x80000000)`` is
    ``~bits`` for a set sign bit and ``bits | 0x80000000`` otherwise."""
    bits = x.to(torch.float32).view(torch.int32)
    return bits ^ ((bits >> 31) | -(1 << 31))


def key_to_float(key: torch.Tensor) -> torch.Tensor:
    """Inverse of ``order_keys``."""
    key = key.to(torch.int64)
    bits = torch.where(key >= _SIGN, key ^ _SIGN, (~key) & _MASK32)
    # the same 32 bits as an int32, then reinterpreted as float32
    bits = torch.where(bits >= _SIGN, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def edge_responses(spec: torch.Tensor) -> torch.Tensor:
    """[..., T, F] -> [..., T-1, F-1, 8]; orientation/polarity layout
    identical to the reference's ``edge_responses``."""
    d_time = (spec[..., 1:, :] - spec[..., :-1, :])[..., :, :-1]
    d_freq = (spec[..., :, 1:] - spec[..., :, :-1])[..., :-1, :]
    d_diag = spec[..., 1:, 1:] - spec[..., :-1, :-1]
    d_anti = spec[..., 1:, :-1] - spec[..., :-1, 1:]
    chans = []
    for d in (d_time, d_freq, d_diag, d_anti):
        chans.append(d)
        chans.append(-d)
    return torch.stack(chans, dim=-1)


def _shifted(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """x shifted by s along dim, zero/False-filled (no wraparound)."""
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if s > 0:
        out.narrow(dim, s, n - s).copy_(x.narrow(dim, 0, n - s))
    elif s < 0:
        out.narrow(dim, 0, n + s).copy_(x.narrow(dim, -s, n + s))
    else:
        out.copy_(x)
    return out


def _dilate_axis(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    out = x
    for s in range(1, radius + 1):
        out = out | _shifted(x, s, dim) | _shifted(x, -s, dim)
    return out
