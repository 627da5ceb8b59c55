"""Order keys, edge responses, quantile binarization and dilation.

Counterpart of ``template_speech_recognition_tpu.ops.edges``.  PyTorch
has no full uint32 arithmetic, so the monotone uint32 order keys are
held in int64 tensors (values 0 .. 2**32-1); every comparison on them
is then exactly the uint32 comparison.  ``order_keys32`` gives the same
keys as int32 bit patterns, for the radix counting kernel.

The classic per-map sequence -- ``quantile_threshold`` (the exact k-th
order statistic of each channel's valid cells, by ``radix_kth_smallest``
or by a sort), ``binarize``, ``spread_binary``, ``mask_rows`` -- is the
readable spec of what the planes path (``frontend.planes``: kernels 1
and 2, or kernels 1, 8 and 9) computes for a whole batch.  These helpers
are plain PyTorch on any device, as the reference's are ``jnp`` ops; no
path of the port calls them.
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


def radix_kth_smallest(keys: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest (0-indexed) per column of uint32 keys [N, C]
    (held in int64) -> [C] int64 keys.

    The reference's 8 bisection levels of 4 bits: each counts, for the
    16 digit extensions of the known prefix, the keys whose top bits are
    <= the candidate, and descends into the first candidate whose count
    reaches k + 1.  ``k`` is a scalar or [C] and must be below the
    number of unmasked keys (masked: ``MASKED_KEY``) in each column."""
    keys = keys.to(torch.int64)
    dev = keys.device
    need = torch.as_tensor(k, device=dev).to(torch.int64) + 1
    prefix = torch.zeros(keys.shape[1], dtype=torch.int64, device=dev)
    digits = torch.arange(16, dtype=torch.int64, device=dev)
    for level in range(8):
        hi = keys >> (28 - 4 * level)                            # [N, C]
        base = prefix << 4                                       # [C]
        cand = base[None, :] + digits[:, None]                   # [16, C]
        cnt = (hi[:, None, :] <= cand[None]).sum(0)              # [16, C]
        prefix = base + torch.argmax((cnt >= need).to(torch.int32), dim=0)
    return prefix


def _order_statistic_rank(t: int, f: int, quantile: float, valid_frames=None,
                          device=None) -> torch.Tensor:
    """k = min(n - 1, floor(f32(q) * f32(n))), n the valid cells, in
    float32 as the reference computes it; an int64 scalar tensor."""
    if valid_frames is None:
        n = torch.tensor(t * f, dtype=torch.int32, device=device)
    else:
        n = (torch.as_tensor(valid_frames, device=device) * f).to(torch.int32)
    q = torch.tensor(quantile, dtype=torch.float32, device=n.device)
    k = torch.floor(q * n.to(torch.float32)).to(torch.int32)
    return torch.minimum(n - 1, k).to(torch.int64)


def _row_valid(t: int, valid_frames, device) -> torch.Tensor:
    return torch.arange(t, device=device) < torch.as_tensor(valid_frames, device=device)


def quantile_threshold(responses: torch.Tensor, quantile: float, valid_frames=None,
                       method: str = "radix") -> torch.Tensor:
    """Per-channel exact order-statistic threshold over the valid cells.

    responses [T', F', C] float32; valid_frames: an int (rows below it
    are real; None: all T' rows).  Returns [C] float32
    tau_c = sorted(valid r_c)[k], k = min(n-1, floor(f32(q) * f32(n))).
    ``method="radix"`` selects by ``radix_kth_smallest``; ``"sort"`` is
    the readable spec, a stable sort of the floats with the invalid
    cells set to +inf.  Each is bit for bit the reference's method of
    the same name; the two agree in value (at a zero threshold the sign
    may differ: the keys order -0.0 below +0.0, the sort keeps equal
    zeros in place)."""
    t, f, c = responses.shape
    dev = responses.device
    flat = responses.reshape(t * f, c)
    k = _order_statistic_rank(t, f, quantile, valid_frames, dev)
    cell_valid = None
    if valid_frames is not None:
        cell_valid = _row_valid(t, valid_frames, dev).repeat_interleave(f)[:, None]
    if method == "sort":
        if cell_valid is not None:
            flat = torch.where(cell_valid, flat, torch.full_like(flat, float("inf")))
        return torch.sort(flat, dim=0, stable=True).values[k]
    keys = order_keys(flat)
    if cell_valid is not None:
        keys = torch.where(cell_valid, keys, torch.full_like(keys, MASKED_KEY))
    if method != "radix":
        raise ValueError(f"method must be 'radix' or 'sort', got {method!r}")
    return key_to_float(radix_kth_smallest(keys, k))


def binarize(responses: torch.Tensor, quantile: float, valid_frames=None) -> torch.Tensor:
    """Strict-threshold binarization [T', F', C] -> bool; rows at or
    past ``valid_frames`` are False."""
    tau = quantile_threshold(responses, quantile, valid_frames)
    binary = responses > tau[None, None, :]
    if valid_frames is not None:
        binary = mask_rows(binary, valid_frames)
    return binary


def spread_binary(binary: torch.Tensor, spread_time: int, spread_freq: int) -> torch.Tensor:
    """Binary dilation by a (2rt+1) x (2rf+1) rectangle, zero-padded:
    an OR of shifts along time, then along frequency.
    [..., T', F', C] bool -> the same."""
    if spread_time == 0 and spread_freq == 0:
        return binary
    out = _dilate_axis(binary, spread_time, binary.dim() - 3)
    return _dilate_axis(out, spread_freq, binary.dim() - 2)


def mask_rows(binary: torch.Tensor, valid_frames) -> torch.Tensor:
    """Rows at or past ``valid_frames`` set False (after the spread)."""
    return binary & _row_valid(binary.shape[0], valid_frames, binary.device)[:, None, None]
