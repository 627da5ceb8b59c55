"""Plane-major frontend: waveforms -> flat binary feature map.

Counterpart of ``template_speech_recognition_tpu.frontend.planes``
(``frontend_batch_flat``, ``response_planes``, ``plane_order_statistics``,
``binarize_spread_flat``, ``_windowed_frames``, ``_dual_ranks``).  Two
paths compute one map, bit for bit:

* the two-kernel path: the response planes (``ops.frontend_kernel``)
  and the select + binarize + spread (``ops.selbin_kernel``), so the
  planes cross device memory once between them;
* the layered path: the same planes kernel, then the order statistics
  by a radix select that is one kernel call (``ops.radix_kernel``:
  three histogram levels read the float planes, the digits are picked
  on the device, no host sync), then binarize + frequency and time
  spread + the row mask in one kernel (``ops.binspread_kernel``).

``frontend_batch_flat`` takes the two-kernel path wherever both of its
kernels take the shape (F a multiple of 4 and a DFT width of at most
992), at any T, and the layered path otherwise: log-mel at n_mels 64
(F = 63) is layered.  The rule reads shapes only, so the CPU runs the
path the card runs.

The output is the flat channel-major map [B, T_pad, D = 8*F'] (d =
e*F' + f; channel 2i = plane i > its rank-k statistic, channel 2i+1 =
plane i < its rank-(n-1-k) statistic) with T_pad = frames rounded up
to 128 on every device; rows >= valid are False.  (On the CPU the JAX
reference takes its XLA path and returns T - 1 rows; the rows below
valid are the same.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.ops import frontend_kernel, framing
from template_speech_recognition_tpu_torch.ops.binspread_kernel import (
    binarize_freqspread,
    binarize_freqspread_plain,
)
from template_speech_recognition_tpu_torch.ops.radix_kernel import (
    radix_select,
    radix_select_plain,
)
from template_speech_recognition_tpu_torch.ops.selbin_kernel import (
    select_binspread,
    select_binspread_plain,
)


class FlatFeatureMap(NamedTuple):
    """Flat binary edge map [B, T, D] (d = e*F' + f) + valid rows."""

    binary: torch.Tensor        # [B, T_pad, E*F'] bool (invalid rows False)
    valid_frames: torch.Tensor  # [B] int32: rows < valid are real


def _fused_ok(cfg: FrontendConfig) -> bool:
    """Shapes both kernels of the two-kernel path take: F a multiple
    of 4 (kernel 1 takes any n_mels, past ``MAX_MELS`` in chunks).
    Unlike the reference, no budget on T: its select keeps a whole plane resident
    in VMEM up to 786,432 cells; the port's keeps it resident in a
    16-CTA cluster's shared memory up to T = 3264 at F = 256 and takes
    larger planes by its multipass variant (``ops.selbin_kernel.route``),
    which streams them through L2 in radix passes."""
    return (
        frontend_kernel.supported(cfg.nfft, cfg.n_mels if cfg.use_mel else 0)
        and cfg.feature_freqs % 4 == 0
    )


def _windowed_frames(waveforms: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] -> [B, T, frame_length] preemphasized windowed frames."""
    y = framing.preemphasize(waveforms, cfg.preemphasis)
    frames = framing.frame_signal(y, cfg.frame_length, cfg.hop_length)
    return frames * framing.hamming_window(cfg.frame_length, waveforms.device)


def _stacked_planes(frames: torch.Tensor, cfg: FrontendConfig,
                    plain: bool) -> torch.Tensor:
    """[B, T, frame_length] -> plane-major [4, B*T_pad, F] (T_pad = T
    rounded up to 128; rows >= T - 1 are garbage)."""
    b, t, fl = frames.shape
    t_pad = ((t + 127) // 128) * 128
    fp = torch.zeros((b, t_pad, fl), dtype=torch.float32, device=frames.device)
    fp[:, :t] = frames
    fn = (frontend_kernel.edge_response_planes_plain if plain
          else frontend_kernel.edge_response_planes)
    return fn(
        fp.reshape(b * t_pad, fl), cfg.nfft, sample_rate=cfg.sample_rate,
        n_mels=cfg.n_mels if cfg.use_mel else 0,
    )


def response_planes(frames: torch.Tensor, cfg: FrontendConfig,
                    plain: bool = False) -> torch.Tensor:
    """Windowed frames [B, T, frame_length] -> the four oriented
    difference planes [B, 4, T_pad, F'] as a view of the kernel's
    plane-major output (rows >= T - 1 are garbage; callers mask them
    by valid_frames, which is always <= T - 1)."""
    b = frames.shape[0]
    stacked = _stacked_planes(frames, cfg, plain)
    return stacked.reshape(4, b, -1, stacked.shape[-1]).transpose(0, 1)


def plane_order_statistics(
    planes: torch.Tensor,         # [B, P, T, F]
    valid_frames: torch.Tensor,   # [B] int
    quantile: float,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact order statistics of each plane's valid cells at ranks
    k = min(n-1, floor(f32(q) * f32(n))) and n-1-k: (os_k, os_{n-1-k}),
    each [B, P] float32, bitwise those of the reference.

    The ranks (``_dual_ranks``), then one call of the radix select
    (``ops.radix_kernel.radix_select``, or its plain version, the
    reference's 11-level schedule, with ``plain``) on the plane-major
    storage [P, B, T, F]: the layered path hands over a [B, P] view of
    kernel 1's plane-major output, whose transpose is already
    contiguous; any other layout is copied into it first.  Valid frames
    above T count as T (the frontend passes none: its valid frames are
    at most T - 1), so that the kernel and its plain version see the
    same n."""
    t, f = planes.shape[-2:]
    vf = valid_frames.to(device=planes.device, dtype=torch.int32).clamp(max=t)
    need = _dual_ranks(vf, f, quantile)
    fn = radix_select_plain if plain else radix_select
    return fn(planes.transpose(0, 1).contiguous(), vf, need)


def binarize_spread_flat(
    planes: torch.Tensor,         # [B, P, T, F]
    os_hi: torch.Tensor,          # [B, P] rank-k order statistic
    os_lo: torch.Tensor,          # [B, P] rank-(n-1-k) order statistic
    valid_frames: torch.Tensor,   # [B]
    spread_time: int,
    spread_freq: int,
    plain: bool = False,
) -> torch.Tensor:                # [B, T, 2P*F] bool
    """Binarize both polarities of each plane, dilate, emit the flat
    map.  On the card one kernel launch (``ops.binspread_kernel``) does
    it all, the time dilation and the row mask included; with ``plain``,
    and on the CPU, the kernel's plain version does the same.  The u8
    map is returned viewed as bool (no copy)."""
    fn = binarize_freqspread_plain if plain else binarize_freqspread
    vf = valid_frames.to(device=planes.device, dtype=torch.int32)
    return fn(planes, os_hi.contiguous(), os_lo.contiguous(), vf, spread_freq,
              spread_time).view(torch.bool)


def _dual_ranks(valid_frames: torch.Tensor, f: int, quantile: float) -> torch.Tensor:
    """[B] valid frames -> [B, 2] int32 (rank+1) for ranks k and n-1-k,
    k = min(n-1, floor(f32(q) * f32(n))) computed in float32 exactly as
    the reference does."""
    n = (valid_frames.to(torch.int32) * f).to(torch.int32)
    k1 = torch.minimum(
        n - 1,
        torch.floor(n.to(torch.float32) * float(np.float32(quantile))).to(
            torch.int32
        ),
    )
    k2 = n - 1 - k1
    return (torch.stack([k1, k2], dim=-1) + 1).to(torch.int32)


def frontend_batch_flat(
    waveforms: torch.Tensor,          # [B, S] padded
    num_valid_samples: torch.Tensor,  # [B]
    cfg: FrontendConfig,
    plain: bool = False,
    layered: bool | None = None,
) -> FlatFeatureMap:
    """[B, S] padded waveforms -> flat binary feature maps.

    ``layered`` picks the path (None: the two-kernel path where its
    kernels take the shape, else the layered one); both give the same
    map.  ``plain=True`` runs the kernels' plain PyTorch versions on any
    device (the reference the kernels are held against)."""
    dev = waveforms.device
    frames = _windowed_frames(waveforms, cfg)
    nv = num_valid_samples.to(device=dev, dtype=torch.int32)
    valid_frames = torch.where(
        nv >= cfg.frame_length,
        torch.div(nv - cfg.frame_length, cfg.hop_length, rounding_mode="floor"),
        torch.zeros_like(nv),
    ).to(torch.int32)
    if layered is None:
        layered = not _fused_ok(cfg)
    if layered:
        planes = response_planes(frames, cfg, plain=plain)
        os_hi, os_lo = plane_order_statistics(
            planes, valid_frames, cfg.edge_quantile, plain=plain
        )
        flat = binarize_spread_flat(
            planes, os_hi, os_lo, valid_frames, cfg.spread_time,
            cfg.spread_freq, plain=plain,
        )
        return FlatFeatureMap(flat, valid_frames)
    b, f = frames.shape[0], cfg.feature_freqs
    stacked = _stacked_planes(frames, cfg, plain)               # [4, B*T_pad, F]
    need = _dual_ranks(valid_frames, f, cfg.edge_quantile)
    selbin_fn = select_binspread_plain if plain else select_binspread
    flat_u8, _keys = selbin_fn(
        stacked.reshape(4, b, -1, f), need, valid_frames,
        cfg.spread_freq, cfg.spread_time,
    )
    return FlatFeatureMap(flat_u8.to(torch.bool), valid_frames)
