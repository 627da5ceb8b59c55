"""Tracing, op cost models and roofline accounting.

Counterpart of ``template_speech_recognition_tpu.utils.profiling``:

* ``profile_trace`` / ``named_scope`` -- ``torch.profiler`` around a
  region, with a Chrome trace written into a directory, and named ranges
  for the pipeline's stages (a ``record_function`` range, which the
  profiler records, and an NVTX range where CUDA is present, which
  Nsight tools read);
* ``CostModel`` -- FLOPs and compulsory device-memory bytes of the hot
  ops from their shapes: hardware-independent, the reference's numbers
  exactly;
* ``roofline_report`` -- a measured time against the compute and memory
  bounds of those costs;
* ``CostModel.frontend_fused_roofline`` -- the two-kernel frontend
  (kernel 1's planes, kernel 2's select + binarize + spread) against
  four resources of the card: the tensor cores, the SMs' integer issue,
  shared-memory bandwidth and device memory.

The peak rates are those of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` names the card; a card set below 700 W runs
slower under load.  No rate here is a TPU's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.profiler import record_function

# NVIDIA H100 80GB HBM3, 700 W: dense peak rates from the data sheet
HBM_BYTES_PER_S = 3.35e12      # device memory (HBM3)
PEAK_FP32_FLOPS = 67e12        # fp32 on the SMs, outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 tensor cores
PEAK_INT8_OPS = 1979e12        # int8 tensor cores
# NVIDIA H100 80GB HBM3, 700 W: the SM count (torch.cuda.get_device_properties
# (0).multi_processor_count) and the SM clock's maximum (nvidia-smi
# --query-gpu=clocks.max.sm) behind the two per-SM rates below
H100_SM_COUNT = 132
H100_SM_CLOCK_HZ = 1.98e9
INT32_LANES_PER_SM = 64        # Hopper: 16 INT32 lanes in each of 4 sub-partitions
SMEM_BYTES_PER_SM_CLOCK = 128  # shared memory: 32 banks x 4 bytes a clock


def sm_int_ops_per_s(sm_count: int = H100_SM_COUNT,
                     sm_clock_hz: float = H100_SM_CLOCK_HZ) -> float:
    """The SMs' 32-bit integer issue rate, operations a second."""
    return sm_count * INT32_LANES_PER_SM * sm_clock_hz


def smem_bytes_per_s(sm_count: int = H100_SM_COUNT,
                     sm_clock_hz: float = H100_SM_CLOCK_HZ) -> float:
    """Shared-memory bandwidth summed over the SMs, bytes a second."""
    return sm_count * SMEM_BYTES_PER_SM_CLOCK * sm_clock_hz


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the region with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``; yields the profiler.
    A no-op that yields None for ``log_dir=None``."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def named_scope(name: str):
    """Name a region for traces; usable as a context or a decorator.
    Opens a ``record_function`` range and, where CUDA is present, an
    NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Hardware-independent cost of one op invocation."""

    flops: float          # multiply-accumulates x2
    hbm_bytes: float      # compulsory device-memory traffic (reads + writes)

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes)


class CostModel:
    """Shape -> (FLOPs, bytes) of the hot ops: compulsory costs (ideal
    fusion, each operand touched once), the reference's formulas."""

    @staticmethod
    def direct_scores(b, t, k, length, d, bytes_per_el=2) -> OpCost:
        """Direct sliding correlation (the conv, kernel 10).  Counts T
        starts a map, as the reference does; the kernel computes the
        T - L + 1 valid ones."""
        flops = 2.0 * b * t * k * length * d
        bytes_ = (b * t * d + k * length * d) * bytes_per_el + b * t * k * 4
        return OpCost(flops, bytes_)

    @staticmethod
    def fft_scores(b, t, k, length, d, nfft, bytes_per_el=2) -> OpCost:
        """Overlap-save frequency-domain scoring (``detect.fft_scorer``)."""
        bins = nfft // 2 + 1
        hop = nfft - length + 1
        nblk = -(-(t - length + 1) // hop)
        m = b * nblk
        flops = (
            2.0 * m * nfft * 2 * bins * d      # forward DFT GEMM
            + 2.0 * bins * 2 * m * 2 * d * k   # per-bin complex GEMM
            + 2.0 * hop * 2 * bins * m * k     # inverse DFT GEMM
        )
        bytes_ = (
            b * t * d * bytes_per_el           # features in
            + bins * 2 * d * k * bytes_per_el  # spectra bank stream
            + b * t * k * 4                    # scores out
        )
        return OpCost(flops, bytes_)

    @staticmethod
    def frontend(b, samples, frame_length, hop_length, nfft, n_mels=0) -> OpCost:
        """DFT [+ mel] + log + edge frontend per batch."""
        t = max(1 + (samples - frame_length) // hop_length, 0)
        bins = nfft // 2 + 1
        flops = 2.0 * b * t * frame_length * 2 * bins
        if n_mels:
            flops += 2.0 * b * t * bins * n_mels
        f_out = (n_mels - 1) if n_mels else nfft // 2
        bytes_ = b * (samples * 4 + t * f_out * 8 * 4)
        return OpCost(flops, bytes_)

    @staticmethod
    def frontend_fused_roofline(
        b, samples, frame_length, hop_length, nfft, n_mels=0,
        spread_time=1, spread_freq=1,
        sm_count=H100_SM_COUNT, sm_clock_hz=H100_SM_CLOCK_HZ,
    ) -> dict:
        """Four-resource roofline of the two-kernel frontend on the card
        (kernel 1: the planes; kernel 2: the select + binarize + spread):

        * tensor: kernel 1's DFT (and mel) GEMM as three TF32 passes
          (hi.hi + hi.lo + lo.hi), 3 x 2 x T x FL x 2 x bins flops an
          utterance at the TF32 peak;
        * sm_int: kernel 2's integer work a plane cell: the order key
          (3), the level-0 digit and its count (2), the level-1 digit
          and its test against both ranks' prefixes (4), both
          polarities' compares and bits (4), and the dilation's word
          operations (2 channels x 2 (rt + rf) words of 32 cells); the
          later levels count only candidates, left out; at 64 INT32
          lanes an SM a clock;
        * smem: kernel 2's resident keys: each plane cell lands in
          shared memory (4 bytes), is read as a float and written back
          as a key (8), and read at level 1 and at binarize (8); at 128
          bytes an SM a clock;
        * memory: the waveform in, the frames written and read, the
          planes written once and read once, the u8 map out.

        ``sm_count`` and ``sm_clock_hz`` set the two SM rates (the
        card's own values: ``torch.cuda.get_device_properties`` and
        ``nvidia-smi --query-gpu=clocks.max.sm``).  Returns each
        resource's seconds, the binding one's name and its seconds."""
        t = max(1 + (samples - frame_length) // hop_length, 0)
        f_out = (n_mels - 1) if n_mels else nfft // 2
        bins = nfft // 2 + 1
        cells = 4.0 * b * t * f_out
        tensor = 3 * 2.0 * b * t * frame_length * 2 * bins
        if n_mels:
            tensor += 3 * 2.0 * b * t * bins * n_mels
        int_ops = cells * (3 + 2 + 4 + 4 + 2 * 2 * (spread_time + spread_freq) / 32.0)
        smem = cells * (4 + 8 + 8)
        hbm = b * (
            samples * 4.0
            + t * frame_length * 8.0
            + 4 * t * f_out * 8.0
            + t * f_out * 8.0
        )
        secs = {
            "tensor": tensor / PEAK_TF32_FLOPS,
            "sm_int": int_ops / sm_int_ops_per_s(sm_count, sm_clock_hz),
            "smem": smem / smem_bytes_per_s(sm_count, sm_clock_hz),
            "memory": hbm / HBM_BYTES_PER_S,
        }
        name = max(secs, key=secs.get)
        return {**{f"{k}_s": v for k, v in secs.items()},
                "bound": name, "roofline_s": secs[name]}

    @staticmethod
    def dtw(n_pairs, length, m, band, lanes=None) -> OpCost:
        """Banded wavefront DTW over the skewed cost stream."""
        lanes = lanes if lanes is not None else length
        k_diag = length + m - 1
        flops = 5.0 * n_pairs * k_diag * lanes   # ~5 min/add ops a lane-cell
        bytes_ = n_pairs * (k_diag * lanes * 4 + 4)
        return OpCost(flops, bytes_)


def roofline_report(
    cost: OpCost,
    measured_s: float,
    peak_flops: float = PEAK_BF16_FLOPS,
    hbm_bytes_per_s: float = HBM_BYTES_PER_S,
) -> dict:
    """A measured time against the compute and memory bounds: both
    bounds, which one binds, and the share of it reached (1.0 = the
    bound)."""
    t_compute = cost.flops / peak_flops
    t_memory = cost.hbm_bytes / hbm_bytes_per_s
    bound = "compute" if t_compute >= t_memory else "memory"
    t_bound = max(t_compute, t_memory)
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "bound": bound,
        "roofline_s": t_bound,
        "roofline_frac": (t_bound / measured_s) if measured_s > 0 else 0.0,
        "measured_s": measured_s,
    }
