"""The table of peaks and the work formulas that the per-layer metrics
hold times against.

Peaks: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, dense
rates from NVIDIA's data sheet; a copy of
``template_speech_recognition_tpu_torch/utils/profiling.py``'s
``HBM_BYTES_PER_S`` and ``PEAK_*``.  A card set below 700 W runs slower
under load, so every share is reported beside the card's power limit.

``fft_scores`` and ``frontend`` are frozen copies of that module's
``CostModel.fft_scores`` and ``CostModel.frontend`` (operations and
compulsory device-memory bytes from shapes, each operand touched once),
with the spectra's element size apart from the map's.
"""

from __future__ import annotations

from benchmark.harness.buckets import Batch

HBM_BYTES_PER_S = 3.35e12
PEAK = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "int8": 1979e12,
}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def fft_scores(b, t, k, length, d, nfft, map_bytes=2, spectra_bytes=2):
    """(operations, bytes) of overlap-save scoring of ``b`` maps of ``t``
    frames against ``k`` templates of ``length`` frames and ``d``
    features: the forward block DFT, the per-bin complex product and the
    inverse DFT of each block's first hop; the map read, the spectra
    streamed once and the f32 scores written."""
    bins = nfft // 2 + 1
    hop = nfft - length + 1
    nblk = -(-(t - length + 1) // hop)
    m = b * nblk
    ops = (2.0 * m * nfft * 2 * bins * d
           + 2.0 * bins * 2 * m * 2 * d * k
           + 2.0 * hop * 2 * bins * m * k)
    nbytes = b * t * d * map_bytes + bins * 2 * d * k * spectra_bytes + b * t * k * 4
    return ops, nbytes


def frontend(b, samples, frame_length, hop_length, nfft):
    """(operations, bytes) of the log-magnitude edge frontend a batch."""
    t = max(1 + (samples - frame_length) // hop_length, 0)
    bins = nfft // 2 + 1
    ops = 2.0 * b * t * frame_length * 2 * bins
    nbytes = b * (samples * 4 + t * (nfft // 2) * 8 * 4)
    return ops, nbytes


def binmm(b, t, k, length, d, nfft, operand_bytes):
    """(operations, bytes) of the per-bin complex product alone (kernel 4
    or 6): the block spectra X and W2 read once, one f32 output plane
    written once."""
    bins = nfft // 2 + 1
    hop = nfft - length + 1
    m = b * -(-(t - length + 1) // hop)
    ops = 2.0 * bins * 2 * m * 2 * d * k
    nbytes = (bins * 2 * m * d + bins * 2 * d * k) * operand_bytes + bins * 2 * m * k * 4
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time: operations at ``peak`` or bytes at the HBM rate."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def map_frames(batch: Batch, fcfg: dict) -> int:
    """Feature frames of a batch's padded rows (frames - 1)."""
    return (batch.pad - fcfg["frame_length"]) // fcfg["hop_length"]


def scan_shape(batch: Batch, cell) -> dict:
    """The keyword arguments of ``fft_scores`` / ``binmm`` for a batch."""
    fcfg, bank = cell.config["pipeline"]["frontend"], cell.config["bank"]
    return dict(b=batch.rows, t=map_frames(batch, fcfg), k=bank["num_templates"],
                length=bank["template_length"], d=(fcfg["nfft"] // 2) * 8,
                nfft=cell.config["nfft"])
