"""The scan's batches, reckoned from the lengths fed to it.

``scan.stream_scan`` groups utterances into buckets of 16,384 samples
(``bucket_length``), dispatches a batch whenever a bucket holds
``batch_size`` of them, and at the end one tail batch a bucket, in
order of length, shrunk to the next power of two that holds its rows.
That is a pure function of the lengths, so the harness works out each
batch's shape without reading the program.  A copy of
``template_speech_recognition_tpu_torch/scan.py``'s ``bucket_length``
and of its loop's grouping.
"""

from __future__ import annotations

import dataclasses

QUANTUM = 16384


def bucket_length(n: int, quantum: int = QUANTUM) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


@dataclasses.dataclass(frozen=True)
class Batch:
    pad: int        # samples a row
    rows: int       # rows of the batch (a tail's shrunk to a power of two)
    used: int       # utterances in it


class Mirror:
    """Follows the scan's bucketing one utterance at a time."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.pending: dict[int, int] = {}
        self.batches: list[Batch] = []

    def feed(self, n_samples: int) -> None:
        pad = bucket_length(n_samples)
        self.pending[pad] = self.pending.get(pad, 0) + 1
        if self.pending[pad] == self.batch_size:
            del self.pending[pad]
            self.batches.append(Batch(pad, self.batch_size, self.batch_size))

    def close(self) -> list[Batch]:
        """The tail batches, in order of length; returns every batch."""
        for pad in sorted(self.pending):
            used = self.pending[pad]
            rows = 1
            while rows < used:
                rows *= 2
            self.batches.append(Batch(pad, min(rows, self.batch_size), used))
        self.pending = {}
        return self.batches


def plan(lengths, batch_size: int) -> list[Batch]:
    m = Mirror(batch_size)
    for n in lengths:
        m.feed(n)
    return m.close()
