"""TIMIT-style corpus access.

The port's own copy of ``template_speech_recognition_tpu.io.corpus``.
Walks a TIMIT directory tree (``<root>/<SPLIT>/<DIALECT>/<SPEAKER>/
<UTT>.{wav,phn}``), parses sample-aligned ``.phn`` phone
transcriptions, and serves labelled exemplar and background spans with
explicit splits.  Works alike on real TIMIT and on the synthetic tree
that ``io.fixtures.write_synthetic_timit`` writes.  Decoding is host
work: the native reader where its library loads, else the Python
readers, bit for bit the same samples.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from template_speech_recognition_tpu_torch.io.audio import read_audio as _read_audio_py


def read_audio(path: str):
    """The native C++ decoder (``io.native``) where its library loads,
    else the Python readers: the same samples bit for bit."""
    from template_speech_recognition_tpu_torch.io import native

    if native.available():
        return native.read_audio(path)
    return _read_audio_py(path)


@dataclasses.dataclass(frozen=True)
class PhoneSpan:
    phone: str
    start_sample: int
    end_sample: int


@dataclasses.dataclass(frozen=True)
class UtteranceRecord:
    utt_id: str          # e.g. "TRAIN/DR1/SPK0/SA1"
    wav_path: str
    phn_path: str

    @property
    def split(self) -> str:
        return self.utt_id.split("/")[0].upper()

    @property
    def dialect(self) -> str:
        parts = self.utt_id.split("/")
        return parts[1] if len(parts) > 2 else ""

    @property
    def speaker(self) -> str:
        parts = self.utt_id.split("/")
        return parts[2] if len(parts) > 3 else ""


def parse_phn(path: str) -> list[PhoneSpan]:
    """``.phn`` lines: ``<start_sample> <end_sample> <phone>``."""
    spans = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            spans.append(PhoneSpan(parts[2], int(parts[0]), int(parts[1])))
    return spans


class TimitCorpus:
    """Iterate a TIMIT-layout corpus rooted at ``root``."""

    def __init__(self, root: str):
        self.root = root
        self.records: list[UtteranceRecord] = []
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            for fn in sorted(filenames):
                if not fn.lower().endswith(".wav"):
                    continue
                stem = os.path.join(dirpath, fn[:-4])
                phn = None
                for ext in (".phn", ".PHN"):
                    if os.path.exists(stem + ext):
                        phn = stem + ext
                        break
                if phn is None:
                    continue
                rel = os.path.relpath(stem, root)
                self.records.append(
                    UtteranceRecord(rel.replace(os.sep, "/"), os.path.join(dirpath, fn), phn)
                )
        if not self.records:
            raise FileNotFoundError(f"no .wav/.phn pairs under {root}")

    def split(self, name: str) -> list[UtteranceRecord]:
        name = name.upper()
        return [r for r in self.records if r.split == name]

    def load_waveform(self, rec: UtteranceRecord) -> tuple[np.ndarray, int]:
        return read_audio(rec.wav_path)

    def load_info(self, rec: UtteranceRecord) -> tuple[int, int]:
        """(num_samples, sample_rate) from the audio header only."""
        from template_speech_recognition_tpu_torch.io.audio import read_audio_info

        return read_audio_info(rec.wav_path)

    def load_phones(self, rec: UtteranceRecord) -> list[PhoneSpan]:
        return parse_phn(rec.phn_path)

    def occurrences(
        self, phone: str, split: str | None = None
    ) -> list[tuple[UtteranceRecord, PhoneSpan]]:
        recs = self.split(split) if split else self.records
        out = []
        for rec in recs:
            for span in self.load_phones(rec):
                if span.phone == phone:
                    out.append((rec, span))
        return out

    def exemplar_clips(self, phone: str, split: str | None = None) -> list[np.ndarray]:
        """Waveform clips of every occurrence of ``phone``."""
        out = []
        cache: dict[str, np.ndarray] = {}
        for rec, span in self.occurrences(phone, split):
            if rec.utt_id not in cache:
                cache[rec.utt_id], _sr = self.load_waveform(rec)
            out.append(cache[rec.utt_id][span.start_sample : span.end_sample])
        return out

    def background_clips(
        self, exclude: str, split: str | None = None, max_clips: int = 64
    ) -> list[np.ndarray]:
        """Spans of any phone other than ``exclude`` (negative model)."""
        out = []
        recs = self.split(split) if split else self.records
        for rec in recs:
            wav, _sr = self.load_waveform(rec)
            for span in self.load_phones(rec):
                if span.phone != exclude:
                    out.append(wav[span.start_sample : span.end_sample])
                    if len(out) >= max_clips:
                        return out
        return out

    def phone_inventory(self) -> list[str]:
        names = set()
        for rec in self.records:
            for span in self.load_phones(rec):
                names.add(span.phone)
        return sorted(names)
