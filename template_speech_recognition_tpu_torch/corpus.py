"""Corpus adapters for the scan.

Counterpart of ``template_speech_recognition_tpu.pipeline``'s
``SyntheticAdapter``: the scan reads ``sample_rate`` and iterates
``(utt_id, waveform, [(phone, start_sample, end_sample)])``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SyntheticAdapter:
    corpus: object  # oracle.fixtures.SyntheticCorpus

    @property
    def sample_rate(self) -> int:
        return self.corpus.sample_rate

    def iter_utterances(self):
        for utt in self.corpus.utterances:
            yield utt.utt_id, utt.waveform, list(utt.phones)
