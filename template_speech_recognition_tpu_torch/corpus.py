"""Corpus adapters for the scan.

Counterpart of ``template_speech_recognition_tpu.pipeline``'s
``SyntheticAdapter``: the scan reads ``sample_rate`` and iterates
``(utt_id, waveform, [(phone, start_sample, end_sample)])``; training
reads ``exemplar_clips`` and ``background_clips``.
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

    def iter_utterance_infos(self):
        """(utt_id, num_samples, phones): metadata only, no waveform;
        pairs with ``get_waveform``."""
        for utt in self.corpus.utterances:
            yield utt.utt_id, len(utt.waveform), list(utt.phones)

    def get_waveform(self, gidx: int):
        return self.corpus.utterances[gidx].waveform

    def exemplar_clips(self, phone):
        return self.corpus.exemplar_clips(phone)

    def background_clips(self, phone):
        """Spans of any phone but ``phone`` (the background model)."""
        return self.corpus.background_clips(phone)
