"""Corpus adapters for the scan.

Counterpart of ``template_speech_recognition_tpu.pipeline``'s
``SyntheticAdapter`` and ``TimitAdapter``: the scan reads
``sample_rate`` and iterates ``(utt_id, waveform, [(phone,
start_sample, end_sample)])``; training reads ``exemplar_clips`` and
``background_clips``.
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


@dataclasses.dataclass
class TimitAdapter:
    """A TIMIT tree (``io.corpus.TimitCorpus``) as a corpus, over one
    split or (``split=None``) all records.  ``sample_rate`` is the last
    decoded or probed utterance's, updated while iterating, as in the
    reference: the scans read it after their loop."""

    corpus: object  # io.corpus.TimitCorpus
    split: str | None = None
    sample_rate: int = 16000

    def _records(self):
        return self.corpus.split(self.split) if self.split else self.corpus.records

    def _phones(self, rec):
        return [(s.phone, s.start_sample, s.end_sample) for s in self.corpus.load_phones(rec)]

    def iter_utterances(self):
        for rec in self._records():
            wav, sr = self.corpus.load_waveform(rec)
            self.sample_rate = sr
            yield rec.utt_id, wav, self._phones(rec)

    def iter_utterance_infos(self):
        """(utt_id, num_samples, phones) from the audio headers and the
        ``.phn`` text alone: no sample is decoded."""
        for rec in self._records():
            ns, sr = self.corpus.load_info(rec)
            self.sample_rate = sr
            yield rec.utt_id, ns, self._phones(rec)

    def get_waveform(self, gidx: int):
        wav, _sr = self.corpus.load_waveform(self._records()[gidx])
        return wav

    def exemplar_clips(self, phone):
        return self.corpus.exemplar_clips(phone, self.split)

    def background_clips(self, phone):
        return self.corpus.background_clips(phone, self.split)
