"""Write the synthetic corpus as a TIMIT-layout directory tree.

The port's own copy of ``template_speech_recognition_tpu.io.fixtures``:
at the same arguments it writes a tree byte-identical to the
reference's.  Bridges ``oracle.fixtures.make_synthetic_corpus`` (the
in-memory generator shared with the oracle tests) to the on-disk
layout ``TimitCorpus`` reads, alternating WAV and NIST SPHERE
containers so both readers get exercised.
"""

from __future__ import annotations

import os

from template_speech_recognition_tpu_torch.io.audio import write_sphere, write_wav


def write_synthetic_timit(
    root: str,
    num_train: int = 8,
    num_test: int = 4,
    phones_per_utterance: int = 8,
    seed: int = 0,
    sample_rate: int = 16000,
) -> None:
    """Generate and write a synthetic TIMIT-like tree under ``root``."""
    from oracle.fixtures import make_synthetic_corpus

    corpus = make_synthetic_corpus(
        num_utterances=num_train + num_test,
        phones_per_utterance=phones_per_utterance,
        seed=seed,
        sample_rate=sample_rate,
    )
    for i, utt in enumerate(corpus.utterances):
        split = "TRAIN" if i < num_train else "TEST"
        speaker = f"SPK{i % 4}"
        d = os.path.join(root, split, "DR1", speaker)
        os.makedirs(d, exist_ok=True)
        stem = os.path.join(d, utt.utt_id.upper())
        if i % 2 == 0:
            write_wav(stem + ".wav", utt.waveform, sample_rate)
        else:
            write_sphere(stem + ".wav", utt.waveform, sample_rate)
        with open(stem + ".phn", "w") as f:
            for phone, s, e in utt.phones:
                f.write(f"{s} {e} {phone}\n")
