"""Audio and corpus input: WAV and NIST SPHERE (``audio``), the native
reader (``native``), TIMIT trees (``corpus``) and the synthetic tree
writer (``fixtures``).  The port's own copy of the reference's ``io``."""

from template_speech_recognition_tpu_torch.io.audio import (
    read_audio,
    read_wav,
    write_wav,
    read_sphere,
    write_sphere,
)
from template_speech_recognition_tpu_torch.io.corpus import TimitCorpus, PhoneSpan
from template_speech_recognition_tpu_torch.io.fixtures import write_synthetic_timit

__all__ = [
    "read_audio",
    "read_wav",
    "write_wav",
    "read_sphere",
    "write_sphere",
    "TimitCorpus",
    "PhoneSpan",
    "write_synthetic_timit",
]
