"""Synthetic TIMIT-like speech.

A frozen copy of ``oracle/fixtures.py`` (``PhoneSpec``,
``DEFAULT_PHONES``, ``_synth_phone`` and the silence / phone alternation
of ``make_synthetic_corpus``), rewritten to make one utterance of an
exact number of samples: phones are drawn until the utterance is long
enough, and the last one is cut.  TIMIT is not on this machine; each
phone is a formant-like sum of sinusoids plus noise, so the edge
features have the structure of speech.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PhoneSpec:
    name: str
    formants_hz: tuple[float, ...]
    min_ms: float
    max_ms: float
    amp: float = 1.0
    noise: float = 0.05


# index 0 is silence
DEFAULT_PHONES: tuple[PhoneSpec, ...] = (
    PhoneSpec("sil", (), 40.0, 160.0, amp=0.0, noise=0.02),
    PhoneSpec("aa", (730.0, 1090.0, 2440.0), 60.0, 180.0),
    PhoneSpec("iy", (270.0, 2290.0, 3010.0), 50.0, 150.0),
    PhoneSpec("uw", (300.0, 870.0, 2240.0), 50.0, 150.0),
    PhoneSpec("eh", (530.0, 1840.0, 2480.0), 50.0, 140.0),
    PhoneSpec("s", (4500.0, 6000.0), 60.0, 160.0, amp=0.5, noise=0.4),
    PhoneSpec("sh", (2200.0, 3300.0), 60.0, 160.0, amp=0.5, noise=0.35),
    PhoneSpec("m", (250.0, 1000.0), 40.0, 120.0, amp=0.6),
    PhoneSpec("r", (490.0, 1350.0, 1690.0), 40.0, 120.0),
    PhoneSpec("k", (1800.0, 4000.0), 20.0, 70.0, amp=0.7, noise=0.3),
)


def synth_phone(spec: PhoneSpec, num_samples: int, sr: int,
                rng: np.random.Generator) -> np.ndarray:
    t = np.arange(num_samples, dtype=np.float64) / sr
    x = np.zeros(num_samples, dtype=np.float64)
    for i, f in enumerate(spec.formants_hz):
        f_jit = f * (1.0 + rng.uniform(-0.03, 0.03))
        phase = rng.uniform(0.0, 2.0 * np.pi)
        x += spec.amp * (0.7 ** i) * np.sin(2.0 * np.pi * f_jit * t + phase)
    x += spec.noise * rng.standard_normal(num_samples)
    # 5 ms onset / offset ramps
    ramp = min(num_samples // 4, int(0.005 * sr))
    if ramp > 0:
        env = np.ones(num_samples)
        env[:ramp] = np.linspace(0.0, 1.0, ramp)
        env[-ramp:] = np.linspace(1.0, 0.0, ramp)
        x *= env
    return x.astype(np.float32)


def utterance(num_samples: int, sr: int, rng: np.random.Generator,
              phones: tuple[PhoneSpec, ...] = DEFAULT_PHONES) -> np.ndarray:
    """One waveform of exactly ``num_samples`` float32 samples: silence
    and a random phone in turn, each of a random duration."""
    pieces, total = [], 0
    while total < num_samples:
        for spec in (phones[0], phones[1 + int(rng.integers(0, len(phones) - 1))]):
            dur_ms = rng.uniform(spec.min_ms, spec.max_ms)
            n = max(int(dur_ms * sr / 1000.0), 64)
            pieces.append(synth_phone(spec, n, sr, rng))
            total += n
    return np.ascontiguousarray(np.concatenate(pieces)[:num_samples])
