"""Structured per-stage counters (SURVEY.md section 5 observability).

The reference logged with prints and saved ``.npy`` arrays; here every
pipeline stage reports named counters (frames processed, windows
scored, audio-seconds/s, collective bytes) through one tiny
accumulator that renders to JSON for logs and artifacts.  A copy of
``template_speech_recognition_tpu.utils.metrics``.
"""

from __future__ import annotations

import collections
import json
import logging
import time

logger = logging.getLogger("tsr_torch")


class StageCounters:
    """Accumulate counters and wall-clock timings per pipeline stage."""

    def __init__(self) -> None:
        self.counters: dict[str, float] = collections.defaultdict(float)
        self.timings: dict[str, float] = collections.defaultdict(float)
        self._starts: dict[str, float] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def start(self, stage: str) -> None:
        self._starts[stage] = time.perf_counter()

    def stop(self, stage: str) -> float:
        dt = time.perf_counter() - self._starts.pop(stage)
        self.timings[stage] += dt
        return dt

    def rate(self, counter: str, stage: str) -> float:
        """counter units per second of ``stage`` time (0 if unstarted)."""
        t = self.timings.get(stage, 0.0)
        return self.counters.get(counter, 0.0) / t if t > 0 else 0.0

    def to_dict(self) -> dict[str, float]:
        out = dict(self.counters)
        out.update({f"time_{k}_s": v for k, v in self.timings.items()})
        return out

    def log(self, prefix: str = "") -> None:
        logger.info("%s%s", prefix, json.dumps(self.to_dict(), sort_keys=True))
