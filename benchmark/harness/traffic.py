"""The traffic generator: one general reader of ``traffic/<name>.json``.

A mix is a closed loop of one client: a pool of distinct synthetic
utterances held in host memory, made from the seed, and fed to one call
of the scan in an order drawn from the seed (one permutation of the pool
after another) until the window's seconds have passed since the call
began.  The pool's lengths are fixed by the mix, not by the seed, so
every seed brings the same set of sizes in another order.

Keys of a mix:

* ``sample_rate``; ``pool``: distinct utterances; ``batch_size``: the
  scan's rows a batch;
* ``lengths``: ``{"kind": "fixed", "seconds": s}``, or ``{"kind":
  "lognormal", "mean_s", "sigma_log", "min_s", "max_s"}``: the
  log-normal's quantiles at (i + 1/2) / pool, clipped;
* ``trace``: ``{"start_s", "stretch_s"}``: where the traced run's
  profiled stretch begins in the window and how long it lasts at least.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np

from benchmark.harness import synth
from benchmark.harness.buckets import Mirror


def lengths(mix: dict) -> list[int]:
    """The pool's lengths in samples, in pool order."""
    sr, n, spec = mix["sample_rate"], mix["pool"], mix["lengths"]
    if spec["kind"] == "fixed":
        return [int(round(spec["seconds"] * sr))] * n
    if spec["kind"] == "lognormal":
        sig = spec["sigma_log"]
        mu = math.log(spec["mean_s"]) - sig * sig / 2.0
        nd = statistics.NormalDist(mu, sig)
        secs = [min(max(math.exp(nd.inv_cdf((i + 0.5) / n)), spec["min_s"]), spec["max_s"])
                for i in range(n)]
        return [int(round(s * sr)) for s in secs]
    raise ValueError(f"unknown length kind {spec['kind']!r}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed."""
    return np.random.default_rng([int(seed), stream])


def make_pool(mix: dict, seed: int) -> list[np.ndarray]:
    """The pool's waveforms, float32, from the seed."""
    g = rng(seed, 1)
    return [synth.utterance(n, mix["sample_rate"], g) for n in lengths(mix)]


class WindowCorpus:
    """The corpus of one scan call: utterances of ``pool`` in the seed's
    order until ``seconds`` have passed since ``t0`` (set by the caller
    at the call); ``hooks`` run each
    time the scan asks for the next utterance, and may set ``hold`` to
    keep the corpus going past its seconds or ``stop`` to end it.
    Records what it fed."""

    def __init__(self, pool, sample_rate: int, batch_size: int, order_seed,
                 seconds: float, hooks=()):
        self.pool = pool
        self.sample_rate = sample_rate
        self.seconds = seconds
        self.hooks = list(hooks)
        self.order = rng(order_seed, 2)
        self.mirror = Mirror(batch_size)
        self.fed: list[int] = []
        self.fed_at: list[float] = []
        self.t0 = time.perf_counter()
        self.stop = False
        self.hold = False

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def iter_utterances(self):
        perm: list[int] = []
        while True:
            for hook in self.hooks:
                hook(self)
            if self.stop or (not self.hold and self.elapsed() >= self.seconds):
                return
            if not perm:
                perm = list(self.order.permutation(len(self.pool)))
            idx = int(perm.pop())
            wav = self.pool[idx]
            self.mirror.feed(len(wav))
            self.fed.append(idx)
            self.fed_at.append(time.perf_counter())
            yield f"u{len(self.fed) - 1}.p{idx}", wav, []

    @property
    def audio_seconds(self) -> float:
        return sum(len(self.pool[i]) for i in self.fed) / self.sample_rate
