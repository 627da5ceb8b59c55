"""Times the streaming scan end to end in one or more checkouts: the
default scan (log-magnitude features, D = 2048) and the log-mel scan
(D = 504) over ``chip_smoke.py``'s corpus (19 synthetic utterances of
30 s, batches of 8) with its random banks (K = 1024 templates of L =
32, seed 0), one warm-up scan of the whole corpus, then ``REPS`` scans
each (``chip_smoke.scan_rates``), and reports
every scan's audio-s/s (``counters["audio_s_per_s"]``: audio seconds
over the scan loop's wall time, bank build excluded).

    python3 time_scans.py ROOT [ROOT ...]

Each ROOT is the root of a checkout: its package is imported from
there, in a process of its own; the corpus and banks are this
script's, so every ROOT scans the same audio.  Give two commits as A B
B A ... to compare them on one card: a scan of three batches spreads
widely, so take many pairs.  Prints the card's name and power limit,
then one JSON line a ROOT.  Needs a CUDA device."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from chip_smoke import B, SEED, Corpus, card_line, random_bank, scan_rates

REPS = 5


def one(root: str) -> dict:
    """The audio-s/s of ``root``'s scans (run in a process of its own)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.convert import bank_from_numpy

    if not C.__file__.startswith(root):
        raise RuntimeError(f"imported {C.__file__}, not from {root}")
    dev = torch.device("cuda")
    corpus = Corpus(SEED)
    out = {"root": root}
    for label, fcfg in (("default", C.FrontendConfig()),
                        ("log-mel", C.FrontendConfig(use_mel=True))):
        templates, background = random_bank(fcfg, np.random.default_rng(SEED))
        bank = bank_from_numpy(templates, background,
                               [f"k{i}" for i in range(len(templates))], dev)
        cfg = C.PipelineConfig(frontend=fcfg, detect=C.DetectConfig(batch_size=B))
        out[label] = scan_rates(torch, corpus, bank, cfg, REPS, dev, target_phone="aa")
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
