"""The bank, made on the device from the seed.

Random Bernoulli templates: every probability drawn uniformly from
[prob_low, prob_high), templates [K, L, F', E] and the background [F',
E], as ``chip_smoke.py``'s ``random_bank`` draws them, ported to a
``torch.Generator`` on the card: two calls, in float32, the type the
bank is served in.
"""

from __future__ import annotations

import torch


def make_templates(bank: dict, fcfg: dict, seed: int, device):
    """(templates [K, L, F', E], background [F', E]) float32 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f = fcfg["nfft"] // 2
    lo, hi = bank["prob_low"], bank["prob_high"]
    templates = torch.empty((bank["num_templates"], bank["template_length"], f, 8),
                            dtype=torch.float32, device=device).uniform_(lo, hi, generator=g)
    background = torch.empty((f, 8), dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=g)
    return templates, background
