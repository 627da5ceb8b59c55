"""Feature-layout conversions: channels-minor <-> channel-major flat.

Counterpart of ``template_speech_recognition_tpu.ops.layout``.  The
flat map is [.., T, D] with d = e*F' + f; filters meeting a flat map
must be flattened with ``filters_to_flat`` (both sides in one order).
All conversions are exact relayouts.
"""

from __future__ import annotations

import torch


def channels_to_flat(binary: torch.Tensor) -> torch.Tensor:
    """[.., T, F', E] -> [.., T, E*F'] with d = e*F' + f."""
    x = torch.movedim(binary, -1, -2)                 # [.., T, E, F']
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def flat_to_channels(flat: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[.., T, E*F'] -> [.., T, F', E]."""
    e = flat.shape[-1] // num_freqs
    x = flat.reshape(flat.shape[:-1] + (e, num_freqs))
    return torch.movedim(x, -2, -1)


def filters_to_flat(w: torch.Tensor) -> torch.Tensor:
    """[.., L, F', E] filter/template stacks -> [.., L, E*F']."""
    x = torch.transpose(w, -1, -2)                    # [.., L, E, F']
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
