"""Carry weights across from the JAX package as numpy arrays.

The tests and tools hand the port exactly the reference's arrays, so a
comparison measures the port, not two different bank builds.
"""

from __future__ import annotations

import numpy as np
import torch

from template_speech_recognition_tpu_torch.detect.fft_scorer import FFTBank
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
    kmajor_spectra,
    pad_spectra,
)
from template_speech_recognition_tpu_torch.utils.device import resolve_device


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16 from a JAX array
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def bank_from_numpy(templates, background, labels, device=None,
                    parts=None) -> TemplateBank:
    """The JAX ``TemplateBank``'s arrays ([K, L, F, E], [F, E], labels
    and, for a parts-coded bank, the dictionary [J, pt, pf, E])."""
    dev = resolve_device(device)
    return TemplateBank(
        _tensor(templates, dev, torch.float32),
        _tensor(background, dev, torch.float32),
        list(labels),
        None if parts is None else _tensor(parts, dev, torch.float32),
    )


def fft_bank_from_numpy(w2, c, length: int, nfft: int, d: int,
                        device=None, w2_scale=None) -> FFTBank:
    """A JAX-built ``FFTBank``'s spectra ``w2`` [bins, 2D, K] (dtype
    kept: float32, bfloat16 or int8), offsets ``c`` [K] and, for int8
    spectra, their scales ``w2_scale`` [bins, K]; int8 spectra also get
    their K-major copy (``FFTBank.w2_kmajor``), built here once.  Each
    half of the spectra is padded to D8 rows, as ``build_fft_bank``
    pads its own, so both banks are one bank."""
    dev = resolve_device(device)
    w2t = pad_spectra(_tensor(w2, dev), int(d))
    quant = w2_scale is not None
    return FFTBank(
        w2=w2t, c=_tensor(c, dev, torch.float32),
        length=int(length), nfft=int(nfft), d=int(d),
        w2_scale=_tensor(w2_scale, dev, torch.float32) if quant else None,
        w2_kmajor=kmajor_spectra(w2t) if quant else None,
    )
