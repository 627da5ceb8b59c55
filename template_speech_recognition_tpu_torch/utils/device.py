"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU; raises when there is none.

    The port never drops quietly to the CPU: a caller that wants the
    CPU (the tests) passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
