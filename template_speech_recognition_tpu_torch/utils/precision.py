"""Full float32 on the card for the products the reference runs at
``Precision.HIGHEST`` outside any Pallas kernel."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """cuBLAS matmuls and cuDNN convolutions in full float32 inside the
    block: PyTorch lets cuDNN use TF32 by default (and cuBLAS where a
    caller allowed it), which keeps about three decimal digits.  The
    previous settings come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
