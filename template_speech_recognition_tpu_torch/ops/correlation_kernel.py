"""Kernel 10: the direct sliding-window LLR correlation.

Replaces ``template_speech_recognition_tpu/ops/correlation_pallas.py``
``correlation_scores_pallas`` (its ``pallas_call`` at line 102), which
``detect/scorer.py::sliding_scores_backend(backend="pallas")`` calls.

``out[b, k, t] = c[k] + sum_{tau, d} F[b, t + tau, d] W[k, tau, d]`` for
t < T - L + 1, bf16 operands and fp32 accumulation.  The TPU kernel's
tail contract (starts >= T - L + 1 read a clamped block) covers only
starts its caller slices off; the port computes the valid starts alone.

CUDA design (``csrc/correlation.cu``): window t of a row-major [T, D]
map is one contiguous run of L*D values, so the correlation is one GEMM
``[B*T'', L*D] . [K, L*D]^T`` whose A operand is a Hankel view of the
map (row stride D), never materialized.  A 128 x 128 mma.sync tile with
a 4-stage cp.async ring; W is read in its own [K, L, D] layout, both
operands k-contiguous.  Any T, K and L <= T; D a multiple of 8 (D = 8F'
always is); ragged tiles are zero-filled inside the kernel.

What bounds it on the H100: bf16 operations.  At the reference's bench
shape (B = 8, T = 3000, K = 1024, L = 32, D = 2048) 3.19 TFLOP take 3.2
ms at 989 TFLOP/s; its least bytes (0.33 GB) take 0.1 ms.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "correlation"
SOURCE = "template_speech_recognition_tpu_torch/csrc/correlation.cu"
REPLACES = "template_speech_recognition_tpu/ops/correlation_pallas.py:102"


def correlation_scores_plain(feats, w, c) -> torch.Tensor:
    """Plain PyTorch version in float32: the sum over tau of
    ``F[:, tau : tau + T''] @ W[:, tau]^T`` (TF32 off, PyTorch's default
    for matmul), plus c -> [B, K, T'']."""
    t, length = feats.shape[1], w.shape[1]
    tv = t - length + 1
    x = feats.to(torch.float32)
    wf = w.to(torch.float32)
    acc = x[:, :tv] @ wf[:, 0].T                                  # [B, T'', K]
    for tau in range(1, length):
        acc += x[:, tau : tau + tv] @ wf[:, tau].T
    return (acc + c.to(torch.float32)).transpose(1, 2)


def correlation_scores(feats, w, c) -> torch.Tensor:
    """feats [B, T, D], W [K, L, D], c [K] -> scores [B, K, T-L+1] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 feats and W, f32 c)."""
    if _cuda.on_cpu(feats, w, c):
        return correlation_scores_plain(feats, w, c)
    _cuda.require(feats, "feats", torch.bfloat16, 3)
    _cuda.require(w, "w", torch.bfloat16, 3)
    _cuda.require(c, "c", torch.float32, 1)
    b, t, d = feats.shape
    k, length, dw = w.shape
    if dw != d or tuple(c.shape) != (k,):
        raise ValueError(f"bad shapes: feats {tuple(feats.shape)}, w {tuple(w.shape)}, "
                         f"c {tuple(c.shape)}")
    if not 1 <= length <= t:
        raise ValueError(f"template length {length} must lie in [1, T={t}]")
    tv = t - length + 1
    if d % 8 or feats.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"D={d} must be a multiple of 8 and the bases 16-byte aligned")
    if b * tv >= 2**31 or length * d >= 2**31:
        raise ValueError(f"B*T''={b * tv} and L*D={length * d} must stay below 2**31")
    out = torch.empty((b, k, tv), dtype=torch.float32, device=feats.device)
    if b == 0 or k == 0:
        return out
    lib = _cuda.load("correlation")
    fn = _cuda.declare(lib, "tsr_correlation", 4, 5)
    err = fn(
        _cuda.ptr(feats), _cuda.ptr(w), _cuda.ptr(c), _cuda.ptr(out),
        b, t, d, k, length, _cuda.stream_ptr(feats.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out
