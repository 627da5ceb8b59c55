"""Kernel 10: the direct sliding-window LLR correlation.

Replaces ``template_speech_recognition_tpu/ops/correlation_pallas.py``
``correlation_scores_pallas`` (its ``pallas_call`` at line 102), which
``detect/scorer.py::sliding_scores_backend(backend="pallas")`` calls.

``out[b, k, t] = c[k] + sum_{tau, d} F[b, t + tau, d] W[k, tau, d]`` for
t < T - L + 1, bf16 operands and fp32 accumulation.  The TPU kernel's
tail contract (starts >= T - L + 1 read a clamped block) covers only
starts its caller slices off; the port computes the valid starts alone.

CUDA design (``csrc/correlation.cu``): TMA + ``wgmma``.  A tile is
``TILE_K`` = 128 templates (the wgmma M side) by ``TILE_T`` = 192 window
starts of one utterance (the N side); its contraction runs over
ceil(D / 64) d-chunks, and inside each over the L shifts tau, each step
one [128, 64] W box at (d0, tau, k0) times the frames t0 + tau ..
t0 + tau + 191 of columns d0 .. d0 + 63.  Those frames come from a
panel kept in shared memory: rows t0 + tau0 .. t0 + tau0 + 223 of the
chunk serve 32 shifts, and step tau starts its wgmma operand tau - tau0
rows in (the panel is unswizzled, so a row offset is 16 bytes of start
address).  Both come by TMA through plain 3-D tensor maps, which
zero-fill columns past D, rows past T and templates past K, so a
partial last d-chunk adds exactly zero.  One producer warp, two
consumer warpgroups, a 10-slot W ring and two panel slots.  No split of
the contraction: every output is one block's sum in one fixed order, so
launches are bitwise repeatable.  ``correlation_scores_tiled`` walks the
same schedule in PyTorch, for the tests.  Any T, K and L <= T; D a
multiple of 8 (D = 8F' always is); 16-byte aligned bases.

What bounds it on the H100: bf16 operations.  At the reference's bench
shape (B = 8, T = 3000, K = 1024, L = 32, D = 2048) 3.19 TFLOP take 3.22
ms at 989 TFLOP/s; its least bytes (0.33 GB) take 0.1 ms.  One
utterance (B = 1): 0.40 ms.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "correlation"
SOURCE = "template_speech_recognition_tpu_torch/csrc/correlation.cu"
REPLACES = "template_speech_recognition_tpu/ops/correlation_pallas.py:102"
# the kernel's tile: templates, window starts, d columns a step (BM, BN,
# BK of csrc/correlation.cu)
TILE_K, TILE_T, CHUNK_D = 128, 192, 64


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


def correlation_scores_tiled(feats, w, c) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch (float32), for the tests:
    tiles of ``TILE_K`` templates x ``TILE_T`` window starts of one
    utterance, each a sum over d-chunks (outer) and shifts tau (inner) of
    ``W[k0:k0+TILE_K, tau, d0:d0+CHUNK_D] @ F[b, t0+tau : t0+tau+TILE_T,
    d0:d0+CHUNK_D]^T`` (the kernel reads the frames of 32 consecutive
    shifts from one resident panel: the same values).  The boxes read
    zeros where TMA zero-fills them: columns past D (the partial last
    chunk), rows past T and templates past K.  Starts past T - L + 1 are
    computed and dropped, as the kernel's epilogue does.
    -> [B, K, T - L + 1]."""
    b, t, d = feats.shape
    k, length = w.shape[0], w.shape[1]
    tv = t - length + 1
    n_dc = -(-d // CHUNK_D)
    n_tt, n_kt = -(-tv // TILE_T), -(-k // TILE_K)
    xp = torch.zeros((b, n_tt * TILE_T + length - 1, n_dc * CHUNK_D))
    xp[:, :t, :d] = feats.to(torch.float32)
    wp = torch.zeros((n_kt * TILE_K, length, n_dc * CHUNK_D))
    wp[:k, :, :d] = w.to(torch.float32)
    out = torch.empty((b, k, tv))
    for k0 in range(0, k, TILE_K):
        for bi in range(b):
            for t0 in range(0, tv, TILE_T):
                acc = torch.zeros((TILE_K, TILE_T))
                for dc in range(n_dc):
                    cols = slice(dc * CHUNK_D, (dc + 1) * CHUNK_D)
                    for tau in range(length):
                        acc += wp[k0 : k0 + TILE_K, tau, cols] @ xp[bi, t0 + tau : t0 + tau + TILE_T,
                                                                    cols].T
                kk, tt = min(TILE_K, k - k0), min(TILE_T, tv - t0)
                out[bi, k0 : k0 + kk, t0 : t0 + tt] = (acc[:kk, :tt]
                                                       + c[k0 : k0 + kk, None].to(torch.float32))
    return out


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
