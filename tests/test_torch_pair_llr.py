"""Kernel 11's contract (``ops.pair_llr_kernel``) against the JAX
reference, on the CPU.

``pair_llr_plain`` and the wrapper on CPU tensors are held to the
reference's ``pair_llr_pallas`` in interpret mode (which reads
8-row-aligned windows; the columns are shifted back as
``tests/test_torch_dtw.py`` does) within 1e-5 x max|ref|: fp32 sums over
D in another order.  The cases are the ones the CUDA kernel's schedule
makes hard: one pair, every pair of one template, every pair of its
own, ids out of range, windows into the next utterance, past the map's
end and before its start, and widths whose last 128-wide stage is
partial or a single 8-wide unit (D = 8, 128, 136, 504, 2048).  Inputs
come from numpy with fixed seeds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.ops.dtw_pallas import pair_llr_pallas
from template_speech_recognition_tpu_torch.ops import pair_llr_kernel as kp

# name -> (B, T, D, K, L, m, N, ids, rowstarts)
CASES = {
    "n0": (2, 40, 64, 5, 6, 16, 0, "mixed", "inside"),
    "n1": (2, 40, 64, 5, 6, 16, 1, "mixed", "inside"),
    "all_equal": (2, 48, 64, 5, 32, 40, 23, "equal", "inside"),
    "all_distinct": (2, 48, 64, 40, 6, 16, 37, "distinct", "inside"),
    "ids_out_of_range": (2, 48, 64, 5, 6, 16, 29, "out_of_range", "inside"),
    "past_the_end": (3, 40, 96, 4, 40, 48, 19, "mixed", "past_end"),
    "before_the_start": (3, 40, 96, 4, 40, 48, 19, "mixed", "negative"),
    "d8": (2, 20, 8, 3, 9, 24, 5, "mixed", "past_end"),
    "d128": (2, 20, 128, 3, 9, 24, 5, "mixed", "past_end"),
    "d136": (2, 20, 136, 3, 9, 24, 5, "mixed", "past_end"),
    "d504": (2, 60, 504, 6, 32, 40, 31, "mixed", "past_end"),
    "d2048": (2, 40, 2048, 3, 32, 40, 13, "mixed", "past_end"),
}


def _problem(name, seed=1):
    b, t, d, k, length, m, n, ids_kind, rows_kind = CASES[name]
    rng = np.random.default_rng(seed)
    feats = rng.random((b, t, d)) < 0.3
    w = rng.standard_normal((k, length, d)).astype(np.float32)
    w16 = torch.from_numpy(w).to(torch.bfloat16)
    rowstart = rng.integers(0, b * t - 1, n).astype(np.int32)
    if rows_kind == "past_end" and n >= 4:
        rowstart[:4] = (t - 4, b * t - 9, b * t - 2, b * t - 1)   # into the next / past
    if rows_kind == "negative":
        rowstart[:3] = (-5, -60, -1)                               # before the map
    if ids_kind == "equal":
        ids = np.full(n, k - 1, np.int32)
    elif ids_kind == "distinct":
        ids = rng.permutation(k)[:n].astype(np.int32)
    elif ids_kind == "out_of_range":
        ids = rng.integers(-3, k + 3, n).astype(np.int32)
        ids[:2] = (-1, k + 7)
    else:
        ids = rng.integers(0, k, n).astype(np.int32)
    return (torch.from_numpy(feats), w16, torch.from_numpy(rowstart), torch.from_numpy(ids),
            m)


def _pallas(feats, w16, rowstart, ids, m):
    """The reference kernel in interpret mode on the same operands: windows
    from 8-row-aligned starts, columns shifted back; rows before the map
    are zero rows put in front of it."""
    b, t, d = feats.shape
    lead = -(-max(0, -int(rowstart.min())) // 8) * 8
    rs = rowstart.numpy() + lead
    m_dma = m + 8
    flat = np.zeros((-(-(lead + b * t + m_dma) // 8) * 8, d), np.float32)
    flat[lead:lead + b * t] = feats.numpy().reshape(b * t, d)
    row0 = rs & ~7
    w_j = jnp.asarray(w16.to(torch.float32).numpy(), jnp.bfloat16)
    ext = np.asarray(pair_llr_pallas(
        jnp.asarray(flat, jnp.bfloat16), w_j, jnp.asarray(row0 >> 3), jnp.asarray(ids.numpy()),
        m_dma, interpret=True,
    ))
    return np.stack([ext[p, :, o:o + m] for p, o in enumerate(rs - row0)])


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.max(np.abs(want)))


@pytest.mark.parametrize("name", sorted(set(CASES) - {"n0"}))
def test_plain_matches_pallas(name):
    args = _problem(name)
    want = _pallas(*args)
    _close(kp.pair_llr_plain(*args), want)
    _close(kp.pair_llr(*args), want)           # the wrapper on CPU tensors: plain
    if CASES[name][-1] == "negative":
        assert np.all(want[1] == 0)             # a window wholly before the map


def test_no_pair_gives_an_empty_tile_stack():
    args = _problem("n0")
    b, t, d, k, length, m, n, *_ = CASES["n0"]
    for fn in (kp.pair_llr_plain, kp.pair_llr):
        assert tuple(fn(*args).shape) == (0, length, m)


def test_wrapper_takes_plain_on_cpu(monkeypatch):
    """The wrapper on CPU tensors returns its plain version's output on
    the same arguments (held on one call: a CPU fp32 GEMM does not
    promise the same bits on two calls)."""
    args = _problem("d504", seed=3)
    calls = []
    real = kp.pair_llr_plain

    def plain(*a):
        calls.append(a)
        calls.append(real(*a))
        return calls[-1]

    monkeypatch.setattr(kp, "pair_llr_plain", plain)
    got = kp.pair_llr(*args)
    assert len(calls) == 2 and all(x is y for x, y in zip(calls[0], args))
    assert torch.equal(got, calls[1])
