"""The PyTorch port's int8 template spectra against the JAX reference,
on the CPU.

* The int8 bank build on the same filters: scales within rtol 1e-6;
  the int8 values equal on >= 99.9% and never more than 1 apart (the
  f32 spectra before rounding differ in summation order).
* The plain int8 bin matmul against the reference's Pallas ``_kernel_q``
  in interpret mode on the same int8 inputs: bitwise (the int32 sum is
  exact and the flush is the same f32 multiply and bf16 rounding).
* The whole int8 scorer on a JAX-built int8 bank carried across
  (``convert.fft_bank_from_numpy``): within 1e-2 x max|score|, the
  reference's own int8 class (``config.py`` ``int8_spectra``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.detect import fft_scorer as jfs
from template_speech_recognition_tpu.ops.fft_binmm_pallas import fft_binmm_pallas
from template_speech_recognition_tpu_torch.convert import fft_bank_from_numpy
from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
    fft_binmm_int8,
    fft_binmm_int8_plain,
)

B, T, D, K, L = 2, 256, 1024, 128, 8


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    feats = rng.random((B, T, D)) < 0.15
    w = rng.standard_normal((K, L, D)).astype(np.float32)
    c = rng.standard_normal((K,)).astype(np.float32)
    return feats, w, c


@pytest.fixture(scope="module")
def jbank(problem):
    _f, w, c = problem
    return jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c), mm_dtype=jnp.int8)


def test_int8_bank_matches_reference(problem, jbank):
    _f, w, c = problem
    got = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c),
                             mm_dtype=torch.int8)
    assert got.w2.dtype == torch.int8 and got.w2_scale.dtype == torch.float32
    assert (got.length, got.nfft, got.d) == (jbank.length, jbank.nfft, jbank.d)
    np.testing.assert_allclose(got.w2_scale.numpy(), np.asarray(jbank.w2_scale),
                               rtol=1e-6)
    q, jq = got.w2.numpy().astype(np.int32), np.asarray(jbank.w2).astype(np.int32)
    assert q.shape == jq.shape
    assert np.max(np.abs(q - jq)) <= 1
    assert np.mean(q == jq) >= 0.999
    assert np.max(np.abs(q)) <= 127
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(jbank.c))


@pytest.mark.parametrize("four_d", [True, False])
def test_int8_binmm_plain_matches_pallas(four_d):
    rng = np.random.default_rng(22)
    bins, nb, nblk, d, k = 5, 2, 8, 256, 128
    shape = (bins, nb, nblk, d) if four_d else (bins, nb * nblk, d)
    xr = rng.integers(-127, 128, shape).astype(np.int8)
    xi = rng.integers(-127, 128, shape).astype(np.int8)
    w2 = rng.integers(-127, 128, (bins, 2 * d, k)).astype(np.int8)
    sc = (rng.random((bins, k)) * 1e-4).astype(np.float32)
    want = np.asarray(fft_binmm_pallas(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(w2), sc=jnp.asarray(sc), dc=128,
        interpret=True,
    )).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xr, xi, w2, sc)]
    for fn in (fft_binmm_int8_plain, fft_binmm_int8):
        got = fn(*args)
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == (2, bins, nb * nblk, k)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_int8_binmm_plain_matches_reference_at_log_mel_width():
    """D = 504 (log-mel, not a multiple of 16): the reference takes its
    XLA int8 product there (exact int32 sums, f32 flush, bf16 round);
    bitwise."""
    rng = np.random.default_rng(23)
    bins, m, d, k = 3, 20, 504, 132
    xr = rng.integers(-127, 128, (bins, m, d)).astype(np.int8)
    xi = rng.integers(-127, 128, (bins, m, d)).astype(np.int8)
    w2 = rng.integers(-127, 128, (bins, 2 * d, k)).astype(np.int8)
    sc = (rng.random((bins, k)) * 1e-4).astype(np.float32)
    x2 = jnp.concatenate([jnp.concatenate([xr, xi], 2), jnp.concatenate([xi, -xr], 2)], 1)
    y = jax.lax.dot_general(x2, jnp.asarray(w2), (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.int32)
    y = (y.astype(jnp.float32) * jnp.asarray(sc)[:, None, :]).astype(jnp.bfloat16)
    want = np.asarray(jnp.stack([y[:, :m], y[:, m:]]).astype(jnp.float32))
    got = fft_binmm_int8(*[torch.from_numpy(a) for a in (xr, xi, w2, sc)])
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_int8_binmm_is_exact_past_float32():
    """Sums past 2**24 stay exact: 4096 products of 127 * 127."""
    d, k = 2048, 4
    xr = torch.full((1, 1, d), 127, dtype=torch.int8)
    xi = torch.full((1, 1, d), -127, dtype=torch.int8)
    w2 = torch.full((1, 2 * d, k), 127, dtype=torch.int8)
    w2[0, -1, 0] = 126
    sc = torch.ones((1, k))
    y = fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype=torch.float32)
    exact_0 = 127 * 127 * d - 127 * 127 * (d - 1) - 127 * 126     # row 0: [xr | xi] . w
    assert float(y[0, 0, 0, 0]) == float(np.float32(exact_0))
    assert float(y[0, 0, 0, 1]) == float(np.float32(0))


@pytest.mark.parametrize("time_major,trim", [(False, True), (True, True),
                                             (True, False)])
def test_int8_fft_sliding_scores_match_reference(problem, jbank, time_major, trim):
    feats, _w, _c = problem
    want = np.asarray(jfs.fft_sliding_scores(
        jnp.asarray(feats, jnp.float32), jbank, use_pallas=False,
        time_major=time_major, trim=trim,
    ))
    tbank = fft_bank_from_numpy(
        np.asarray(jbank.w2), np.asarray(jbank.c), jbank.length, jbank.nfft, jbank.d,
        device="cpu", w2_scale=np.asarray(jbank.w2_scale),
    )
    assert tbank.w2.dtype == torch.int8
    got = tfs.fft_sliding_scores(torch.from_numpy(feats), tbank,
                                 time_major=time_major, trim=trim).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.max(np.abs(want)))

