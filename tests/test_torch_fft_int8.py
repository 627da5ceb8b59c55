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



# ---- the K-major bank copy, the padded block spectra and the int8
# kernel's contraction order (Wb half first, the imaginary sum negated
# at the seam, then Wa), all on the CPU --------------------------------

def _check_kmajor(bank):
    w2, t = bank.w2, bank.w2_kmajor
    bins, d2, k = w2.shape
    d = d2 // 2
    dp = -(-d // 16) * 16
    assert t.dtype == torch.int8 and tuple(t.shape) == (bins, 2, k, dp)
    assert t.is_contiguous()
    np.testing.assert_array_equal(
        t[..., :d].numpy(), w2.reshape(bins, 2, d, k).transpose(2, 3).numpy())
    assert not t[..., d:].any()


@pytest.mark.parametrize("d", [1024, 40, 504, 8])
def test_int8_bank_carries_its_kmajor_copy(d):
    """A port-built int8 bank carries W2's K-major copy: the transpose
    of each half of ``w2``, rows zero-padded to 16 bytes; the bf16 and
    f32 banks carry none."""
    rng = np.random.default_rng(31)
    w = torch.from_numpy(rng.standard_normal((24, 8, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    _check_kmajor(tfs.build_fft_bank(w, c, mm_dtype=torch.int8))
    assert tfs.build_fft_bank(w, c, mm_dtype=torch.float32).w2_kmajor is None


def test_jax_int8_bank_carried_across_gets_its_kmajor_copy(jbank):
    tbank = fft_bank_from_numpy(
        np.asarray(jbank.w2), np.asarray(jbank.c), jbank.length, jbank.nfft, jbank.d,
        device="cpu", w2_scale=np.asarray(jbank.w2_scale),
    )
    np.testing.assert_array_equal(tbank.w2.numpy(), np.asarray(jbank.w2))
    _check_kmajor(tbank)
    f32 = fft_bank_from_numpy(np.zeros((3, 16, 8), np.float32), np.zeros(8, np.float32),
                              4, 4, 8, device="cpu")
    assert f32.w2_kmajor is None


@pytest.mark.parametrize("d", [40, 504, 2048])
@pytest.mark.parametrize("four_d", [True, False])
def test_padded_block_spectra_quantize_as_the_reference(d, four_d):
    """``quantize_block_spectra`` writes xq_r, xq_i as views of rows
    padded to 16 bytes (zero past D): the same int8 values and combined
    scales as the reference's quantization (``fft_scorer.py:326-343``),
    bitwise."""
    rng = np.random.default_rng(32)
    bins, k = 3, 16
    shape = (bins, 2, 5, d) if four_d else (bins, 10, d)
    xr = (rng.standard_normal(shape) * 40).astype(np.float32)
    xi = (rng.standard_normal(shape) * 40).astype(np.float32)
    w2s = (rng.random((bins, k)) + 0.5).astype(np.float32)
    qr, qi, sc = tfs.quantize_block_spectra(*(torch.from_numpy(a) for a in (xr, xi, w2s)))
    ax = tuple(range(1, len(shape)))
    sx = jnp.maximum(jnp.maximum(jnp.max(jnp.abs(xr), axis=ax), jnp.max(jnp.abs(xi), axis=ax)),
                     1e-30) / 127.0
    sxb = sx.reshape((bins,) + (1,) * (len(shape) - 1))
    want_r = np.asarray(jnp.clip(jnp.round(xr / sxb), -127, 127).astype(jnp.int8))
    want_i = np.asarray(jnp.clip(jnp.round(xi / sxb), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(qr.numpy(), want_r)
    np.testing.assert_array_equal(qi.numpy(), want_i)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sx[:, None] * w2s))
    dp = -(-d // 16) * 16
    assert qr.stride(-2) == qi.stride(-2) == dp and qr.stride(-1) == 1
    buf = torch.as_strided(qr, qr.shape[:-1] + (dp,), qr.stride())
    assert not buf[..., d:].any()


def _xla_int8_binmm(xr, xi, w2, sc):
    """The reference's XLA int8 product (its route where the Pallas
    tiling does not apply): exact int32 sums, f32 flush, bf16 round."""
    bins = xr.shape[0]
    xr3, xi3 = xr.reshape(bins, -1, xr.shape[-1]), xi.reshape(bins, -1, xr.shape[-1])
    m = xr3.shape[1]
    x2 = jnp.concatenate([jnp.concatenate([xr3, xi3], 2), jnp.concatenate([xi3, -xr3], 2)], 1)
    y = jax.lax.dot_general(x2, jnp.asarray(w2), (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.int32)
    y = (y.astype(jnp.float32) * jnp.asarray(sc)[:, None, :]).astype(jnp.bfloat16)
    return np.asarray(jnp.stack([y[:, :m], y[:, m:]]).astype(jnp.float32))


def _emulated(xr, xi, w2, sc):
    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
        fft_binmm_int8_emulated,
        kmajor_spectra,
    )
    t = [torch.from_numpy(a) for a in (xr, xi, w2, sc)]
    got = fft_binmm_int8_emulated(t[0], t[1], kmajor_spectra(t[2]), t[3])
    assert got.dtype == torch.bfloat16
    return got.to(torch.float32).numpy()


@pytest.mark.parametrize("four_d", [True, False])
@pytest.mark.parametrize("full", [False, True])
def test_int8_emulated_schedule_matches_pallas(four_d, full):
    """The kernel's contraction order, emulated, is bitwise equal to
    the reference's ``_kernel_q`` in interpret mode; ``full``: every
    input at +-127, 2D = 4096 (|acc| up to 2D x 127^2 = 66,064,384)."""
    rng = np.random.default_rng(33)
    if full:
        bins, nb, nblk, d, k = 2, 1, 8, 2048, 128
    else:
        bins, nb, nblk, d, k = 3, 2, 8, 256, 256
    shape = (bins, nb, nblk, d) if four_d else (bins, nb * nblk, d)
    if full:
        xr = np.where(rng.random(shape) < 0.5, 127, -127).astype(np.int8)
        xi = -xr
        w2 = np.where(rng.random((bins, 2 * d, k)) < 0.5, 127, -127).astype(np.int8)
        # templates 0..63 align with row 0 in both halves: its real sum
        # meets the bound, its imaginary sum is -bound + bound = 0
        row0 = np.concatenate([xr, xi], -1).reshape(bins, -1, 2 * d)[:, 0]
        w2[:, :, :64] = np.where(row0 > 0, 127, -127)[:, :, None]
    else:
        xr = rng.integers(-127, 128, shape).astype(np.int8)
        xi = rng.integers(-127, 128, shape).astype(np.int8)
        w2 = rng.integers(-127, 128, (bins, 2 * d, k)).astype(np.int8)
    sc = (rng.random((bins, k)) * 1e-4).astype(np.float32)
    want = np.asarray(fft_binmm_pallas(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(w2), sc=jnp.asarray(sc), dc=256,
        interpret=True,
    )).astype(np.float32)
    np.testing.assert_array_equal(_emulated(xr, xi, w2, sc), want)
    plain = fft_binmm_int8_plain(*[torch.from_numpy(a) for a in (xr, xi, w2, sc)])
    np.testing.assert_array_equal(plain.to(torch.float32).numpy(), want)
    if full:
        got = fft_binmm_int8_plain(*[torch.from_numpy(a) for a in (xr, xi, w2)],
                                   torch.ones((bins, k)), out_dtype=torch.float32)
        assert float(got[0, 0, 0, 0]) == 2 * d * 127 * 127 == 66_064_384
        assert float(got[1, 0, 0, 0]) == 0.0


@pytest.mark.parametrize("m,d,k", [
    (1, 8, 8), (33, 40, 136), (50, 504, 264), (65, 2048, 8), (97, 504, 1032),
    (3, 1000, 24), (70, 130, 256),
])
def test_int8_emulated_schedule_ragged(m, d, k):
    """At ragged shapes (2m not a multiple of 64, K not of 256, D not of
    16 or of the 128-byte k step), where the reference takes its XLA
    int8 product: the emulated schedule, the plain version and the
    wrapper on CPU tensors all bitwise equal to it."""
    rng = np.random.default_rng(34 + m + d + k)
    bins = 2
    xr = rng.integers(-127, 128, (bins, m, d)).astype(np.int8)
    xi = rng.integers(-127, 128, (bins, m, d)).astype(np.int8)
    w2 = rng.integers(-127, 128, (bins, 2 * d, k)).astype(np.int8)
    sc = (rng.random((bins, k)) * 1e-4).astype(np.float32)
    want = _xla_int8_binmm(xr, xi, w2, sc)
    np.testing.assert_array_equal(_emulated(xr, xi, w2, sc), want)
    t = [torch.from_numpy(a) for a in (xr, xi, w2, sc)]
    np.testing.assert_array_equal(fft_binmm_int8(*t).to(torch.float32).numpy(), want)


def test_int8_emulated_schedule_reads_the_padded_views():
    """On the scorer's own operands (padded views from
    ``quantize_block_spectra``, the bank's K-major copy) at D = 504 the
    emulated schedule equals the plain version bitwise."""
    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
        fft_binmm_int8_emulated,
    )
    rng = np.random.default_rng(35)
    bins, d, k = 3, 504, 40
    w = torch.from_numpy(rng.standard_normal((k, 4, d)).astype(np.float32))
    bank = tfs.build_fft_bank(w, torch.zeros(k), nfft=5, mm_dtype=torch.int8)
    xr = torch.from_numpy(rng.standard_normal((bins, 2, 9, d)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((bins, 2, 9, d)).astype(np.float32))
    qr, qi, sc = tfs.quantize_block_spectra(xr, xi, bank.w2_scale)
    got = fft_binmm_int8_emulated(qr, qi, bank.w2_kmajor, sc)
    want = fft_binmm_int8_plain(qr, qi, bank.w2, sc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("time_major,trim", [(False, True), (True, False)])
def test_int8_scorer_on_a_port_built_bank_meets_the_reference_class(problem, jbank,
                                                                     time_major, trim):
    """The whole int8 scorer through a port-built bank (K-major copy,
    padded block spectra) against the reference scorer on its own
    int8 bank: within 1e-2 x max|score|, the reference's int8 class."""
    feats, w, c = problem
    want = np.asarray(jfs.fft_sliding_scores(
        jnp.asarray(feats, jnp.float32), jbank, use_pallas=False,
        time_major=time_major, trim=trim,
    ))
    tbank = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c), mm_dtype=torch.int8)
    assert tbank.w2_kmajor is not None
    got = tfs.fft_sliding_scores(torch.from_numpy(feats), tbank,
                                 time_major=time_major, trim=trim).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.max(np.abs(want)))


@pytest.mark.parametrize("bins,m,d", [(2, 1, 8), (1, 3, 504), (1, 1, 40), (3, 50, 2048),
                                      (2, 7, 504)])
def test_int8_tma_strides_take_the_padded_views(bins, m, d):
    """The strides the kernel's TMA maps get from the scorer's operands
    (views of rows padded to 16 bytes): a size-1 dimension's stride,
    which PyTorch may report as anything, is taken as the dense one; a
    contiguous operand whose rows are not a multiple of 16 bytes, and
    a base off 16 bytes, raise."""
    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
        int8_row_width,
        int8_tma_strides,
    )
    dp = int8_row_width(d)
    xf = torch.randn(bins, 2, m, d)
    qr, qi, _sc = tfs.quantize_block_spectra(xf, xf, torch.ones(bins, 4))
    for x in (qr, qi):
        x3 = x.reshape(bins, -1, d)
        assert int8_tma_strides(x3) == (dp, 2 * m * dp)
    x3 = torch.zeros((2, bins, m, dp), dtype=torch.int8)[0, ..., :d]
    assert int8_tma_strides(x3) == (dp, m * dp)
    if d % 16:
        with pytest.raises(ValueError, match="16-byte"):
            int8_tma_strides(torch.zeros((bins, m + 1, d), dtype=torch.int8))
    flat = torch.zeros(bins * m * dp + 64, dtype=torch.int8)
    base = flat.data_ptr() % 16
    off = flat[16 - base + 8:][: bins * m * dp].view(bins, m, dp)[..., :d]
    with pytest.raises(ValueError, match="aligned"):
        int8_tma_strides(off)
