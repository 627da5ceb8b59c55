"""The PyTorch port's FFT scorer against the JAX reference, on the CPU.

Kernels 3-5 (block DFT, bin matmul, iDFT) run their plain PyTorch
versions here in float32, against the reference's Pallas kernels in
interpret mode, also in float32; the whole scorer runs against the
reference's CPU path on the same bank, carried across by ``convert``.
Tolerance: rtol 1e-5 with atol 1e-5 * max|reference| (float32
summation order differs between the two).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

from template_speech_recognition_tpu.detect import fft_scorer as jfs
from template_speech_recognition_tpu.ops.fft_binmm_pallas import fft_binmm_pallas
from template_speech_recognition_tpu.ops.fft_dft_pallas import fft_block_dft_pallas
from template_speech_recognition_tpu.ops.fft_idft_pallas import fft_idft_pallas
from template_speech_recognition_tpu_torch.convert import fft_bank_from_numpy
from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import fft_binmm
from template_speech_recognition_tpu_torch.ops.fft_dft_kernel import fft_block_dft
from template_speech_recognition_tpu_torch.ops.fft_idft_kernel import fft_idft

B, T, D, K, L = 2, 256, 1024, 128, 8
NFFT = jfs.pick_nfft(L, K)
HOP = NFFT - L + 1
BINS = NFFT // 2 + 1
NBLK = -(-(T - L + 1) // HOP)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-5, atol=1e-5 * np.max(np.abs(want))
    )


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    feats = (rng.random((B, T, D)) < 0.15).astype(np.float32)
    w = rng.standard_normal((K, L, D)).astype(np.float32)
    c = rng.standard_normal((K,)).astype(np.float32)
    return feats, w, c


@pytest.mark.parametrize("length,k", [(8, 128), (32, 1024), (32, 10000), (3, 1)])
def test_pick_nfft_matches_reference(length, k):
    assert tfs.pick_nfft(length, k) == jfs.pick_nfft(length, k)


@pytest.mark.parametrize("nfft", [39, 159, 256])
def test_dft_and_idft_mats_match_reference(nfft):
    for got, want in zip(tfs._dft_mats(nfft, torch.float32),
                         jfs._dft_mats(nfft, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hop = nfft - 7
    for got, want in zip(tfs._idft_mats(nfft, hop, torch.float32),
                         jfs._idft_mats(nfft, hop, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_fft_bank_matches_reference(problem):
    _feats, w, c = problem
    got = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c))
    want = jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c))
    assert (got.length, got.nfft, got.d) == (want.length, want.nfft, want.d)
    _close(got.w2.numpy(), want.w2)
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))


def _g(nfft):
    cm, sm = jfs._dft_mats(nfft, jnp.float32)
    return np.array(jnp.concatenate([cm, -sm], axis=1))


def test_block_dft_matches_pallas(problem):
    feats, _w, _c = problem
    g = _g(NFFT)
    xr_j, xi_j = fft_block_dft_pallas(
        jnp.asarray(feats), jnp.asarray(g), NFFT, HOP, NBLK, dc=256,
        interpret=True,
    )
    xr_t, xi_t = fft_block_dft(
        torch.from_numpy(feats), torch.from_numpy(g), NFFT, HOP, NBLK
    )
    assert tuple(xr_t.shape) == (BINS, B, NBLK, D)
    _close(xr_t.numpy(), xr_j)
    _close(xi_t.numpy(), xi_j)


def test_binmm_matches_pallas(problem):
    _feats, w, c = problem
    rng = np.random.default_rng(8)
    xr = rng.standard_normal((BINS, B, NBLK, D)).astype(np.float32)
    xi = rng.standard_normal((BINS, B, NBLK, D)).astype(np.float32)
    w2 = np.array(jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c)).w2)
    want = fft_binmm_pallas(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(w2), dc=512,
        interpret=True,
    )
    got = fft_binmm(torch.from_numpy(xr), torch.from_numpy(xi),
                    torch.from_numpy(w2))
    assert tuple(got.shape) == (2, BINS, B * NBLK, K)
    _close(got.numpy(), want)


def _ceil(n, q):
    return -(-n // q) * q


@pytest.mark.parametrize("bins,batch,m,d,k", [
    (5, None, 96, 504, 136),     # the tail batch's m at the log-mel D
    (3, 4, 24, 504, 136),        # the same as the 4-D [bins, B, nblk, D] input
    (2, None, 65, 40, 8),        # one row past a 64-row slab; narrow D and K
], ids=["m96-D504-K136", "4d-B4-nblk24-D504", "m65-D40-K8"])
def test_binmm_matches_pallas_ragged(bins, batch, m, d, k):
    """The bin matmul at shapes off the Pallas contract (m % 8, K % 128,
    D % dc): the reference runs on inputs zero-padded to it (each half
    of W2's 2D rows padded on its own) and its valid slice is held
    against the port's plain version, which takes the shapes as they
    are; float32, the tolerance of ``_close``."""
    rng = np.random.default_rng(10)
    rows = m if batch is None else batch * m
    lead = (bins, rows) if batch is None else (bins, batch, m)
    xr = rng.standard_normal(lead + (d,)).astype(np.float32)
    xi = rng.standard_normal(lead + (d,)).astype(np.float32)
    w2 = rng.standard_normal((bins, 2 * d, k)).astype(np.float32)
    dc = 256
    mp, dp, kp = _ceil(rows, 8), _ceil(d, dc), _ceil(k, 128)
    xr_p = np.zeros((bins, mp, dp), np.float32)
    xi_p = np.zeros((bins, mp, dp), np.float32)
    xr_p[:, :rows, :d] = xr.reshape(bins, rows, d)
    xi_p[:, :rows, :d] = xi.reshape(bins, rows, d)
    w2_p = np.zeros((bins, 2 * dp, kp), np.float32)
    w2_p[:, :d, :k] = w2[:, :d]
    w2_p[:, dp:dp + d, :k] = w2[:, d:]
    want = fft_binmm_pallas(jnp.asarray(xr_p), jnp.asarray(xi_p), jnp.asarray(w2_p),
                            dc=dc, interpret=True)
    want = np.asarray(want)[:, :, :rows, :k]
    got = fft_binmm(torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(w2))
    assert tuple(got.shape) == (2, bins, rows, k)
    _close(got.numpy(), want)


def test_idft_matches_pallas(problem):
    _feats, _w, c = problem
    rng = np.random.default_rng(9)
    ycat = rng.standard_normal((2 * BINS, B * NBLK * K)).astype(np.float32)
    icm, ism = jfs._idft_mats(NFFT, HOP, jnp.float32)
    imat = np.asarray(jnp.concatenate([icm, -ism], axis=0))
    want = fft_idft_pallas(
        jnp.asarray(ycat), jnp.asarray(imat), jnp.asarray(c), NBLK,
        interpret=True,
    )
    got = fft_idft(torch.from_numpy(ycat), torch.from_numpy(imat),
                   torch.from_numpy(c), NBLK)
    assert tuple(got.shape) == (B, NBLK * HOP, K)
    _close(got.numpy(), want)


@pytest.mark.parametrize("two_bins,hop,k,m", [(40, 224, 8, 1), (40, 32, 136, 1),
                                               (40, 224, 136, 3), (160, 32, 8, 3)])
def test_idft_plain_matches_pallas_ragged(two_bins, hop, k, m):
    """The plain iDFT (the card kernel's twin) against the reference at
    the card's ragged shapes: hop 224 (not a multiple of the 128-row
    tile), hop 32 (under one 64-row warpgroup tile), 2 bins 40 (under one
    64-row stage), K 8 and 136 (not multiples of the 128-template tile),
    one block and three."""
    rng = np.random.default_rng(10 + hop + k + m)
    ycat = rng.standard_normal((two_bins, m * k)).astype(np.float32)
    imat = rng.standard_normal((two_bins, hop)).astype(np.float32)
    c = rng.standard_normal((k,)).astype(np.float32)
    want = fft_idft_pallas(jnp.asarray(ycat), jnp.asarray(imat), jnp.asarray(c), m,
                           interpret=True)
    got = fft_idft(torch.from_numpy(ycat), torch.from_numpy(imat), torch.from_numpy(c), m)
    assert tuple(got.shape) == (1, m * hop, k)
    _close(got.numpy(), want)


@pytest.mark.parametrize("time_major,trim", [(False, True), (True, True),
                                             (True, False)])
def test_fft_sliding_scores_match_reference(problem, time_major, trim):
    """The whole scorer on the JAX CPU path vs the port, both in f32
    and on the SAME spectra (the JAX bank carried across)."""
    feats, w, c = problem
    jbank = jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c))
    want = jfs.fft_sliding_scores(
        jnp.asarray(feats), jbank, use_pallas=False, time_major=time_major,
        trim=trim,
    )
    tbank = fft_bank_from_numpy(
        np.asarray(jbank.w2), np.asarray(jbank.c), jbank.length, jbank.nfft,
        jbank.d, device="cpu",
    )
    got = tfs.fft_sliding_scores(
        torch.from_numpy(feats > 0), tbank, time_major=time_major, trim=trim
    )
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)


def test_bf16_bank_carries_across_bitwise():
    """convert keeps a bf16 JAX bank's bits (the card's working dtype)."""
    rng = np.random.default_rng(3)
    w2 = jnp.asarray(rng.standard_normal((3, 16, 8)), jnp.bfloat16)
    bank = fft_bank_from_numpy(np.asarray(w2), np.zeros(8, np.float32), 4, 5, 8,
                               device="cpu")
    assert bank.w2.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bank.w2.to(torch.float32).numpy(), np.asarray(w2, np.float32)
    )


def test_fft_sliding_scores_copies_no_basis_from_the_host_per_call(problem, monkeypatch):
    """A scan calls the scorer every batch.  Its DFT and iDFT bases are
    made in host memory, and on the card such a copy blocks the host
    until the device has drained its queue; so a repeated call makes no
    host array (no ``torch.from_numpy``) and passes the same basis
    tensors."""
    feats, w, c = problem
    bank = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c))
    x = torch.from_numpy(feats > 0)
    want = tfs.fft_sliding_scores(x, bank)
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: made.append(a.shape) or real(a))
    got = tfs.fft_sliding_scores(x, bank)
    assert made == []
    assert tfs._dft_basis(bank.nfft, torch.float32, x.device) is tfs._dft_basis(
        bank.nfft, torch.float32, x.device)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("mm_dtype", [None, torch.int8], ids=["f32", "int8"])
@pytest.mark.parametrize("k", [1, 2, 3, 9])
def test_zero_templates_to_the_kernels_multiple_change_no_score(k, mm_dtype):
    """On the card the bank carries zero templates up to a multiple of 8
    (the kernels' K; a two-class bank of one template each has K 2): the
    scores of a bank padded by ``pad_templates`` and cut back by
    ``num_templates`` are bitwise the unpadded bank's, and the reference's
    on the same filters."""
    import dataclasses

    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.standard_normal((k, L, 40)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    x = torch.from_numpy(rng.random((2, 100, 40)) < 0.3)
    bank = tfs.build_fft_bank(w, c, mm_dtype=mm_dtype)
    wp, cp = tfs.pad_templates(w, c)
    assert wp.shape[0] == -(-k // 8) * 8 and not wp[k:].any() and not cp[k:].any()
    padded = dataclasses.replace(tfs.build_fft_bank(wp, cp, nfft=bank.nfft, mm_dtype=mm_dtype),
                                 num_templates=k)
    assert padded.k == wp.shape[0] and bank.k == k
    for time_major in (False, True):
        got = tfs.fft_sliding_scores(x, padded, time_major=time_major)
        want = tfs.fft_sliding_scores(x, bank, time_major=time_major)
        assert torch.equal(got, want)
    if mm_dtype is None:
        jbank = jfs.build_fft_bank(jnp.asarray(w.numpy()), jnp.asarray(c.numpy()))
        _close(tfs.fft_sliding_scores(x, padded),
               jfs.fft_sliding_scores(jnp.asarray(x.numpy()), jbank))
