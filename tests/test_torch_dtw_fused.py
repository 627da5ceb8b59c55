"""The fused DTW entry (LLR tile in, score out) against the JAX reference,
and the CUDA kernel's schedule emulated in PyTorch, on the CPU.

``banded_dtw_scores_plain`` (the plain twin of ``csrc/banded_dtw.cu``)
is held bitwise to the reference's ``banded_dtw_pallas`` in interpret
mode on the same cost ``-(llr + c)``, for the map and gathered routes'
[N, L, m] tiles (with and without a pair -> row index) and for the
exhaustive route's strided view of a GEMM output, and each route of
``align.dtw`` to the reference's own function on dyadic data (binary
segments, filters and c in eighths: every product and sum is exact in
fp32 and bf16, so the two GEMMs give one LLR and the scores must be
bitwise).  ``banded_dtw_emulated`` (band lanes, shifts, ring chunks,
pairs a warp) is held bitwise to the plain versions, also at m = 1024
where the ring turns many times.  Unreachable pairs score -inf on both
sides.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.align import dtw as jdtw
from template_speech_recognition_tpu.ops.dtw_pallas import banded_dtw_pallas
from template_speech_recognition_tpu_torch.align import dtw as tdtw
from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd

LENGTHS = (1, 2, 32, 33, 96)
BANDS = (0, 1, 6, 100)
N_PAIRS = 16          # the reference's L > 64 layouts take pair blocks of 8


def _lens(rng, n, length, m):
    """Ragged segment lengths: 1, m, L (reachable at band 0), one at
    random, and the rest near L."""
    lens = np.clip(rng.integers(length - 3, length + 4, n), 1, m).astype(np.int32)
    lens[0], lens[-1] = 1, m
    lens[1], lens[2] = rng.integers(1, m + 1), min(length, m)
    return lens


def _tiles(length, band, seed, n=N_PAIRS):
    rng = np.random.default_rng(1000 * length + band + seed)
    m = length + 7
    llr = rng.standard_normal((n, length, m)).astype(np.float32) - 2.0
    c = rng.standard_normal((5, length)).astype(np.float32)
    cid = rng.integers(0, 5, n).astype(np.int32)
    return llr, c, cid, _lens(rng, n, length, m)


def _ref_scores(cost, lens, band):
    """The reference's DP (Pallas, interpret mode) and its score."""
    total = np.asarray(banded_dtw_pallas(jnp.asarray(cost), jnp.asarray(lens), band,
                                         interpret=True))
    scores = -total / (cost.shape[1] + lens).astype(np.float32)
    return total, np.where(total > 1e37, -np.inf, scores).astype(np.float32)


def _assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(got[np.isfinite(want)], want[np.isfinite(want)])


def _gemm_view(llr, lens, nb):
    """The exhaustive route's layout: pairs (b, q) of a [nb, M, K, L] GEMM
    output read as a [nb, K, L, M] view (no copy)."""
    n, length, m = llr.shape
    k = n // nb
    gemm = torch.from_numpy(np.ascontiguousarray(
        llr.reshape(nb, k, length, m).transpose(0, 3, 1, 2)))          # [nb, M, K, L]
    view = gemm.permute(0, 2, 3, 1)
    assert not view.is_contiguous() and view.stride() == (m * k * length, length, 1, k * length)
    return view, torch.from_numpy(lens.reshape(nb, k)[:, 0].copy())


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("band", BANDS)
def test_scores_plain_matches_pallas(length, band):
    """The map route's tiles with a pair -> row index, the gathered
    route's (row n), and the exhaustive GEMM view (row n % K, one length
    a segment): scores and terminals bitwise against the reference."""
    llr, c, cid, lens = _tiles(length, band, seed=0)
    cost = -(llr + c[cid][:, :, None])
    total_ref, want = _ref_scores(cost, lens, band)
    got = kd.banded_dtw_scores_plain(torch.from_numpy(llr), torch.from_numpy(lens),
                                     torch.from_numpy(c), band, torch.from_numpy(cid))
    _assert_scores(got, want)
    total = kd.banded_dtw_plain(torch.from_numpy(cost), torch.from_numpy(lens), band).numpy()
    finite = total_ref < 1e37
    np.testing.assert_array_equal(total[finite], total_ref[finite])
    assert np.all(total[~finite] > 1e38)
    # gathered: c_pairs [N, L], no index
    c_pairs = c[cid]
    got = kd.banded_dtw_scores_plain(torch.from_numpy(llr), torch.from_numpy(lens),
                                     torch.from_numpy(c_pairs), band)
    _assert_scores(got, want)
    # exhaustive: 4 segments x 4 templates, c_rows [K, L], pair (b, q) -> row q
    nb, k = 4, N_PAIRS // 4
    lens_b = np.repeat(lens[[0, 1, 2, -1]], k)
    cost_g = -(llr + np.tile(c[:k], (nb, 1))[:, :, None])
    _t, want_g = _ref_scores(cost_g, lens_b, band)
    view, lens_v = _gemm_view(llr, lens_b, nb)
    got = kd.banded_dtw_scores_plain(view, lens_v, torch.from_numpy(c[:k]), band)
    assert got.shape == (nb, k)
    _assert_scores(got.reshape(-1), want_g)


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


# (L, band): every length, every band at least once
ROUTE_CASES = [(1, 0), (2, 1), (32, 6), (33, 100), (96, 6), (32, 0), (2, 100), (33, 1)]


@pytest.mark.parametrize("length,band", ROUTE_CASES)
def test_map_route_matches_reference(length, band):
    """``dtw_pairwise_scores_from_map`` (the stream's route: pair-LLR tiles
    and winner ids into the fused entry) bitwise against the reference's,
    windows cut to 1 frame at an utterance's end and whole ones."""
    rng = np.random.default_rng(7 * length + band)
    b, p, d, k = 2, 8, 16, 6
    m_seg = length + min(band, 6)
    t = m_seg + 24
    feats = rng.random((b, t, d)) < 0.3
    w = _dyadic(rng, (k, length, d))
    c = _dyadic(rng, (k, length))
    vf = np.asarray([t, t - 5], np.int32)
    times = rng.integers(0, t - m_seg, (b, p)).astype(np.int32)
    times[0, 0], times[1, 1] = t - 1, t - 6              # windows of one valid frame
    ids = rng.integers(-1, k + 1, (b, p)).astype(np.int32)   # out of range: clamped
    want = np.asarray(jdtw.dtw_pairwise_scores_from_map(
        jnp.asarray(feats, jnp.float32), jnp.asarray(times), jnp.asarray(ids),
        jnp.asarray(w), jnp.asarray(c), jnp.asarray(vf), m_seg, band, use_pallas=False,
    ))
    got = tdtw.dtw_pairwise_scores_from_map(
        torch.from_numpy(feats), torch.from_numpy(times), torch.from_numpy(ids),
        torch.from_numpy(w), torch.from_numpy(c), torch.from_numpy(vf), m_seg, band,
    )
    _assert_scores(got.numpy(), want)


@pytest.mark.parametrize("length,band", ROUTE_CASES)
def test_gathered_route_matches_reference(length, band):
    """``dtw_pairwise_scores`` (the loop's route: an fp32 bmm into the
    fused entry, c_pairs [N, L]) bitwise against the reference's."""
    rng = np.random.default_rng(11 * length + band)
    n, d = 8, 24
    m_pad = length + min(band, 6) + 1
    segs = (rng.random((n, m_pad, d)) < 0.3).astype(np.float32)
    lens = _lens(rng, n, length, m_pad)
    w = _dyadic(rng, (n, length, d))
    c = _dyadic(rng, (n, length))
    want = np.asarray(jdtw.dtw_pairwise_scores(
        jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(w), jnp.asarray(c), band,
    ))
    got = tdtw.dtw_pairwise_scores(torch.from_numpy(segs), torch.from_numpy(lens),
                                   torch.from_numpy(w), torch.from_numpy(c), band)
    _assert_scores(got.numpy(), want)


@pytest.mark.parametrize("length,band", ROUTE_CASES)
def test_exhaustive_route_matches_reference(length, band):
    """``dtw_keyword_scores_batch`` (the GEMM's [B, M, K, L] output read
    through its strides) bitwise against the reference's, in one chunk
    and in chunks of two segments."""
    rng = np.random.default_rng(13 * length + band)
    b, k, f, e = 5, 3, 4, 4
    m_pad = length + min(band, 6) + 1
    segs = (rng.random((b, m_pad, f, e)) < 0.3).astype(np.float32)
    lens = _lens(rng, b, length, m_pad)
    w = _dyadic(rng, (k, length, f, e))
    c = _dyadic(rng, (k, length))
    want = np.asarray(jdtw.dtw_keyword_scores_batch(
        jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(w), jnp.asarray(c), band,
        use_pallas=False,
    ))
    args = (torch.from_numpy(segs), torch.from_numpy(lens), torch.from_numpy(w),
            torch.from_numpy(c), band)
    _assert_scores(tdtw.dtw_keyword_scores_batch(*args).numpy(), want)
    two = 2 * k * length * m_pad
    _assert_scores(tdtw.dtw_keyword_scores_batch(*args, _max_cells=two).numpy(), want)


def _emulation_case(length, band, m, seed, n=37):
    rng = np.random.default_rng(seed)
    cost = (rng.standard_normal((n, length, m)) + 2.0).astype(np.float32)
    lens = _lens(rng, n, length, m)
    lens[4] = m + 3                                        # no terminal cell
    lens[3] = length
    return cost, lens


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("band", BANDS)
def test_emulated_schedule_matches_plain(length, band):
    """The kernel's schedule (band lanes, shifts, ring chunks, pairs a
    warp) bitwise against ``banded_dtw_plain`` (raw mode) and
    ``banded_dtw_scores_plain`` (fused, with a row index and on the GEMM
    view), 37 pairs: a warp left partly empty."""
    cost, lens = _emulation_case(length, band, length + 9, seed=length + 7 * band)
    ct, lt = torch.from_numpy(cost), torch.from_numpy(lens)
    want = kd.banded_dtw_plain(ct, lt, band)
    got = kd.banded_dtw_emulated(ct, lt, band)
    finite = want < 1e37
    assert torch.equal(got[finite], want[finite]) and bool((got[~finite] > 1e38).all())
    rng = np.random.default_rng(band)
    c = torch.from_numpy(rng.standard_normal((3, length)).astype(np.float32))
    cid = torch.from_numpy(rng.integers(0, 3, len(lens)).astype(np.int32))
    want_s = kd.banded_dtw_scores_plain(ct, lt, c, band, cid)
    assert torch.equal(kd.banded_dtw_emulated(ct, lt, band, c, cid), want_s)
    view, lens_v = _gemm_view(cost[:36], np.repeat(lens[:36:3], 3), 12)
    want_v = kd.banded_dtw_scores_plain(view, lens_v, c, band)
    assert torch.equal(kd.banded_dtw_emulated(view, lens_v, band, c), want_v)
    assert torch.isfinite(want_v).any()


@pytest.mark.parametrize("length,band", [(32, 6), (96, 6), (1, 100), (40, 100), (200, 120),
                                         (256, 300)])
def test_emulated_schedule_long_segments(length, band):
    """m = 1024 (``DTWConfig.max_segment_frames``): the ring of three
    chunks turns 30-40 times a pair, and shared memory does not grow."""
    cost, lens = _emulation_case(length, band, 1024, seed=3, n=9)
    lens[3:] = np.clip(np.arange(1024 - 6, 1024), 1, 1024)
    ct, lt = torch.from_numpy(cost), torch.from_numpy(lens)
    want = kd.banded_dtw_plain(ct, lt, band)
    got = kd.banded_dtw_emulated(ct, lt, band)
    finite = want < 1e37
    assert torch.equal(got[finite], want[finite]) and bool((got[~finite] > 1e38).all())


def test_schedule_packs_pairs_at_narrow_bands():
    """Several pairs a warp at band <= 7; past 32 positions a pair takes
    the warp and R registers a lane; the window keeps a spare position;
    a chunk is always 1024 words."""
    for band in range(8):
        sc = kd.schedule(32, band)
        assert sc["R"] == 1 and sc["PPW"] >= 2 and sc["G"] >= 2 * band + 2
    assert kd.schedule(32, 6) == {"R": 1, "G": 16, "CK": 32, "WP": 16, "NL": 16, "PPW": 2}
    assert kd.schedule(32, 100)["R"] == 2 and kd.schedule(31, 100)["PPW"] == 1
    assert kd.schedule(1, 100)["PPW"] == 16
    for length, band, r in ((96, 6, 1), (128, 64, 8), (256, 100, 8), (33, 16, 2),
                            (256, 128, 16)):
        sc = kd.schedule(length, band)
        assert sc["R"] == r and sc["CK"] * 32 * sc["R"] == kd.STAGE_WORDS
        assert sc["WP"] > min(2 * band + 1, length)


def test_whole_tile_mode_takes_the_scan_tiles_only():
    """One bulk copy a pair where its tile is one contiguous aligned block
    that fits: the map route's [984, 32, 40] and the gathered route's m 38;
    the ring for L 96, m 1024, band 100 and the exhaustive GEMM view."""
    def tile(n, length, m, band):
        return kd.whole_tile(torch.zeros(n, 1, length, m), band)

    assert tile(984, 32, 40, 6) and tile(53, 32, 38, 6)
    assert not tile(984, 96, 104, 6) and not tile(9, 32, 1024, 6)
    assert not tile(9, 32, 40, 100) and not tile(9, 33, 38, 6)     # R 2; 33 x 38 words
    gemm = torch.zeros(4, 38, 41, 32).permute(0, 2, 3, 1)
    assert not kd.whole_tile(gemm, 6)
    assert not kd.whole_tile(torch.zeros(9 * 32 * 40 + 1)[1:].reshape(9, 1, 32, 40), 6)


@pytest.mark.parametrize("length", [1, 2, 5, 32, 33])
def test_band_rows_are_exactly_the_valid_cells(length):
    """The staging's closed form [lo, hi] is the set of rows that pass the
    integer band and range tests, and lo is the DP's incremental ilo."""
    for band in (0, 1, 2, 6, 100):
        for mlen in (1, 2, 3, length, length + 5, 3 * length + 1):
            lm1, mm1 = max(length - 1, 1), max(mlen - 1, 1)
            ks = torch.arange(length + mlen - 1)
            lo, hi = kd.band_rows(ks, torch.full_like(ks, mlen), length, band)
            ilo = 0
            for k in range(length + mlen - 1):
                jat = k - ilo
                ilo += int(jat > mlen - 1 or jat * lm1 - ilo * mm1 > band * lm1)
                rows = [i for i in range(length)
                        if 0 <= k - i < mlen and abs((k - i) * lm1 - i * mm1) <= band * lm1]
                assert list(range(int(lo[k]), int(hi[k]) + 1)) == rows
                assert ilo == int(lo[k])
                assert len(rows) <= min(2 * band + 1, length)


def test_fused_entry_refuses_bad_operands_and_keeps_cpu_plain():
    """On CPU tensors the entry is its plain twin; shapes it cannot read
    raise."""
    llr, c, cid, lens = _tiles(32, 6, seed=1)
    args = (torch.from_numpy(llr), torch.from_numpy(lens), torch.from_numpy(c), 6,
            torch.from_numpy(cid))
    assert torch.equal(kd.banded_dtw_scores(*args), kd.banded_dtw_scores_plain(*args))
    with pytest.raises(ValueError):
        kd.banded_dtw_scores(torch.zeros(2, 3), *args[1:])
    empty = kd.banded_dtw_scores_plain(torch.zeros(0, 4, 5), torch.zeros(0, dtype=torch.int32),
                                       torch.zeros(1, 4), 2)
    assert empty.shape == (0,)
