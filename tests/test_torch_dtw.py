"""The PyTorch port's DTW rescoring against the JAX reference, on the CPU.

The banded DP and the pair-LLR tiles run their plain PyTorch versions
here, against the reference's Pallas kernels in interpret mode and its
``align.dtw`` functions.  Tolerances: DTW terminal costs bitwise on
the same cost tiles (one fp32 add and exact minimums per cell), the
unreachable ones > 1e38 on both sides; LLR tiles within 1e-5 x max|ref|
and scores at rtol/atol 1e-5 (fp32 sums over D taken in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.align import dtw as jdtw
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu.ops.dtw_pallas import (
    banded_dtw_pallas,
    pair_llr_pallas,
)
from template_speech_recognition_tpu_torch.align import dtw as tdtw
from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.ops.dtw_kernel import (
    banded_dtw,
    banded_dtw_plain,
)
from template_speech_recognition_tpu_torch.ops.pair_llr_kernel import (
    pair_llr,
    pair_llr_plain,
)


def _cost(n, length, m, seed, lo):
    rng = np.random.default_rng(seed)
    cost = (rng.standard_normal((n, length, m)) + 2.0).astype(np.float32)
    lens = rng.integers(lo, m + 1, size=n).astype(np.int32)
    lens[0] = 1
    lens[-1] = m
    return cost, lens


def _scan_reference(cost, lens, band):
    return np.asarray(jax.vmap(
        lambda c, ln: jdtw.banded_dtw.__wrapped__(c, ln, band)
    )(jnp.asarray(cost), jnp.asarray(lens)))


def _assert_terminals(got, want):
    """Finite terminals bitwise; unreachable ones > 1e38 on both sides."""
    finite = want < 1e37
    assert finite.any()
    np.testing.assert_array_equal(got[finite], want[finite])
    assert np.all(got[~finite] > 1e38)


@pytest.mark.parametrize("layout,length,m,band,n", [
    ("packed", 32, 40, 1, 11),
    ("packed", 32, 40, 3, 11),
    ("packed", 32, 40, 6, 11),
    ("packed", 32, 40, 100, 11),
    ("band", 96, 104, 6, 8),
    ("full", 128, 136, 64, 8),
    ("full", 128, 136, 1, 8),
])
def test_banded_dtw_plain_matches_pallas(layout, length, m, band, n):
    cost, lens = _cost(n, length, m, seed=length + band, lo=length // 2)
    want = np.asarray(banded_dtw_pallas(
        jnp.asarray(cost), jnp.asarray(lens), band, interpret=True, layout=layout,
    ))
    got = banded_dtw_plain(torch.from_numpy(cost), torch.from_numpy(lens), band).numpy()
    _assert_terminals(got, want)
    # and against the reference's lax.scan DP (+inf where unreachable)
    scan = _scan_reference(cost, lens, band)
    finite = np.isfinite(scan)
    np.testing.assert_array_equal(got[finite], scan[finite])
    assert np.all(got[~finite] > 1e38)


@pytest.mark.parametrize("band", [1, 3, 6, 100])
def test_banded_dtw_ragged_lengths_and_single_column(band):
    """seg_len 1 .. M, including the one-column segment."""
    cost, _ = _cost(9, 16, 24, seed=band, lo=1)
    lens = np.asarray([1, 2, 3, 5, 8, 13, 16, 21, 24], np.int32)
    got = banded_dtw(torch.from_numpy(cost), torch.from_numpy(lens), band).numpy()
    want = np.asarray(banded_dtw_pallas(
        jnp.asarray(cost), jnp.asarray(lens), band, interpret=True,
    ))
    _assert_terminals(got, want)


def test_banded_dtw_segment_longer_than_cost_is_unreachable():
    cost, _ = _cost(3, 8, 10, seed=2, lo=1)
    lens = torch.tensor([10, 11, 40], dtype=torch.int32)
    got = banded_dtw(torch.from_numpy(cost), lens, 100)
    assert got[0] < 1e37 and bool((got[1:] > 1e38).all())


def test_align_banded_dtw_matches_reference():
    cost, lens = _cost(4, 12, 20, seed=5, lo=3)
    for c, ln in zip(cost, lens):
        for band in (1, 4):
            got = float(tdtw.banded_dtw(torch.from_numpy(c), int(ln), band))
            want = float(jdtw.banded_dtw(jnp.asarray(c), jnp.int32(ln), band))
            assert got == want or (np.isinf(got) and np.isinf(want))


def _map_problem(seed=11, b=2, t=48, d=64, k=5, length=6):
    rng = np.random.default_rng(seed)
    feats = rng.random((b, t, d)) < 0.3
    w = rng.standard_normal((k, length, d)).astype(np.float32)
    c_rows = rng.standard_normal((k, length)).astype(np.float32)
    return feats, w, c_rows


def test_pair_llr_plain_matches_pallas():
    """Windows that run into the next utterance and past the map's end;
    the reference reads from 8-row-aligned starts and shifts columns."""
    feats, w, _c = _map_problem()
    b, t, d = feats.shape
    m_seg = 10
    m_pad = -(-m_seg // 8) * 8
    m_dma = m_pad + 8
    rowstart = np.asarray([0, 3, 17, t - 4, t + 5, b * t - 9, b * t - 2, b * t - 1],
                          np.int32)
    ids = np.asarray([0, 4, 2, 1, 3, 4, 0, 2], np.int32)
    w16 = jnp.asarray(w, jnp.bfloat16)
    flat = np.zeros((-(-(b * t + m_dma) // 8) * 8, d), np.float32)
    flat[: b * t] = feats.reshape(b * t, d)
    row0 = rowstart & ~7
    ext = np.asarray(pair_llr_pallas(
        jnp.asarray(flat, jnp.bfloat16), w16, jnp.asarray(row0 >> 3), jnp.asarray(ids),
        m_dma, interpret=True,
    ))
    off = rowstart - row0
    want = np.stack([ext[p, :, o:o + m_pad] for p, o in enumerate(off)])
    w16_t = torch.from_numpy(np.array(w16.astype(jnp.float32))).to(torch.bfloat16)
    for fn in (pair_llr_plain, pair_llr):
        got = fn(torch.from_numpy(feats), w16_t, torch.from_numpy(rowstart),
                 torch.from_numpy(ids), m_pad).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.max(np.abs(want)))


def test_pair_llr_plain_matches_pallas_at_log_mel_width():
    """D = 504 (log-mel, 8 x 63: not a multiple of 32), as the mel scan's
    verify-the-winner rescore hands it; the reference has no D constraint."""
    feats, w, _c = _map_problem(seed=13, d=504)
    b, t, d = feats.shape
    m_pad = 16
    rowstart = np.asarray([0, 9, t - 3, b * t - 5], np.int32)
    ids = np.asarray([1, 0, 4, 2], np.int32)
    w16 = jnp.asarray(w, jnp.bfloat16)
    flat = np.zeros((-(-(b * t + m_pad + 8) // 8) * 8, d), np.float32)
    flat[: b * t] = feats.reshape(b * t, d)
    row0 = rowstart & ~7
    ext = np.asarray(pair_llr_pallas(
        jnp.asarray(flat, jnp.bfloat16), w16, jnp.asarray(row0 >> 3), jnp.asarray(ids),
        m_pad + 8, interpret=True,
    ))
    want = np.stack([ext[p, :, o:o + m_pad] for p, o in enumerate(rowstart - row0)])
    w16_t = torch.from_numpy(np.array(w16.astype(jnp.float32))).to(torch.bfloat16)
    got = pair_llr(torch.from_numpy(feats), w16_t, torch.from_numpy(rowstart),
                   torch.from_numpy(ids), m_pad).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.max(np.abs(want)))


def _scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert finite.any()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


def test_pairwise_from_map_matches_reference():
    feats, w, c_rows = _map_problem()
    b, t, d = feats.shape
    rng = np.random.default_rng(12)
    p, m_seg, band = 5, 10, 3
    times = rng.integers(0, t - 1, (b, p)).astype(np.int32)
    times[0, 0] = t - 2
    ids = rng.integers(0, w.shape[0], (b, p)).astype(np.int32)
    vf = np.asarray([t, t - 6], np.int32)
    want = jdtw.dtw_pairwise_scores_from_map(
        jnp.asarray(feats, jnp.float32), jnp.asarray(times), jnp.asarray(ids),
        jnp.asarray(w), jnp.asarray(c_rows), jnp.asarray(vf), m_seg, band,
        use_pallas=False,
    )
    got = tdtw.dtw_pairwise_scores_from_map(
        torch.from_numpy(feats), torch.from_numpy(times), torch.from_numpy(ids),
        torch.from_numpy(w), torch.from_numpy(c_rows), torch.from_numpy(vf),
        m_seg, band,
    )
    assert got.shape == (b, p)
    _scores_close(got.numpy(), want)


def test_pairwise_scores_match_reference():
    rng = np.random.default_rng(13)
    n, m_pad, length, d = 7, 12, 6, 32
    segs = (rng.random((n, m_pad, d)) < 0.3).astype(np.float32)
    lens = np.asarray([12, 9, 6, 3, 12, 1, 7], np.int32)
    w = rng.standard_normal((n, length, d)).astype(np.float32)
    c = rng.standard_normal((n, length)).astype(np.float32)
    for band in (1, 4):
        want = jdtw.dtw_pairwise_scores(
            jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(w), jnp.asarray(c), band,
        )
        got = tdtw.dtw_pairwise_scores(
            torch.from_numpy(segs), torch.from_numpy(lens), torch.from_numpy(w),
            torch.from_numpy(c), band,
        )
        _scores_close(got.numpy(), want)


def _keyword_problem():
    rng = np.random.default_rng(14)
    tpl = np.clip(rng.random((5, 6, 8, 8)), 0.05, 0.95).astype(np.float32)
    bg = np.full((8, 8), 0.2, np.float32)
    segs = (rng.random((9, 12, 8, 8)) < 0.3).astype(np.float32)
    lens = np.asarray([12, 9, 6, 3, 12, 1, 7, 10, 2], np.int32)
    return tpl, bg, segs, lens


def test_llr_rows_match_reference():
    tpl, bg, _s, _l = _keyword_problem()
    jw, jc = JBank(jnp.asarray(tpl), jnp.asarray(bg), ["a"] * 5).llr_rows()
    tw, tc = TemplateBank(torch.from_numpy(tpl), torch.from_numpy(bg),
                          ["a"] * 5).llr_rows()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("band", [2, 4])
def test_keyword_scores_batch_matches_reference(band):
    tpl, bg, segs, lens = _keyword_problem()
    jw, jc = JBank(jnp.asarray(tpl), jnp.asarray(bg), ["a"] * 5).llr_rows()
    want = jdtw.dtw_keyword_scores_batch(
        jnp.asarray(segs), jnp.asarray(lens), jw, jc, band, use_pallas=False,
    )
    got = tdtw.dtw_keyword_scores_batch(
        torch.from_numpy(segs), torch.from_numpy(lens),
        torch.from_numpy(np.asarray(jw)), torch.from_numpy(np.asarray(jc)), band,
    )
    assert got.shape == (9, 5)
    _scores_close(got.numpy(), want)
    one = tdtw.dtw_keyword_score(
        torch.from_numpy(segs[1]), int(lens[1]), torch.from_numpy(np.asarray(jw[2])),
        torch.from_numpy(np.asarray(jc[2])), band,
    )
    ref = jdtw.dtw_keyword_score(jnp.asarray(segs[1]), jnp.int32(lens[1]), jw[2], jc[2],
                                 band)
    np.testing.assert_allclose(float(one), float(ref), rtol=1e-5, atol=1e-5)


def test_keyword_scores_chunked_equals_unchunked():
    """Chunking the exhaustive rescore is pure batching: bitwise."""
    tpl, bg, segs, lens = _keyword_problem()
    w, c = TemplateBank(torch.from_numpy(tpl), torch.from_numpy(bg),
                        ["a"] * 5).llr_rows()
    args = (torch.from_numpy(segs), torch.from_numpy(lens), w, c, 3)
    whole = tdtw.dtw_keyword_scores_batch(*args)
    for cells in (1, 5 * 6 * 12 * 2, 5 * 6 * 12 * 4):     # 1, 2 and 4 segments a chunk
        assert torch.equal(tdtw.dtw_keyword_scores_batch(*args, _max_cells=cells), whole)


def test_frame_llr_matrix_matches_reference():
    tpl, bg, segs, _l = _keyword_problem()
    jw, jc = JBank(jnp.asarray(tpl), jnp.asarray(bg), ["a"] * 5).llr_rows()
    want = jdtw.frame_llr_matrix(jnp.asarray(segs[0]), jw[1], jc[1])
    got = tdtw.frame_llr_matrix(torch.from_numpy(segs[0]),
                                torch.from_numpy(np.asarray(jw[1])),
                                torch.from_numpy(np.asarray(jc[1])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
