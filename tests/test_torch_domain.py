"""The kernels' whole domain, on the CPU: inputs the card used to refuse.

Four classes of input that the JAX reference scores and the port's
kernels once refused on the card: kernel 1's mel mode past ``MAX_MELS``
filters (now launched in chunks of filters), the DTW kernel's window
past ``MAX_WINDOW`` rows (the wide route), D % 8 != 0 or an unaligned
base in kernels 3, 4, 10 and 11 (rows zero-padded to D8), and kernel
10's extents past int32.  For each, the reference scores the input
first (its XLA route, or its Pallas kernel in interpret mode), then the
port's plain versions, emulations and padding helpers are held to it:
the map bitwise (apart from threshold ties), DTW terminals bitwise,
scores within the float32 class of the existing tests.  The CUDA paths
of the wrappers run with the device checks and the library stubbed, to
show that they pad or chunk and then launch the kernel, never the plain
version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from template_speech_recognition_tpu.config import FrontendConfig as JFrontendConfig
from template_speech_recognition_tpu.detect import fft_scorer as jfs
from template_speech_recognition_tpu.detect import scorer as js
from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.ops.dtw_pallas import banded_dtw_pallas, pair_llr_pallas
from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.convert import fft_bank_from_numpy
from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops import correlation_kernel as kc
from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd
from template_speech_recognition_tpu_torch.ops import fft_binmm_kernel as k4
from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3
from template_speech_recognition_tpu_torch.ops import frontend_kernel as k1
from template_speech_recognition_tpu_torch.ops import pair_llr_kernel as kp

MELS = [(485, 1024), (485, 2048), (968, 1024), (968, 2048)]


def _noise(seed=0, n=16000):
    """One second of seeded noise at 16 kHz, [1, n], and its length."""
    x = np.random.default_rng(seed).standard_normal((1, n)).astype(np.float32) * 0.1
    return x, np.array([n], np.int32)


def _chunked_plain(frames, nfft, sample_rate=0, n_mels=0):
    """The plain planes as the kernel's chunks compute them."""
    if n_mels:
        return k1.mel_planes_chunked_plain(frames, nfft, sample_rate, n_mels)
    return k1.edge_response_planes(frames, nfft, sample_rate, n_mels)


@pytest.mark.parametrize("n_mels,nfft", MELS, ids=[f"mels{m}-nfft{n}" for m, n in MELS])
def test_mel_past_max_mels_matches_reference(n_mels, nfft, monkeypatch):
    """The reference maps one second of noise at n_mels 485 and 968;
    the port's planes, computed in ``mel_chunks`` (2 and 3 chunks of
    <= MAX_MELS filters, adjacent chunks sharing a filter), are within
    1e-5 (scaled) of float64 and within their fp32 bound on every cell,
    and its map is the unchunked plain map bitwise and equals the
    reference's on every valid row, apart from cells whose response
    ties the threshold (at most 1e-3; 15 of 750,392 at n_mels 968, nfft
    2048)."""
    cfg = FrontendConfig(use_mel=True, n_mels=n_mels, nfft=nfft)
    jcfg = JFrontendConfig(use_mel=True, n_mels=n_mels, nfft=nfft)
    x, lens = _noise(n_mels + nfft)
    jfm = jplanes.frontend_batch_flat(jnp.asarray(x), jnp.asarray(lens), jcfg)
    want = np.asarray(jfm.binary)
    assert want.shape[2] == 8 * (n_mels - 1) and want.any()

    chunks = k1.mel_chunks(n_mels)
    assert len(chunks) == (2 if n_mels == 485 else 3) and k1.supported(nfft, n_mels)
    assert tplanes._fused_ok(cfg) == (n_mels == 485)          # F 484: kernel 2's path
    frames = tplanes._windowed_frames(torch.from_numpy(x), cfg)[0]
    planes = k1.mel_planes_chunked_plain(frames, nfft, cfg.sample_rate, n_mels)
    plain = k1.edge_response_planes_plain(frames, nfft, cfg.sample_rate, n_mels)
    m = k1.planes_metrics(frames, nfft, planes, plain, cfg.sample_rate, n_mels)
    assert m["share"] > 0 and m["scaled64"] <= 1e-5 and m["head"] <= 1.0
    assert float((planes - plain).abs().max()) <= 1e-5 * float(plain.abs().max())

    one = tplanes.frontend_batch_flat(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    monkeypatch.setattr(k1, "edge_response_planes_plain", _chunked_plain)
    fm = tplanes.frontend_batch_flat(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    assert torch.equal(fm.binary, one.binary)                # chunks: the one-call map
    got = fm.binary.numpy()
    valid = fm.valid_frames.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jfm.valid_frames))
    v = int(valid[0])
    assert got.shape[2] == want.shape[2] and not got[0, v:].any()
    assert np.mean(got[0, :v] != want[0, :v]) <= 1e-3


def test_mel_chunks_cover_every_column_once():
    """``mel_chunks``: ranges of <= MAX_MELS filters, adjacent ranges
    sharing one filter, their plane columns [c0, c1) covering [0,
    n_mels - 1) once; one range up to MAX_MELS."""
    for n_mels in (2, 3, 64, k1.MAX_MELS, k1.MAX_MELS + 1, 966, 967, 968, 2000):
        chunks = k1.mel_chunks(n_mels)
        assert chunks[0][0] == 0 and chunks[-1][1] == n_mels - 1
        assert all(c1 - c0 + 1 <= k1.MAX_MELS and c1 - c0 >= 1 for c0, c1 in chunks)
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        cols = [f for c0, c1 in chunks for f in range(c0, c1)]
        assert cols == list(range(n_mels - 1))
        assert (len(chunks) == 1) == (n_mels <= k1.MAX_MELS)
    assert k1.mel_chunks(k1.MAX_MELS) == [(0, k1.MAX_MELS - 1)]


def _stub_cuda(monkeypatch, names):
    """The CUDA paths of the wrappers on CPU tensors: device checks and
    the stream stubbed, pointers passed as the tensors themselves, and a
    library whose entries record their arguments and return 0."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "ptr", lambda t: t)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda _dev: None)
    calls = []

    class Lib:
        pass

    for name in names:
        def entry(*a, _name=name):
            calls.append((_name, a))
            return 0
        setattr(Lib, name, staticmethod(entry))
    monkeypatch.setattr(_cuda, "load", lambda stem: Lib)
    return calls


def test_mel_wrapper_launches_a_chunk_at_a_time(monkeypatch):
    """Kernel 1's CUDA path at n_mels 968: three launches, each with its
    filters' rows of the cached filterbank, its filter count, the planes'
    width and its column offset; the split basis made once; the plain
    version never called."""
    calls = _stub_cuda(monkeypatch, ["tsr_frontend_planes"])
    monkeypatch.setattr(k1, "edge_response_planes_plain", None)
    frames = torch.zeros((70, 400))
    _cuda.reset_launches()
    out = k1.edge_response_planes(frames, 2048, 16000, 968)
    assert tuple(out.shape) == (4, 70, 967)
    fbt, _rng = k1._mel_on(16000, 2048, 968, "cpu")
    assert [tuple(a[8:11]) for _n, a in calls] == [
        (c1 - c0 + 1, 967, c0) for c0, c1 in k1.mel_chunks(968)]
    for (_n, a), (c0, _c1) in zip(calls, k1.mel_chunks(968)):
        assert a[2].data_ptr() == fbt.data_ptr() + c0 * fbt.shape[1] * 4
        assert a[1] is calls[0][1][1]                      # one cached basis
    assert _cuda.launch_counts() == {k1.MEL_NAME: 3}


WIDE = [(520, 260), (700, 10**6)]


@pytest.mark.parametrize("length,band", WIDE, ids=[f"L{l}-band{b}" for l, b in WIDE])
def test_dtw_wide_route_matches_reference(length, band):
    """The reference scores windows past 511 rows; the wide route's
    schedule (``banded_dtw_emulated``: one pair a block, the window's
    positions in double-buffered state with unreachable ends) gives the
    plain version's and the reference's terminals bitwise, raw and fused
    (scores -total / (L + seg_len) of the cost cost - c[cid])."""
    rng = np.random.default_rng(length)
    n, m = 8, length + 30
    cost = torch.from_numpy((rng.standard_normal((n, length, m)) + 2.0).astype(np.float32))
    lens = torch.from_numpy(rng.integers(length // 2, m + 1, n).astype(np.int32))
    lens[0] = m
    ref = np.asarray(banded_dtw_pallas(jnp.asarray(cost.numpy()), jnp.asarray(lens.numpy()),
                                       band, interpret=True))
    finite = ref < 1e37
    assert finite.any()
    assert kd.is_wide(length, m, band) and min(2 * band + 1, length) > kd.MAX_WINDOW
    kd._check_length(length, band)
    want = kd.banded_dtw_plain(cost, lens, band)
    got = kd.banded_dtw_emulated(cost, lens, band)
    np.testing.assert_array_equal(want.numpy()[finite], ref[finite])
    assert torch.equal(got[torch.from_numpy(finite)], want[torch.from_numpy(finite)])
    assert bool((got[torch.from_numpy(~finite)] > 1e38).all())
    ctab = torch.from_numpy(rng.standard_normal((3, length)).astype(np.float32))
    cid = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    fused = cost - ctab[cid.long()][:, :, None]
    ref_f = np.asarray(banded_dtw_pallas(jnp.asarray(fused.numpy()), jnp.asarray(lens.numpy()),
                                         band, interpret=True))
    lsum = (length + lens.numpy()).astype(np.float32)
    ref_s = np.where(ref_f > 1e37, -np.inf, -ref_f / lsum).astype(np.float32)
    want_s = kd.banded_dtw_scores_plain(-cost, lens, ctab, band, cid)
    got_s = kd.banded_dtw_emulated(-cost, lens, band, ctab, cid)
    np.testing.assert_array_equal(want_s.numpy(), ref_s)
    assert torch.equal(got_s, want_s)


def test_dtw_wide_route_rule_and_scratch(monkeypatch):
    """The wide route's rule (past MAX_WINDOW in-band rows, or band
    expressions past int32) and schedule: WP = min(2*band+1, L, M) + 1
    positions, up to 1024 threads, scratch past the shared memory's
    state; the CUDA path allocates that scratch, 4 * (WP + 2) words a
    pair, only then, and passes it to the one launch."""
    assert not kd.is_wide(511, 600, 255) and kd.is_wide(512, 600, 256)
    assert kd.is_wide(40000, 20000, 6) and not kd.is_wide(30000, 20, 6)
    assert kd.wide_schedule(601, 641, 300) == {"WP": 602, "T": 608, "scratch_words": 0}
    assert kd.wide_schedule(5000, 300, 10**6)["WP"] == 301
    big = kd.wide_schedule(13000, 13000, 10**6)
    assert big["T"] == 1024 and big["scratch_words"] == 4 * (13001 + 2)
    calls = _stub_cuda(monkeypatch, ["tsr_banded_dtw"])
    cost = torch.zeros((3, 520, 540))
    lens = torch.full((3,), 540, dtype=torch.int32)
    _cuda.reset_launches()
    kd.banded_dtw(cost, lens, 260)
    assert calls[-1][1][5] is None and _cuda.launch_counts() == {kd.NAME: 1}
    monkeypatch.setattr(kd, "WIDE_SMEM_WORDS", 0)
    kd.banded_dtw(cost, lens, 260)
    scratch = calls[-1][1][5]
    assert tuple(scratch.shape) == (3 * 4 * (521 + 2),)


def _pair_llr_reference(feats, w16, rowstart, ids, m):
    """The reference kernel in interpret mode (as tests/test_torch_pair_llr.py
    calls it): windows from 8-row-aligned starts, columns shifted back."""
    b, t, d = feats.shape
    rs = rowstart.numpy()
    m_dma = m + 8
    flat = np.zeros((-(-(b * t + m_dma) // 8) * 8, d), np.float32)
    flat[: b * t] = feats.numpy().reshape(b * t, d)
    row0 = rs & ~7
    ext = np.asarray(pair_llr_pallas(
        jnp.asarray(flat, jnp.bfloat16), jnp.asarray(w16.to(torch.float32).numpy(), jnp.bfloat16),
        jnp.asarray(row0 >> 3), jnp.asarray(ids.numpy()), m_dma, interpret=True))
    return np.stack([ext[p, :, o : o + m] for p, o in enumerate(rs - row0)])


@pytest.mark.parametrize("d", [500, 36, 3])
def test_padded_operands_match_reference(d):
    """D % 8 != 0: the reference scores the direct correlation (its API
    path, Pallas in interpret mode), the pair LLR (its Pallas kernel in
    interpret mode) and the FFT scan (its XLA route); the port's plain
    versions on the operands padded as the wrappers pad them
    (``_cuda.aligned_rows``) and the FFT scan on a bank padded to D8 rows
    a half give the same scores (rtol and atol 1e-4 for the correlation,
    as its tests; 1e-5 x max for the others)."""
    rng = np.random.default_rng(d)
    b, t, k, length = 2, 120, 5, 9
    feats = (rng.random((b, t, d)) < 0.3).astype(np.float32)
    w = rng.standard_normal((k, length, d)).astype(np.float32)
    c = rng.standard_normal(k).astype(np.float32)
    fp_, wp_ = _cuda.aligned_rows(torch.from_numpy(feats)), _cuda.aligned_rows(torch.from_numpy(w))
    d8 = -(-d // 8) * 8
    assert fp_.shape[-1] == wp_.shape[-1] == d8 and fp_.data_ptr() % 16 == 0
    assert not bool(fp_[..., d:].any()) and not bool(wp_[..., d:].any())

    # the direct correlation
    for bi in range(b):
        want = np.asarray(js.sliding_scores_backend(
            jnp.asarray(feats[bi][:, :, None]), jnp.asarray(w[..., None]), jnp.asarray(c),
            backend="pallas", compute_dtype=jnp.float32))
        got = kc.correlation_scores_plain(fp_[bi : bi + 1], wp_, torch.from_numpy(c))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    # the pair LLR, windows into the next utterance and past the map's end
    fmap = torch.from_numpy(feats > 0)
    w16 = torch.from_numpy(w).to(torch.bfloat16)
    rowstart = torch.from_numpy(np.array([0, 3, t - 5, t + 7, b * t - 20, 40], np.int32))
    ids = torch.from_numpy(np.array([0, 4, 2, 1, 3, 4], np.int32))
    want = _pair_llr_reference(fmap, w16, rowstart, ids, 16)
    got = kp.pair_llr_plain(_cuda.aligned_rows(fmap), _cuda.aligned_rows(w16), rowstart, ids, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    # the FFT scan: the reference's bank carried across (padded at the
    # carry) and the port's own bank, the map padded once a call
    jbank = jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c))
    want = np.asarray(jfs.fft_sliding_scores(jnp.asarray(feats), jbank, use_pallas=False))
    tbank = fft_bank_from_numpy(np.asarray(jbank.w2), np.asarray(jbank.c), jbank.length,
                                jbank.nfft, jbank.d, device="cpu")
    own = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c))
    for bank in (tbank, own):
        assert bank.d == d and bank.dp == d8 and bank.w2.shape[1] == 2 * d8
        got = tfs.fft_sliding_scores(fmap, bank).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # kernel 3 and 4's plain versions on the padded map and bank: the
    # first D spectra columns are the unpadded ones', the rest zero
    nfft = own.nfft
    hop, nblk = nfft - length + 1, -(-(t - length + 1) // (nfft - length + 1))
    g = tfs._dft_basis(nfft, torch.float32, torch.device("cpu"))
    xr, xi = k3.fft_block_dft_plain(fp_, g, nfft, hop, nblk)
    xr0, xi0 = k3.fft_block_dft_plain(torch.from_numpy(feats), g, nfft, hop, nblk)
    torch.testing.assert_close(xr[..., :d], xr0, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(xi[..., :d], xi0, rtol=1e-6, atol=1e-5)
    assert not bool(xr[..., d:].any()) and not bool(xi[..., d:].any())
    y = k4.fft_binmm_plain(xr, xi, own.w2)
    y0 = k4.fft_binmm_plain(xr0, xi0, tfs._bank_spectra(torch.from_numpy(w), nfft,
                                                       torch.float32))
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-4 * float(y0.abs().max()))


@pytest.mark.parametrize("mm", ["float32", "int8"])
def test_padded_banks_agree(mm):
    """A bank of D 36 built by the port and the reference's carried
    across by ``convert.fft_bank_from_numpy`` are one bank: the same
    [bins, 2 D8, K] spectra (D8 = 40), each half's rows past D zero (and
    the int8 bank's K-major copy of D8 rows padded to 16), the values
    within float32 rounding (int8: within one step)."""
    rng = np.random.default_rng(36)
    w = rng.standard_normal((8, 7, 36)).astype(np.float32)
    c = rng.standard_normal(8).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if mm == "float32" else (jnp.int8, torch.int8)
    jbank = jfs.build_fft_bank(jnp.asarray(w), jnp.asarray(c), mm_dtype=jdt)
    carried = fft_bank_from_numpy(
        np.asarray(jbank.w2), np.asarray(jbank.c), jbank.length, jbank.nfft, jbank.d,
        device="cpu", w2_scale=None if mm == "float32" else np.asarray(jbank.w2_scale))
    own = tfs.build_fft_bank(torch.from_numpy(w), torch.from_numpy(c), mm_dtype=tdt)
    bins = jbank.nfft // 2 + 1
    for bank in (carried, own):
        assert tuple(bank.w2.shape) == (bins, 80, 8) and bank.dp == 40 and bank.d == 36
        halves = bank.w2.reshape(bins, 2, 40, 8)
        assert not bool(halves[:, :, 36:].any())
    np.testing.assert_array_equal(carried.w2.reshape(bins, 2, 40, 8)[:, :, :36].numpy(),
                                  np.asarray(jbank.w2).reshape(bins, 2, 36, 8))
    a, b = carried.w2.to(torch.float32), own.w2.to(torch.float32)
    if mm == "float32":
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(a.abs().max()))
    else:
        assert float((a - b).abs().max()) <= 1
        for bank in (carried, own):
            assert tuple(bank.w2_kmajor.shape) == (bins, 2, 8, 48)
            assert torch.equal(bank.w2_kmajor, k4.kmajor_spectra(bank.w2))


def test_aligned_rows_copies_only_what_it_must():
    """At D % 8 = 0, contiguous, from a 16-byte aligned base: the tensor
    itself (no copy on the default path).  Else a fresh contiguous,
    aligned copy, zero columns to D8."""
    x = torch.rand(3, 50, 504).to(torch.bfloat16)
    assert _cuda.aligned_rows(x) is x
    off = torch.zeros(3 * 50 * 504 + 8, dtype=torch.bfloat16)[1 : 1 + 3 * 50 * 504]
    off = off.view(3, 50, 504)
    off.copy_(x)
    got = _cuda.aligned_rows(off)
    assert got is not off and got.data_ptr() % 16 == 0 and torch.equal(got, x)
    y = _cuda.aligned_rows(x[..., :500])
    assert tuple(y.shape) == (3, 50, 504) and y.is_contiguous()
    assert torch.equal(y[..., :500], x[..., :500]) and not bool(y[..., 500:].any())
    b = torch.rand(2, 7, 3) < 0.5
    assert tuple(_cuda.aligned_rows(b).shape) == (2, 7, 8)


def test_correlation_launch_rule_past_int32():
    """Kernel 10's launch rule as a pure function: B*T'' past 2^31 (D 8,
    B 524,289 utterances of T'' 4,096) and L*D past 2^31 take one launch;
    only an extent past an int or a grid past its limits raises."""
    kc.check_launch(524289, 4097, 8, 1, 2)
    assert 524289 * 4096 > 2**31
    kc.check_launch(1, 32769 + 191, 65536, 1, 32769)
    assert 32769 * 65536 > 2**31
    kc.check_launch(1, 3000, 2048, 65535 * 128, 32)
    for args in ((1, 3000, 2048, 65536 * 128, 32), (2**31 // 22 + 1, 4097, 8, 1, 2),
                 (1, 2**31 - 100, 8, 1, 2)):
        with pytest.raises(ValueError):
            kc.check_launch(*args)


@pytest.mark.parametrize("kernel", ["correlation", "pair_llr", "fft_binmm"])
def test_wrappers_pad_and_launch(kernel, monkeypatch):
    """The CUDA paths of kernels 10, 11 and 4 at D 36 and at a base one
    element off: one launch of the kernel on fresh, aligned operands of
    D8 = 40 columns (W2's halves padded alike), never the plain
    version."""
    entry = {"correlation": "tsr_correlation", "pair_llr": "tsr_pair_llr",
             "fft_binmm": "tsr_fft_binmm"}[kernel]
    calls = _stub_cuda(monkeypatch, [entry])
    for mod, plain in ((kc, "correlation_scores_plain"), (kp, "pair_llr_plain"),
                       (k4, "fft_binmm_plain")):
        monkeypatch.setattr(mod, plain, None)
    rng = np.random.default_rng(4)

    def offset(t):
        buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
        v = buf[1 : 1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    for d, shift in ((36, False), (40, True)):
        _cuda.reset_launches()
        calls.clear()
        if kernel == "correlation":
            x = torch.from_numpy(rng.random((2, 50, d)) < 0.3).to(torch.bfloat16)
            w = torch.randn(3, 5, d).to(torch.bfloat16)
            args = (offset(x) if shift else x, offset(w) if shift else w, torch.zeros(3))
            kc.correlation_scores(*args)
            ops, d_at = calls[0][1][:2], 6
        elif kernel == "pair_llr":
            x = torch.from_numpy(rng.random((2, 50, d)) < 0.3)
            w = torch.randn(3, 5, d).to(torch.bfloat16)
            rs = torch.tensor([0, 7], dtype=torch.int32)
            ids = torch.tensor([1, 2], dtype=torch.int32)
            kp.pair_llr(offset(x) if shift else x, offset(w) if shift else w, rs, ids, 16)
            ops, d_at = calls[0][1][:2], 9
        else:
            xr = torch.randn(3, 10, d).to(torch.bfloat16)
            xi = torch.randn(3, 10, d).to(torch.bfloat16)
            w2 = torch.randn(3, 2 * d, 8).to(torch.bfloat16)
            k4.fft_binmm(offset(xr) if shift else xr, xi, offset(w2) if shift else w2)
            ops, d_at = calls[0][1][:3], 6
            w2p = ops[2]
            assert tuple(w2p.shape) == (3, 80, 8) and w2p.data_ptr() % 16 == 0
            halves = w2p.reshape(3, 2, 40, 8)
            assert torch.equal(halves[:, :, :d], w2.reshape(3, 2, d, 8))
            assert not bool(halves[:, :, d:].any())
            ops = ops[:2]
        assert len(calls) == 1 and _cuda.launch_counts() == {
            {"correlation": kc.NAME, "pair_llr": kp.NAME, "fft_binmm": k4.NAME}[kernel]: 1}
        assert calls[0][1][d_at] == 40
        for t in ops:
            assert t.shape[-1] == 40 and t.is_contiguous() and t.data_ptr() % 16 == 0
