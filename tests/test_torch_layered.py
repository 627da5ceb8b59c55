"""The PyTorch port's layered frontend (the log-mel path) against the JAX
reference, on the CPU.

Kernel 1 in both modes, kernel 8 (the radix select) and kernel 9
(binarize + frequency spread) run their plain PyTorch versions here
(CPU tensors); the reference runs its Pallas kernels in interpret mode.
Inputs come from numpy with fixed seeds.  Tolerances: the planes as in
``test_torch_frontend.py`` (scaled error 1e-5 on well-conditioned
cells, the reference's fused-vs-unfused class elsewhere); counts, order
statistics and binary maps bitwise.  The arithmetic of kernel 1's CUDA
kernel (``csrc/frontend_planes.cu``), a 3-pass TF32 split, is emulated
here in fp32 (``split_tf32`` and three f32 matmuls) and held to what the
kernel is held to on the card (within 1e-5, scaled, of the float64
planes of ``planes64`` and within their error bound), and to the
reference at the plain version's tolerances; the wrapper's cached split
basis is checked against ``split_tf32``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import oracle as O
from template_speech_recognition_tpu.config import FrontendConfig as JFrontendConfig
from template_speech_recognition_tpu.frontend import features as jfeatures
from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.ops import dft as jdft
from template_speech_recognition_tpu.ops import edges as jedges
from template_speech_recognition_tpu.ops.binspread_pallas import (
    binarize_freqspread_pallas,
)
from template_speech_recognition_tpu.ops.frontend_pallas import (
    edge_response_planes_pallas,
)
from template_speech_recognition_tpu.ops.radix_pallas import radix_level_counts_pallas
from template_speech_recognition_tpu_torch import frontend as tfrontend
from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import dft as tdft
from template_speech_recognition_tpu_torch.ops import edges as tedges
from template_speech_recognition_tpu_torch.ops import frontend_kernel as k1
from template_speech_recognition_tpu_torch.ops.binspread_kernel import (
    binarize_freqspread,
    binarize_freqspread_plain,
)
from template_speech_recognition_tpu_torch.ops.radix_kernel import radix_level_counts_plain

MEL = FrontendConfig(use_mel=True)             # n_mels 64 -> F' = 63, D = 504
JMEL = JFrontendConfig(use_mel=True)


def _padded(n, seed, phones=4, pad=None):
    corpus = O.make_synthetic_corpus(
        num_utterances=n, phones_per_utterance=phones, seed=seed
    )
    wavs = [u.waveform for u in corpus.utterances]
    pad = pad or max(len(w) for w in wavs)
    x = np.zeros((n, pad), np.float32)
    for i, w in enumerate(wavs):
        x[i, : min(len(w), pad)] = w[:pad]
    return x, np.asarray([min(len(w), pad) for w in wavs], np.int32)


def _frames(cfg, t_pad=128):
    """Windowed frames of real audio, [2 * T_pad, frame_length]."""
    x, _ = _padded(2, seed=3, phones=6, pad=cfg.frame_length + (t_pad - 1) * cfg.hop_length)
    frames = tplanes._windowed_frames(torch.from_numpy(x), cfg).numpy()
    return frames.reshape(-1, cfg.frame_length)


def _well_conditioned(frames, cfg, n_mels, floor=1e-2):
    """Plane cells whose four spectrum inputs (power, or mel energy)
    are >= ``floor`` in float64: four decades above LOG_EPS."""
    c, s = (m.astype(np.float64) for m in tdft._dft_np(frames.shape[1], cfg.nfft))
    x = frames.astype(np.float64)
    p = (x @ c) ** 2 + (x @ s) ** 2
    if n_mels:
        p = p @ tdft._mel_np(cfg.sample_rate, cfg.nfft, n_mels).astype(np.float64)
        f = n_mels - 1
    else:
        f = cfg.nfft // 2
    ok = p >= floor
    return ok[:-1, :f] & ok[:-1, 1 : f + 1] & ok[1:, :f] & ok[1:, 1 : f + 1]


def _one_planes_call(monkeypatch):
    """Make ``edge_response_planes`` compute once and hand that output to
    every later call on equal inputs: a CPU fp32 GEMM does not promise
    the same bits on two calls, so claims that one function's output is
    a view of another's are held on one call's output."""
    real = k1.edge_response_planes
    memo = []

    def once(frames, *args, **kwargs):
        key = (args, sorted(kwargs.items()))
        for f, k, out in memo:
            if k == key and torch.equal(f, frames):
                return out
        memo.append((frames.clone(), key, real(frames, *args, **kwargs)))
        return memo[-1][2]

    monkeypatch.setattr(k1, "edge_response_planes", once)
    return memo


@pytest.mark.parametrize("nfft,n_mels", [(256, 0), (512, 40), (512, 64)])
def test_four_planes_match_reference(nfft, n_mels, monkeypatch):
    """Kernel 1's plain version, log-magnitude and log-mel, against the
    reference's four-output kernel in interpret mode; the four outputs
    and the channels-minor view are exactly the stacked output (all
    three functions read one call's planes)."""
    cfg = FrontendConfig(nfft=nfft, use_mel=n_mels > 0, n_mels=n_mels or 64)
    frames = _frames(cfg)
    ft = torch.from_numpy(frames)
    memo = _one_planes_call(monkeypatch)
    stacked = k1.edge_response_planes(ft, nfft, cfg.sample_rate, n_mels)
    four = k1.edge_response_planes_4(ft, nfft, cfg.sample_rate, n_mels)
    want = np.stack([np.asarray(p) for p in edge_response_planes_pallas(
        jnp.asarray(frames), nfft, interpret=True, sample_rate=cfg.sample_rate,
        n_mels=n_mels,
    )])
    f = n_mels - 1 if n_mels else nfft // 2
    assert stacked.shape == want.shape == (4, frames.shape[0], f)
    for i in range(4):
        assert torch.equal(four[i], stacked[i])
    resp = k1.edge_responses(ft, nfft, cfg.sample_rate, n_mels)
    assert len(memo) == 1
    assert torch.equal(resp[..., 0::2], stacked.permute(1, 2, 0))
    assert torch.equal(resp[..., 1::2], -stacked.permute(1, 2, 0))
    got, want = stacked.numpy()[:, :-1], want[:, :-1]    # last row: garbage
    ok = _well_conditioned(frames, cfg, n_mels)
    assert ok.mean() > 0.5
    assert np.max(np.abs(got - want)[:, ok]) / np.max(np.abs(want)) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_radix_level_counts_match_reference():
    """The TPU kernel's counting pass in plain PyTorch (the plain select's
    levels) against the reference kernel in interpret mode: R = 5 rows (not a multiple of 8), N = 2500 (not a
    multiple of its 1024-key block), masked keys, the candidates of real
    select levels and random ones.  Bitwise, except that the reference
    also counts its 0xFFFFFFFF padding toward the all-ones candidate:
    there it reads exactly the 524 padded keys more."""
    rng = np.random.default_rng(7)
    r, n, block = 5, 2500, 1024
    x = rng.standard_normal((r, n)).astype(np.float32)
    x[:, :300] = np.round(x[:, :300] * 2) / 2
    keys = np.array(jedges.order_keys(jnp.asarray(x)))
    keys[:, rng.random(n) < 0.2] = 0xFFFFFFFF
    keys[3, 2000:] = 0xFFFFFFFF
    pad = -(-n // block) * block - n
    for bits_done, w in ((2, 2), (5, 3), (20, 3), (32, 3)):
        shift = 32 - bits_done
        prefix = (keys[:, :1].astype(np.uint64) >> (shift + w)).astype(np.uint32)
        real = (prefix << np.uint32(w)) + np.arange(1 << w, dtype=np.uint32)
        wild = rng.integers(0, 1 << 32, (r, 16), dtype=np.uint64).astype(np.uint32)
        allones = np.uint32(0xFFFFFFFF >> shift)
        wild[:, 0] = allones
        for cand in (np.repeat(real, 2, axis=1), wild):
            want = np.asarray(radix_level_counts_pallas(
                jnp.asarray(keys), jnp.asarray(cand), shift, block_n=block,
                interpret=True,
            ))
            want = want - pad * (cand >= allones)
            args = (torch.from_numpy(keys.view(np.int32)),
                    torch.from_numpy(cand.view(np.int32)), shift)
            got = radix_level_counts_plain(*args)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def _random_planes(b, p, t, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, t, f)).astype(np.float32)
    # ties and signed zeros exercise rank ties and the +/-0 compares
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
    x[:, :, 5, :7] = -0.0
    x[:, :, 6, :7] = 0.0
    return x


@pytest.mark.parametrize("q", [0.3, 0.98])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_plane_order_statistics_match_reference(q, use_pallas):
    """Both ranks bitwise, with an utterance that has no valid row."""
    planes = _random_planes(3, 4, 256, 63)
    valid = np.asarray([256, 100, 0], np.int32)
    jhi, jlo = jplanes.plane_order_statistics(
        jnp.asarray(planes), jnp.asarray(valid), q, use_pallas=use_pallas
    )
    hi, lo = tplanes.plane_order_statistics(
        torch.from_numpy(planes), torch.from_numpy(valid), q
    )
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi).view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo).view(np.uint32))


def _thresholds(planes, valid, q):
    hi, lo = jplanes.plane_order_statistics(jnp.asarray(planes), jnp.asarray(valid), q)
    return np.array(hi), np.array(lo)


@pytest.mark.parametrize("rf", [0, 1, 2])
def test_binarize_freqspread_match_reference(rf):
    """Kernel 9's plain version against the reference kernel in
    interpret mode at F = 63, bitwise; the wrapper takes a strided
    [B, P] view of plane-major storage as the layered path hands it."""
    planes = _random_planes(2, 4, 256, 63, seed=1)
    valid = np.asarray([256, 77], np.int32)
    hi, lo = _thresholds(planes, valid, 0.98)
    want = np.asarray(binarize_freqspread_pallas(
        jnp.asarray(planes), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), rf,
        interpret=True,
    ))
    view = torch.from_numpy(np.ascontiguousarray(planes.transpose(1, 0, 2, 3))).transpose(0, 1)
    args = (torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid), rf)
    for pl in (torch.from_numpy(planes), view):
        for fn in (binarize_freqspread_plain, binarize_freqspread):
            got = fn(pl, *args)
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rf,rt,use_pallas", [(0, 0, True), (1, 1, True), (2, 1, True),
                                              (1, 1, False)])
def test_binarize_spread_flat_match_reference(rf, rt, use_pallas):
    planes = _random_planes(2, 4, 256, 63, seed=2)
    valid = np.asarray([200, 256], np.int32)
    hi, lo = _thresholds(planes, valid, 0.3)
    want = np.asarray(jplanes.binarize_spread_flat(
        jnp.asarray(planes), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        rt, rf, use_pallas=use_pallas,
    ))
    got = tplanes.binarize_spread_flat(
        torch.from_numpy(planes), torch.from_numpy(hi), torch.from_numpy(lo),
        torch.from_numpy(valid), rt, rf,
    )
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_path_rule_reads_shapes():
    assert tplanes._fused_ok(FrontendConfig())                       # F = 256
    assert not tplanes._fused_ok(MEL)                                # F = 63
    assert not tplanes._fused_ok(FrontendConfig(use_mel=True, n_mels=40))
    assert tplanes._fused_ok(FrontendConfig(use_mel=True, n_mels=129))  # F = 128
    assert tplanes._fused_ok(FrontendConfig(nfft=400))               # F = 200
    assert tplanes._fused_ok(FrontendConfig(nfft=4096))              # DFT width 2048
    # F = 484: more mel filters than one launch's shared memory holds,
    # which the kernel takes in chunks (k1.mel_chunks), so the two-kernel path
    assert tplanes._fused_ok(FrontendConfig(use_mel=True, n_mels=k1.MAX_MELS + 1))


@pytest.mark.parametrize("cfg", [FrontendConfig(), FrontendConfig(use_mel=True, n_mels=129)],
                         ids=["default", "mel129"])
def test_layered_equals_fused(cfg, monkeypatch):
    """The two paths give the same map, bit for bit (the reference's
    claim at planes.py:298-300), from one call's planes."""
    memo = _one_planes_call(monkeypatch)
    x, lens = _padded(3, seed=5)
    lens[2] = 300                      # shorter than a frame: no valid row
    args = (torch.from_numpy(x), torch.from_numpy(lens), cfg)
    layered = tplanes.frontend_batch_flat(*args, layered=True)
    fused = tplanes.frontend_batch_flat(*args, layered=False)
    assert layered.binary.any()
    assert len(memo) == 1
    assert torch.equal(layered.binary, fused.binary)
    assert torch.equal(layered.valid_frames, fused.valid_frames)


def test_mel_frontend_batch_flat_matches_reference():
    """The log-mel map against the reference's layered path with its
    Pallas kernels in interpret mode: same T_pad, equal on every valid
    row, False past it."""
    x, lens = _padded(2, seed=5)
    fm = tplanes.frontend_batch_flat(torch.from_numpy(x), torch.from_numpy(lens), MEL)
    jfm = jplanes.frontend_batch_flat(
        jnp.asarray(x), jnp.asarray(lens), JMEL, use_pallas=True
    )
    got, want = fm.binary.numpy(), np.asarray(jfm.binary)
    valid = fm.valid_frames.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jfm.valid_frames))
    assert got.shape == want.shape and got.shape[2] == 8 * 63
    for i, v in enumerate(valid):
        np.testing.assert_array_equal(got[i, :v], want[i, :v])
        assert not got[i, v:].any()


def test_edge_responses_and_spectrograms_match_reference():
    rng = np.random.default_rng(9)
    spec = rng.standard_normal((2, 11, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tedges.edge_responses(torch.from_numpy(spec)).numpy(),
        np.asarray(jedges.edge_responses(jnp.asarray(spec))),
    )
    frames = _frames(MEL)[:64]
    hi = jax.lax.Precision.HIGHEST
    np.testing.assert_allclose(
        tdft.log_mel_spectrogram(torch.from_numpy(frames), 512, 16000, 64).numpy(),
        np.asarray(jdft.log_mel_spectrogram(jnp.asarray(frames), 512, 16000, 64, hi)),
        rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        tdft.log_magnitude_spectrogram(torch.from_numpy(frames), 512).numpy(),
        np.asarray(jdft.log_magnitude_spectrogram(jnp.asarray(frames), 512, hi)),
        rtol=1e-4, atol=1e-3,
    )


@pytest.mark.parametrize("use_mel", [False, True])
def test_features_wrappers_match_reference(use_mel):
    """spectrogram allclose; frontend / frontend_batch maps on >= 99.9%
    of the valid cells (the reference's own class), and rows past valid
    False."""
    cfg, jcfg = FrontendConfig(use_mel=use_mel), JFrontendConfig(use_mel=use_mel)
    x, lens = _padded(2, seed=6)
    np.testing.assert_allclose(
        tfrontend.spectrogram(torch.from_numpy(x[0]), cfg).numpy(),
        np.asarray(jfeatures.spectrogram(jnp.asarray(x[0]), jcfg)),
        rtol=1e-4, atol=1e-3,
    )
    fm = tfrontend.frontend_batch(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    jfm = jfeatures.frontend_batch(jnp.asarray(x), jnp.asarray(lens), jcfg)
    one = tfrontend.frontend(torch.from_numpy(x[1]), int(lens[1]), cfg)
    got, want = fm.binary.numpy(), np.asarray(jfm.binary)
    assert got.shape == want.shape == (2, cfg.num_feature_frames(x.shape[1]),
                                       cfg.feature_freqs, 8)
    np.testing.assert_array_equal(fm.valid_frames.numpy(), np.asarray(jfm.valid_frames))
    np.testing.assert_array_equal(one.binary.numpy(), got[1])
    assert int(one.valid_frames) == int(fm.valid_frames[1])
    for i, v in enumerate(fm.valid_frames.numpy()):
        assert np.mean(got[i, :v] == want[i, :v]) >= 0.999
        assert not got[i, v:].any()


# ---- the kernel's 3-pass TF32 split, emulated in fp32 --------------------


@pytest.mark.parametrize("kind", ["normal", "tiny", "ties"])
def test_split_tf32_rounds_to_nearest(kind):
    """``split_tf32``: hi and lo are TF32 values (the low 13 mantissa
    bits zero); hi is x rounded to nearest, ties away from zero; and
    |x - hi - lo| <= 2^-22 |x|, or <= 2^-137 (half TF32's step among
    subnormals) where lo falls below the normal range.  A seeded sweep
    over 60 decades, subnormals, exact ties and signed zeros."""
    rng = np.random.default_rng(11)
    n = 20000
    if kind == "normal":
        x = rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
    elif kind == "tiny":                     # subnormals, and normals whose lo is subnormal
        x = rng.standard_normal(n) * 2.0 ** rng.uniform(-149, -96, n)
    else:                                    # the 13 dropped bits exactly half
        bits = (rng.integers(0x00800000, 0x7F000000, n) & ~0x1FFF) | 0x1000
        x = bits.astype(np.int32).view(np.float32) * rng.choice([-1.0, 1.0], n)
        x[::100], x[1::100] = 0.0, -0.0
    x = x.astype(np.float32)
    hi, lo = k1.split_tf32(torch.from_numpy(x))
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64, hi64, lo64 = x.astype(np.float64), hi.numpy().astype(np.float64), lo.numpy().astype(
        np.float64)
    half_step = np.spacing(np.abs(x)).astype(np.float64) * 2.0 ** 12
    assert np.all(np.abs(x64 - hi64) <= half_step)
    assert np.all(np.abs(x64 - hi64 - lo64) <= np.maximum(2.0 ** -22 * np.abs(x64), 2.0 ** -137))
    if kind == "ties":
        nz = x != 0
        assert np.all(np.abs(hi64[nz]) > np.abs(x64[nz]))
        assert np.all(np.signbit(hi.numpy()) == np.signbit(x))


def _split_planes(frames, nfft, sample_rate=0, n_mels=0):
    """The TF32 kernel's arithmetic in fp32 on the CPU: each DFT sum as
    hi.lo + lo.hi + hi.hi of ``split_tf32`` operands (three f32
    matmuls), then the plain version's power, log(-mel) and differences."""
    x = torch.from_numpy(frames)
    xh, xl = k1.split_tf32(x)
    cos_m, sin_m = tdft.dft_matrices(frames.shape[1], nfft)

    def dft(basis):
        bh, bl = k1.split_tf32(basis)
        return (xh @ bl + xl @ bh) + xh @ bh

    re, im = dft(cos_m), dft(sin_m)
    p = re * re + im * im
    eps = float(tdft.LOG_EPS)
    if n_mels:
        spec = torch.log(p @ tdft.mel_filterbank(sample_rate, nfft, n_mels) + eps)
        return k1._differences(spec, n_mels - 1)
    return k1._differences(0.5 * torch.log(p + eps), nfft // 2)


SPLIT_SHAPES = [(256, 0), (512, 40), (512, 64)]


@pytest.mark.parametrize("nfft,n_mels", SPLIT_SHAPES)
@pytest.mark.parametrize("source", ["audio", "noise"])
def test_split_planes_within_float64_bound(source, nfft, n_mels):
    """The 3-product planes within ``planes64``'s bound with the split's
    term on every cell (the row past the last too), and the plain
    version within the bound without it; real-audio frames, and white
    noise, whose deep cancellations put single DFT bins near the floor."""
    cfg = FrontendConfig(nfft=nfft, use_mel=n_mels > 0, n_mels=n_mels or 64)
    if source == "audio":
        frames = _frames(cfg)
    else:
        frames = np.random.default_rng(12).standard_normal((250, 400)).astype(np.float32)
    ft = torch.from_numpy(frames)
    for planes, split in ((_split_planes(frames, nfft, cfg.sample_rate, n_mels), True),
                          (k1.edge_response_planes_plain(ft, nfft, cfg.sample_rate, n_mels),
                           False)):
        ref, bound = k1.planes64(ft, nfft, cfg.sample_rate, n_mels, split=split)
        assert planes.shape == ref.shape
        assert float(((planes.double() - ref).abs() / bound).max()) <= 1.0


@pytest.mark.parametrize("nfft,n_mels", SPLIT_SHAPES)
def test_split_planes_match_reference(nfft, n_mels):
    """The 3-product planes against the reference's four-output kernel in
    interpret mode, at the tolerances of the plain version's tests:
    scaled error 1e-5 on well-conditioned cells, the reference's
    fused-vs-unfused class elsewhere."""
    cfg = FrontendConfig(nfft=nfft, use_mel=n_mels > 0, n_mels=n_mels or 64)
    frames = _frames(cfg)
    got = _split_planes(frames, nfft, cfg.sample_rate, n_mels).numpy()
    want = np.stack([np.asarray(p) for p in edge_response_planes_pallas(
        jnp.asarray(frames), nfft, interpret=True, sample_rate=cfg.sample_rate,
        n_mels=n_mels,
    )])
    assert got.shape == want.shape
    got, want = got[:, :-1], want[:, :-1]                 # last row: garbage
    ok = _well_conditioned(frames, cfg, n_mels)
    assert ok.mean() > 0.5
    assert np.max(np.abs(got - want)[:, ok]) / np.max(np.abs(want)) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("nfft,n_mels", SPLIT_SHAPES)
@pytest.mark.parametrize("source", ["audio", "noise"])
def test_split_planes_within_1e5_of_float64(source, nfft, n_mels):
    """The card's check of kernel 1 (``planes_metrics``), met by the
    emulated split: on the well-conditioned cells within 1e-5 of the
    float64 planes, scaled by max|plain|, and on every cell within the
    error bound with the split's term."""
    cfg = FrontendConfig(nfft=nfft, use_mel=n_mels > 0, n_mels=n_mels or 64)
    if source == "audio":
        frames = _frames(cfg)
    else:
        frames = np.random.default_rng(12).standard_normal((250, 400)).astype(np.float32)
    ft = torch.from_numpy(frames)
    m = k1.planes_metrics(ft, nfft, _split_planes(frames, nfft, cfg.sample_rate, n_mels),
                          k1.edge_response_planes_plain(ft, nfft, cfg.sample_rate, n_mels),
                          cfg.sample_rate, n_mels, split=True)
    assert m["share"] > 0.5
    assert m["scaled64"] <= 1e-5
    assert m["head"] <= 1.0 and m["plain_head"] <= 1.0


@pytest.mark.parametrize("frame_length", [398, 400])
def test_kernel_basis_is_the_split_dft(frame_length):
    """The wrapper's cached basis [6, bins, FL4] (FL4 = the frame length
    rounded up to 4, zero columns past it): ``split_tf32`` of the
    transposed ``dft_matrices``, then the unsplit cos and -sin."""
    nfft = 512
    basis = k1._basis_on(frame_length, nfft, "cpu")
    bins = nfft // 2 + 1
    assert tuple(basis.shape) == (6, bins, 400) and basis.dtype == torch.float32
    assert not basis[:, :, frame_length:].any()
    cos_m, sin_m = tdft.dft_matrices(frame_length, nfft)
    want = []
    for m in (cos_m, sin_m):
        want += list(k1.split_tf32(m.t().contiguous()))
    want += [cos_m.t(), sin_m.t()]
    for got, w in zip(basis[:, :, :frame_length], want):
        assert torch.equal(got, w)
