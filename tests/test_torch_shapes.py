"""The FFT scan at every template length, on the CPU.

Kernel 3 (``ops/fft_dft_kernel.py``) has a plan for every nfft that
``pick_nfft`` gives, at every template length 1..256 and bank size, and
for every nfft up to 2048 at L 32: its ``plan`` refuses only arguments
that are not a block DFT.  Its schedule, ``fft_block_dft_tiled``, is
held against the plain version and the reference's Pallas kernel in
interpret mode (one D-chunk of 128) at the plans past the resident
ones, the basis streamed in chunks of 128 rows: four passes of 128
columns (nfft 399), six of 96 (nfft 527), eight and 14 of 128 (nfft
1023, 1791); tolerance 1e-5 x
max|reference| (the same products summed in other float32 orders).
The streaming scan at L 48 and L 80 (nfft 239 and 399) gives the
reference's detections (times and template ids identical, scores at
rtol 1e-5, as the L 32 scan in ``test_torch_scan.py``).  The DTW
kernel's schedule past L 256 (the fused mode's c rows staged a chunk
at a time) is bitwise its plain versions and the reference's
``banded_dtw_pallas`` in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import oracle as O
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu.ops.dtw_pallas import banded_dtw_pallas
from template_speech_recognition_tpu.ops.fft_dft_pallas import fft_block_dft_pallas
from template_speech_recognition_tpu.pipeline import SyntheticAdapter
from template_speech_recognition_tpu.scan import (
    detect_corpus_stream as jax_detect_corpus_stream,
)
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd
from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3


def _check_plan(p, nfft, bins, d):
    """What the kernel's guard (``csrc/fft_block_dft.cu``) takes."""
    assert p.smem <= k3.SMEM_LIMIT and 2 <= p.stages <= k3.MAX_STAGES
    assert p.kp % 16 == 0 and p.kp >= nfft and 8 <= p.kb <= k3.MAX_BOX
    assert p.n % 32 == 0 and 32 <= p.n <= k3.MAX_N
    assert p.wgs in ((1, 2) if d > k3.TILE_D else (1,))
    if p.passes == 1:
        assert p.n == 2 * p.bp and p.bp >= bins
    else:
        assert p.passes % 2 == 0 and p.bp == p.passes // 2 * p.n and p.bp >= bins
    if p.streamed:
        assert p.kb == p.kc == k3.STREAM_KC < p.kp and p.n <= k3.STREAM_N
    else:
        # resident: one pass, or one a half; a window in one box or two
        assert p.kc == p.kp <= 2 * k3.MAX_BOX and p.passes <= 2
        assert p.kb == (p.kp if p.kp <= k3.MAX_BOX else p.kp // 2)


@pytest.mark.parametrize("bank_k", [8, 1024, 4096, 10000])
def test_plan_takes_every_template_length(bank_k):
    """A plan for every L 1..256 at this bank size (``pick_nfft``: hop
    ~4 L, ~6 L from 4096 templates), B 8, T_pad 3072, D 2048, 504, 40;
    one pass of the basis takes none of L 45-48 and 65-256 (K < 4096)
    or L 33-34 and 46-256 (K >= 4096)."""
    for length in range(1, 257):
        nfft = tfs.pick_nfft(length, bank_k)
        hop = nfft - length + 1
        nblk = -(-(3072 - length + 1) // hop)
        for d in (2048, 504, 40):
            _check_plan(k3.plan(8, d, nfft, nblk, nfft // 2 + 1), nfft, nfft // 2 + 1, d)


def test_plan_takes_every_nfft_at_L32():
    """Every nfft 2..2048 (every 16-aligned hop of L 32 among them, as
    the reference's sweeps choose nfft), D 2048, 504, 40."""
    for nfft in range(2, 2049):
        nblk = -(-(3072 - 31) // max(1, nfft - 31))
        for d in (2048, 504, 40):
            _check_plan(k3.plan(8, d, nfft, nblk, nfft // 2 + 1), nfft, nfft // 2 + 1, d)


# nfft -> (L, T): hop % 16 == 0 (the reference's kernel), the last window
# past T; the plan each must take (passes, basis columns a pass), streamed
LONG = {399: (80, 1060), 527: (32, 1192), 1023: (32, 2284), 1791: (256, 2236)}
LONG_KIND = {399: (4, 128), 527: (6, 96), 1023: (8, 128), 1791: (14, 128)}


def _g(nfft):
    cm, sm = tfs._dft_mats(nfft, torch.float32)
    return torch.cat([cm, -sm], dim=1).contiguous()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(LONG), ids=[f"nfft{n}" for n in sorted(LONG)])
def long_tiled(request):
    nfft = request.param
    length, t = LONG[nfft]
    hop = nfft - length + 1
    nblk = -(-(t - length + 1) // hop)
    rng = np.random.default_rng(nfft)
    x = torch.from_numpy((rng.random((2, t, 128)) < 0.3).astype(np.float32))
    g = _g(nfft)
    return (nfft, hop, nblk), x, g, k3.fft_block_dft_tiled(x, g, nfft, hop, nblk)


def test_long_plan_kinds(long_tiled):
    """Each case takes the streamed plan it stands for."""
    (nfft, hop, nblk), x, _g_, _out = long_tiled
    p = k3.plan(x.shape[0], x.shape[2], nfft, nblk, nfft // 2 + 1)
    assert p.streamed and (p.passes, p.n) == LONG_KIND[nfft]


def test_long_tiled_matches_plain(long_tiled):
    """Every output written (no NaN left), within 1e-5 x max|plain|."""
    (nfft, hop, nblk), x, g, got = long_tiled
    want = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
    for a, w in zip(got, want):
        assert tuple(a.shape) == (nfft // 2 + 1, x.shape[0], nblk, x.shape[2])
        assert not torch.isnan(a).any()
        _close(a.numpy(), w.numpy())


def test_long_tiled_matches_pallas(long_tiled):
    """Against the reference's Pallas kernel in interpret mode (dc 128),
    within 1e-5 x max|reference|."""
    (nfft, hop, nblk), x, g, got = long_tiled
    want = fft_block_dft_pallas(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), nfft, hop,
                                nblk, dc=128, interpret=True)
    for a, w in zip(got, want):
        _close(a.numpy(), w)


@pytest.fixture(scope="module")
def synth():
    return O.make_synthetic_corpus(num_utterances=3, phones_per_utterance=12, seed=5)


@pytest.mark.parametrize("length", [48, 80])
def test_stream_at_long_templates_matches_reference(synth, length):
    """``detect_corpus_stream`` with a random bank of 3 templates of L
    frames (nfft 239 / 399: two resident passes and four streamed on the card), batch 2
    over 3 utterances: the reference's detections, times and template ids
    identical, scores at rtol 1e-5."""
    fcfg = TC.FrontendConfig()
    rng = np.random.default_rng(length)
    templates = rng.uniform(0.05, 0.95, (3, length, fcfg.feature_freqs, 8)).astype(np.float32)
    background = rng.uniform(0.05, 0.95, (fcfg.feature_freqs, 8)).astype(np.float32)
    labels = ["aa", "iy", "aa"]
    jbank = JBank(templates=jnp.asarray(templates), background=jnp.asarray(background),
                  labels=labels)
    tbank = bank_from_numpy(templates, background, labels, device="cpu")
    assert tfs.pick_nfft(length, 3) == {48: 239, 80: 399}[length]
    want = jax_detect_corpus_stream(
        SyntheticAdapter(synth), jbank, JC.PipelineConfig(detect=JC.DetectConfig(batch_size=2)),
        "aa")
    got = tscan.detect_corpus_stream(
        TAdapter(synth), tbank, TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2)), "aa")
    assert got.utt_ids == want.utt_ids
    dg, dw = got.detections, want.detections
    assert len(dg.scores) == len(dw.scores) > 0
    for ui in range(len(got.utt_ids)):
        sg, sw = dg.utterance_ids == ui, dw.utterance_ids == ui
        og = np.lexsort((dg.template_ids[sg], dg.times[sg]))
        ow = np.lexsort((dw.template_ids[sw], dw.times[sw]))
        np.testing.assert_array_equal(dg.times[sg][og], dw.times[sw][ow])
        np.testing.assert_array_equal(dg.template_ids[sg][og], dw.template_ids[sw][ow])
        np.testing.assert_allclose(dg.scores[sg][og], dw.scores[sw][ow], rtol=1e-5)


@pytest.mark.parametrize("length,band,n", [(300, 6, 8), (300, 20, 8)],
                         ids=["L300-band6", "L300-band20"])
def test_dtw_emulated_past_L256(length, band, n):
    """The kernel's schedule at L 300 (the ring; at band 20, R 2
    registers a lane), raw and fused with each chunk's span of c rows,
    bitwise against the plain versions, and both bitwise against the
    reference's ``banded_dtw_pallas`` in interpret mode on the same cost
    (terminals, and the scores -total / (L + seg_len) of the fused cost
    cost - c[cid])."""
    rng = np.random.default_rng(length + band)
    m = length + band
    cost = torch.from_numpy((rng.standard_normal((n, length, m)) + 2.0).astype(np.float32))
    lens = torch.from_numpy(rng.integers(length // 2, m + 1, n).astype(np.int32))
    lens[0] = m
    ctab = torch.from_numpy(rng.standard_normal((3, length)).astype(np.float32))
    cid = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    assert not kd.whole_tile(cost[:, None], band)
    want = kd.banded_dtw_plain(cost, lens, band)
    got = kd.banded_dtw_emulated(cost, lens, band)
    finite = want < 1e37
    assert bool(finite.any())
    assert torch.equal(got[finite], want[finite]) and bool((got[~finite] > 1e38).all())
    want_s = kd.banded_dtw_scores_plain(-cost, lens, ctab, band, cid)
    assert torch.isfinite(want_s).any()
    got_s = kd.banded_dtw_emulated(-cost, lens, band, ctab, cid)
    assert torch.equal(got_s, want_s)
    fused = cost - ctab[cid.long()][:, :, None]
    ref = np.asarray(banded_dtw_pallas(jnp.asarray(cost.numpy()), jnp.asarray(lens.numpy()),
                                       band, interpret=True))
    ref_f = np.asarray(banded_dtw_pallas(jnp.asarray(fused.numpy()), jnp.asarray(lens.numpy()),
                                         band, interpret=True))
    np.testing.assert_array_equal(ref < 1e37, finite.numpy())
    np.testing.assert_array_equal(want.numpy()[finite.numpy()], ref[finite.numpy()])
    lsum = (length + lens.numpy()).astype(np.float32)
    ref_s = np.where(ref_f > 1e37, -np.inf, -ref_f / lsum).astype(np.float32)
    np.testing.assert_array_equal(want_s.numpy(), ref_s)


def test_dtw_takes_any_length():
    """The wrapper's domain: any L >= 1 and band >= 0 (past
    ``MAX_WINDOW`` in-band rows a diagonal, the wide route); L < 1 and a
    negative band raise."""
    for length, band in ((1, 0), (256, 300), (300, 6), (5000, 6), (600, 255), (511, 10**6),
                         (512, 256)):
        kd._check_length(length, band)
    for length, band in ((0, 6), (300, -1)):
        with pytest.raises(ValueError):
            kd._check_length(length, band)
