"""The port's corpus-scale soak on the CPU: ``soak_cuda.py`` and
``soak_bank10k_cuda.py`` at 4 utterances against the reference's
``soak.py`` and ``soak_bank10k.py``.

* ``build_corpus(1)`` against ``soak.build_corpus(1)``: waveforms
  bitwise, utterance ids and phone labels equal;
* ``inflate_bank`` against ``soak_bank10k.inflate_bank`` on one numpy
  bank at K 40 and K 42 (not a multiple of 8: the scan pads it with 6
  zero templates): templates and labels bitwise;
* ``fault_resume_clean`` (``detect_corpus_sharded`` at mesh (1, 1, 1) in
  a gloo world of one, batch 2: 4 batches, the fault after 2) for the
  default config and DTW + int8: the fault after half the batches, the
  resume computing the other half, resumed == clean bitwise;
* the clean sharded scan with the inflated K 40 and K 42 banks against the
  reference's ``detect_corpus_stream`` on the same corpus and the same
  bank: times and template ids identical, scores rtol 1e-5 (the class
  of ``tests/test_torch_scan.py``'s stream) with an absolute floor of
  1e-6 x max|score|: the soak's utterances run to 21.5 s, and a score
  near 0 among scores of ~1,400 carries the f32 FFT's absolute error
  (the port's own stream is up to 9.8e-4 off the reference's here, 7e-7
  of max|score|, 1.2e-4 of that score);
* ``bank10k_soak`` at K 40: both scans pass their three holds;
* the repair of the K 10,000 bank's bf16 scores (ROADMAP Queue 3): kernel
  4's bf16 output (hi and the remainder lo, the two planes of ``fft_binmm``)
  keeps the f32 product, and with it the bf16 scorer (bf16 spectra, here
  on the CPU in the plain versions) stays within 2e-3 x max|score| of the
  f32 scorer on the soak bank, where the hi plane alone is 3e-3 off.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import card_checks
import soak
import soak_bank10k
import soak_bank10k_cuda
import soak_cuda
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu.scan import detect_corpus_stream as j_detect_corpus_stream
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.detect import fft_scorer as fs
from template_speech_recognition_tpu_torch.frontend.planes import frontend_batch_flat
from template_speech_recognition_tpu_torch.ops import fft_binmm_kernel as k4
from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3
from template_speech_recognition_tpu_torch.ops import fft_idft_kernel as k5
from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat
from template_speech_recognition_tpu_torch.parallel import detect_corpus_sharded
from template_speech_recognition_tpu_torch.pipeline import train_bank
from template_speech_recognition_tpu_torch.scan import bucket_length

CPU = torch.device("cpu")
K_SMALL = 40
BATCH = 2


@pytest.fixture(scope="module")
def corpus():
    return soak_cuda.build_corpus(1)


@pytest.fixture(scope="module")
def trained(corpus):
    return train_bank(corpus, list(card_checks.TRAIN_PHONES), soak_cuda.scan_config(BATCH),
                      device=CPU)


@pytest.fixture(scope="module")
def mesh():
    with soak_cuda.mesh_of_one(CPU) as m:
        yield m


def _inflated(trained, k):
    """The trained bank as numpy, inflated to K ``k`` by both packages."""
    tpl, bg = trained.templates.numpy(), trained.background.numpy()
    jbank = soak_bank10k.inflate_bank(JBank(jnp.asarray(tpl), jnp.asarray(bg),
                                            list(trained.labels)), k)
    tbank = soak_bank10k_cuda.inflate_bank(bank_from_numpy(tpl, bg, list(trained.labels),
                                                           CPU), k)
    return jbank, tbank


@pytest.fixture(scope="module", params=[K_SMALL, K_SMALL + 2], ids=["K40", "K42"])
def banks(request, trained):
    return _inflated(trained, request.param)


@pytest.fixture(scope="module")
def banks40(trained):
    return _inflated(trained, K_SMALL)


def test_build_corpus_matches_reference(corpus):
    want = soak.build_corpus(1).corpus
    got = corpus.corpus
    assert len(got.utterances) == len(want.utterances) == 4
    assert got.sample_rate == want.sample_rate and got.phone_names == want.phone_names
    for g, w in zip(got.utterances, want.utterances):
        assert g.utt_id == w.utt_id
        assert g.waveform.dtype == w.waveform.dtype
        np.testing.assert_array_equal(g.waveform, w.waveform)
        assert list(g.phones) == list(w.phones)


def test_inflate_bank_matches_reference(trained, banks):
    jbank, tbank = banks
    k = tbank.num_templates
    assert tbank.labels == jbank.labels == [f"kw{i:05d}" for i in range(k)]
    got, want = tbank.templates.numpy(), np.asarray(jbank.templates)
    assert got.dtype == want.dtype == np.float32 and k in (K_SMALL, K_SMALL + 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbank.background.numpy(), np.asarray(jbank.background))
    assert tbank.parts is None and jbank.parts is None
    # tiled perturbations of the trained templates, clipped
    k0 = trained.num_templates
    assert np.all((got >= 0.01) & (got <= 0.99))
    assert np.abs(got[k0] - trained.templates.numpy()[0]).max() <= 0.5


@pytest.mark.parametrize("dtw_int8", [False, True], ids=["default", "dtw_int8"])
def test_fault_resume_clean_is_bitwise(corpus, trained, mesh, dtw_int8):
    cfg = soak_cuda.scan_config(BATCH, dtw=dtw_int8, int8=dtw_int8)
    n = soak_cuda.count_batches(corpus, BATCH)
    rec = soak_cuda.fault_resume_clean(corpus, trained, cfg, mesh, CPU)
    clean = rec.pop("clean")
    assert n == 4 and rec["counters"]["batches"] == n
    assert rec["fault_run"] == {**rec["fault_run"], "batches": 4, "killed_after_batches": 2,
                                "shards_recorded": 2}
    assert (rec["resume_run"]["batches_computed"], rec["resume_run"]["shards_loaded"]) == (2, 2)
    assert rec["clean_run"]["detections"] == len(clean.detections.scores) > 0
    assert rec["clean_run"]["launches"] == {}          # the CPU runs the plain versions


def test_fault_never_fired_raises(corpus, trained, mesh, monkeypatch):
    """A fault that does not fire fails the soak."""
    monkeypatch.setattr(soak_cuda, "count_batches", lambda c, b: 99)
    with pytest.raises(soak_cuda.SoakFailed, match="never fired"):
        soak_cuda.fault_resume_clean(corpus, trained, soak_cuda.scan_config(BATCH), mesh, CPU)


def _per_utt(dets, n_utts):
    out = []
    for ui in range(n_utts):
        sel = dets.utterance_ids == ui
        order = np.lexsort((dets.template_ids[sel], dets.times[sel]))
        out.append((dets.scores[sel][order], dets.times[sel][order],
                    dets.template_ids[sel][order]))
    return out


def test_inflated_scan_matches_reference_stream(corpus, banks, mesh):
    jbank, tbank = banks
    want = j_detect_corpus_stream(soak.build_corpus(1), jbank,
                                  JC.PipelineConfig(detect=JC.DetectConfig(batch_size=BATCH)),
                                  "aa")
    got = detect_corpus_sharded(corpus, tbank, soak_cuda.scan_config(BATCH), mesh,
                                target_phone="aa")
    assert got.utt_ids == want.utt_ids
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    assert int(got.detections.template_ids.max()) < tbank.num_templates
    floor = 1e-6 * float(np.max(np.abs(want.detections.scores)))
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got.detections, 4),
                                          _per_utt(want.detections, 4)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=floor)


def test_bank10k_soak_holds(corpus, banks40, mesh):
    """``bank10k_soak`` at K 40: the bf16 and int8 scans (plain versions
    here) pass the plain, stream and launch holds; each record has the
    scan's numbers and the int8 scan its agreement with the bf16 one."""
    _jbank, tbank = banks40
    said = []
    recs = soak_bank10k_cuda.bank10k_soak(corpus, tbank, BATCH, mesh, CPU, said.append)
    assert set(recs) == {"bf16", "int8"}
    for rec in recs.values():
        assert rec["batches"] == 4 and rec["detections"] > 0 and rec["audio_s_per_s"] > 0
        assert rec["peak_bytes"] is None                  # no device: not measured
    assert 0.0 < recs["int8"]["matched_vs_bf16"] <= 1.0
    assert sum("vs detect_corpus_stream" in s for s in said) == 2


def test_split_binmm_keeps_the_f32_product():
    rng = np.random.default_rng(5)
    bins, m, d, k = 3, 10, 24, 16
    xr, xi = (torch.from_numpy(rng.standard_normal((bins, m, d)).astype(np.float32) * 40)
              .to(torch.bfloat16) for _ in range(2))
    w2 = torch.from_numpy(rng.standard_normal((bins, 2 * d, k)).astype(np.float32) * 30
                          + 60).to(torch.bfloat16)
    hi, lo = k4.fft_binmm(xr, xi, w2)
    assert tuple(hi.shape) == tuple(lo.shape) == (2, bins, m, k)
    want = k4.fft_binmm_plain(xr.float(), xi.float(), w2.float())
    assert torch.equal(hi, want.to(torch.bfloat16))      # hi is the rounded product
    top = float(want.abs().max())
    assert float((hi.float() + lo.float() - want).abs().max()) <= 2.0 ** -16 * top
    assert float((hi.float() - want).abs().max()) > 2.0 ** -12 * top


def test_split_int8_binmm_keeps_the_dequantized_product():
    rng = np.random.default_rng(6)
    bins, m, d, k = 3, 10, 24, 16
    xr, xi = (torch.from_numpy(rng.integers(-127, 128, (bins, m, d), dtype=np.int8))
              for _ in range(2))
    w2 = torch.from_numpy(rng.integers(-127, 128, (bins, 2 * d, k), dtype=np.int8))
    sc = torch.from_numpy(rng.random((bins, k)).astype(np.float32) * 0.3)
    hi, lo = k4.fft_binmm_int8(xr, xi, w2, sc)
    want = k4.fft_binmm_int8_plain(xr, xi, w2, sc, out_dtype=torch.float32)
    assert torch.equal(hi, want.to(torch.bfloat16))
    top = float(want.abs().max())
    assert float((hi.float() + lo.float() - want).abs().max()) <= 2.0 ** -16 * top
    assert float((hi.float() - want).abs().max()) > 2.0 ** -12 * top


def test_bf16_scorer_keeps_the_soak_bank_scores(corpus, banks40):
    """The soak's utterances and the inflated bank: the bf16 scorer (bf16
    spectra, the plain versions on the CPU, ``ycat`` split as on the
    card) against the f32 scorer, on the valid windows, and the same
    without the lo plane."""
    _jbank, tbank = banks40
    wavs = [w for _u, w, _p in corpus.iter_utterances()]
    pad = max(bucket_length(len(w)) for w in wavs)
    x = torch.zeros((len(wavs), pad))
    for i, w in enumerate(wavs):
        x[i, : len(w)] = torch.from_numpy(w)
    fcfg = soak_cuda.scan_config(BATCH).frontend
    fm = frontend_batch_flat(x, torch.tensor([len(w) for w in wavs], dtype=torch.int32), fcfg)
    wf, cf = tbank.llr()
    w = filters_to_flat(wf)
    length = w.shape[1]
    b16 = fs.build_fft_bank(w, cf, mm_dtype=torch.bfloat16)
    s16 = fs.fft_sliding_scores(fm.binary, b16, time_major=True)
    s32 = fs.fft_sliding_scores(fm.binary, fs.build_fft_bank(w, cf, mm_dtype=torch.float32),
                                time_major=True)
    nfft, t = b16.nfft, fm.binary.shape[1]
    hop, bins = nfft - length + 1, nfft // 2 + 1
    nblk = -(-(t - length + 1) // hop)
    xr, xi = k3.fft_block_dft(fm.binary.to(torch.bfloat16),
                              fs._dft_basis(nfft, torch.bfloat16, CPU), nfft, hop, nblk)
    hi_only = k5.fft_idft(k4.fft_binmm(xr, xi, b16.w2)[0].reshape(2 * bins, -1),
                          fs._idft_basis(nfft, hop, torch.bfloat16, CPU), b16.c,
                          nblk)[:, : t - length + 1]
    valid = (torch.arange(s32.shape[1])[None]
             < (fm.valid_frames - length + 1).clamp(min=0)[:, None])
    top = float(s32[valid].abs().max())
    err_split = float((s16 - s32).abs()[valid].max()) / top
    err_hi = float((hi_only - s32).abs()[valid].max()) / top
    assert err_split <= 2e-3 < 3e-3 <= err_hi, (err_split, err_hi)
