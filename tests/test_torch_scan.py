"""The PyTorch port's streaming scan end to end against the JAX
reference, on the CPU, plus the port's package rules (no jax, no import
of the JAX package) and its CLI."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import oracle as O
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.pipeline import SyntheticAdapter, train_bank
from template_speech_recognition_tpu.scan import (
    detect_corpus_stream as jax_detect_corpus_stream,
)
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.frontend import planes as tplanes

PKG = "template_speech_recognition_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth():
    return O.make_synthetic_corpus(num_utterances=7, phones_per_utterance=5, seed=3)


@pytest.fixture(scope="module")
def jbank(synth):
    return train_bank(SyntheticAdapter(synth), ["aa"], JC.PipelineConfig())


@pytest.fixture(scope="module")
def tbank(jbank):
    return bank_from_numpy(
        np.asarray(jbank.templates), np.asarray(jbank.background),
        jbank.labels, device="cpu",
    )


@pytest.fixture(scope="module")
def jbank4(synth):
    """Two classes x two mixture components: K = 4 templates, so the
    exhaustive rescore has a winner to choose."""
    cfg = JC.PipelineConfig(template=JC.TemplateConfig(num_components=2))
    return train_bank(SyntheticAdapter(synth), ["aa", "iy"], cfg)


@pytest.fixture(scope="module")
def tbank4(jbank4):
    return bank_from_numpy(
        np.asarray(jbank4.templates), np.asarray(jbank4.background),
        jbank4.labels, device="cpu",
    )


def _per_utt(result):
    d = result.detections
    out = []
    for ui in range(len(result.utt_ids)):
        sel = d.utterance_ids == ui
        order = np.lexsort((d.template_ids[sel], d.times[sel]))
        out.append((d.scores[sel][order], d.times[sel][order],
                    d.template_ids[sel][order]))
    return out


def test_scan_detections_match_reference(synth, jbank, tbank):
    """Identical detections (times and template ids) with scores at
    rtol 1e-5; batch_size 3 over 7 utterances exercises the tail."""
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3))
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank, tcfg, "aa")
    assert got.utt_ids == want.utt_ids
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5)
    for lg, lw in zip(got.labels_per_utterance, want.labels_per_utterance):
        np.testing.assert_array_equal(lg, lw)
    assert got.audio_seconds == pytest.approx(want.audio_seconds)
    for key in ("utterances", "frames", "windows_scored", "detections"):
        assert got.counters[key] == want.counters[key]
    assert got.counters["audio_s_per_s"] > 0
    assert got.counters["batches"] == 3


def test_scan_feature_maps_match_reference(synth):
    """The scan's frontend, at the default config and bucket, agrees
    with the JAX CPU frontend on >= 99.9% of the valid cells."""
    wavs = [u.waveform for u in synth.utterances]
    pad = max(tscan.bucket_length(len(w)) for w in wavs)
    x = np.zeros((len(wavs), pad), np.float32)
    for i, w in enumerate(wavs):
        x[i, : len(w)] = w
    lens = np.asarray([len(w) for w in wavs], np.int32)
    fm = tplanes.frontend_batch_flat(
        torch.from_numpy(x), torch.from_numpy(lens), TC.FrontendConfig()
    )
    jfm = jplanes.frontend_batch_flat(
        jnp.asarray(x), jnp.asarray(lens), JC.FrontendConfig()
    )
    got, want = fm.binary.numpy(), np.asarray(jfm.binary)
    valid = fm.valid_frames.numpy()
    agree = sum(int(np.sum(got[i, :v] == want[i, :v])) for i, v in enumerate(valid))
    total = sum(got[i, :v].size for i, v in enumerate(valid))
    assert agree / total >= 0.999


@pytest.mark.parametrize("detect_kw", [
    {"score_backend": "pallas"}, {"score_backend": "conv"}, {"exact_scores": True},
])
def test_unported_options_raise(synth, jbank, tbank, detect_kw):
    """The stream's options as the reference has them: ``pallas`` raises
    the reference's ``ValueError``, exact scores a ``ValueError`` that
    names ``detect_corpus`` (which runs them), and ``conv`` scans: the
    f32 conv's detections equal the reference's (times and template
    ids identical, scores at rtol 1e-5)."""
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3, **detect_kw))
    if "exact_scores" in detect_kw:
        with pytest.raises(ValueError, match="detect_corpus"):
            tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa")
        return
    if detect_kw["score_backend"] == "pallas":
        with pytest.raises(ValueError, match="fft|conv"):
            tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa")
        return
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3, **detect_kw))
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa")
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5)
    assert got.counters["batches"] == 3


def _cfgs(top_r=1, **detect_kw):
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3, **detect_kw),
                             dtw=JC.DTWConfig(top_r=top_r))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3, **detect_kw),
                             dtw=TC.DTWConfig(top_r=top_r))
    return jcfg, tcfg


@pytest.mark.parametrize("top_r", [1, 0])
def test_scan_dtw_rescore_matches_reference(synth, jbank4, tbank4, top_r):
    """Config 4 on the CPU: identical times and template ids, rescored
    scores at rtol 1e-5 (top_r 0 picks the winner among K = 4)."""
    jcfg, tcfg = _cfgs(top_r, dtw_rescore=True)
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank4, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank4, tcfg, "aa")
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(got.detections.scores))


def _matched(got, want):
    """(matched peaks, same-id peaks, [(score got, score want)] of
    same-id peaks) over (utterance, time)."""
    pairs, n_match, n_same = [], 0, 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        a = {int(t): (int(k), float(s)) for s, t, k in zip(sg, tg, kg)}
        b = {int(t): (int(k), float(s)) for s, t, k in zip(sw, tw, kw)}
        for t in set(a) & set(b):
            n_match += 1
            if a[t][0] == b[t][0]:
                n_same += 1
                pairs.append((a[t][1], b[t][1]))
    return n_match, n_same, np.asarray(pairs)


@pytest.mark.parametrize("dtw", [False, True])
def test_scan_int8_spectra_matches_reference(synth, jbank4, tbank4, dtw):
    """int8 spectra: the block spectra quantize per call, so a peak may
    move; identical (time, id) on >= 99% of matched peaks, and with
    DTW the rescored scores (a function of time, id and the map) of
    those peaks at rtol 1e-5."""
    jcfg, tcfg = _cfgs(1, dtw_rescore=dtw, int8_spectra=True)
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank4, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank4, tcfg, "aa")
    n = max(len(got.detections.scores), len(want.detections.scores))
    n_match, n_same, pairs = _matched(got, want)
    assert n > 0 and n_match >= 0.99 * n and n_same >= 0.99 * n_match
    if dtw:
        np.testing.assert_allclose(pairs[:, 0], pairs[:, 1], rtol=1e-5, atol=1e-6)
    else:
        top = np.max(np.abs(pairs[:, 1]))
        np.testing.assert_allclose(pairs[:, 0], pairs[:, 1], rtol=0, atol=1e-2 * top)


@pytest.fixture(scope="module")
def jbank_mel(synth):
    """A JAX-trained log-mel bank (n_mels 64: F' = 63, D = 504), two
    classes x two mixture components."""
    cfg = JC.PipelineConfig(frontend=JC.FrontendConfig(use_mel=True),
                            template=JC.TemplateConfig(num_components=2))
    return train_bank(SyntheticAdapter(synth), ["aa", "iy"], cfg)


@pytest.fixture(scope="module")
def tbank_mel(jbank_mel):
    return bank_from_numpy(
        np.asarray(jbank_mel.templates), np.asarray(jbank_mel.background),
        jbank_mel.labels, device="cpu",
    )


def _mel_cfgs(**detect_kw):
    jcfg, tcfg = _cfgs(1, **detect_kw)
    return (JC.override(jcfg, frontend=JC.FrontendConfig(use_mel=True)),
            TC.override(tcfg, frontend=TC.FrontendConfig(use_mel=True)))


@pytest.mark.parametrize("detect_kw", [{}, {"dtw_rescore": True}],
                         ids=["scan", "dtw"])
def test_mel_scan_matches_reference(synth, jbank_mel, tbank_mel, detect_kw):
    """The log-mel scan (the layered frontend) with a JAX-trained mel
    bank: identical detections (times and template ids), scores at rtol
    1e-5, with and without DTW rescoring."""
    assert tbank_mel.templates.shape[2] == 63
    jcfg, tcfg = _mel_cfgs(**detect_kw)
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank_mel, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank_mel, tcfg, "aa")
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-6)
    assert got.counters["frames"] == want.counters["frames"]


@pytest.mark.parametrize("dtw", [False, True])
def test_mel_scan_int8_spectra_matches_reference(synth, jbank_mel, tbank_mel, dtw):
    """int8 spectra on the log-mel scan (D = 504): the int8 class of
    ``test_scan_int8_spectra_matches_reference``."""
    jcfg, tcfg = _mel_cfgs(dtw_rescore=dtw, int8_spectra=True)
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank_mel, jcfg, "aa")
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank_mel, tcfg, "aa")
    n = max(len(got.detections.scores), len(want.detections.scores))
    n_match, n_same, pairs = _matched(got, want)
    assert n > 0 and n_match >= 0.99 * n and n_same >= 0.99 * n_match
    if dtw:
        np.testing.assert_allclose(pairs[:, 0], pairs[:, 1], rtol=1e-5, atol=1e-6)
    else:
        top = np.max(np.abs(pairs[:, 1]))
        np.testing.assert_allclose(pairs[:, 0], pairs[:, 1], rtol=0, atol=1e-2 * top)


def test_mel_bank_scores_match_reference(jbank_mel, tbank_mel):
    """The mel bank carried across scores a random D = 504 map as the
    reference scores it (f32 FFT scorer, rtol 1e-4 of max|score|)."""
    from template_speech_recognition_tpu.detect import fft_scorer as jfs
    from template_speech_recognition_tpu.ops import layout as jlayout
    from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
    from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat

    rng = np.random.default_rng(12)
    feats = rng.random((2, 300, 504)) < 0.2
    jw, jc = jbank_mel.llr()
    jb = jfs.build_fft_bank(jlayout.filters_to_flat(jw), jc, mm_dtype=jnp.float32)
    want = np.asarray(jfs.fft_sliding_scores(jnp.asarray(feats, jnp.float32), jb,
                                             use_pallas=False))
    tw, tc = tbank_mel.llr()
    tb = tfs.build_fft_bank(filters_to_flat(tw), tc, mm_dtype=torch.float32)
    got = tfs.fft_sliding_scores(torch.from_numpy(feats), tb).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.max(np.abs(want)))


def test_cli_detect_mel_config(tmp_path, capsys, jbank_mel):
    """``--config`` (a JSON PipelineConfig file, as in the reference's
    CLI) switches the scan to log-mel features."""
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = str(tmp_path / "bank.npz")
    jbank_mel.save(bank_path)
    cfg_path = tmp_path / "mel.json"
    cfg_path.write_text(json.dumps({"frontend": {"use_mel": True}}))
    out = str(tmp_path / "dets.npz")
    assert main(["detect", "--bank", bank_path, "--phone", "aa", "--config",
                 str(cfg_path), "--dtw-rescore", "--device", "cpu", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    z = np.load(out)
    assert len(z["scores"]) == line["num_detections"] > 0
    assert np.all(np.isfinite(z["scores"]))


# ---- manifest resume and PCM16 upload ----------------------------------

def _same_detections(got, want):
    """Bitwise equal detection sets."""
    assert got.utt_ids == want.utt_ids
    for name in ("scores", "times", "template_ids", "utterance_ids"):
        np.testing.assert_array_equal(getattr(got.detections, name),
                                      getattr(want.detections, name))


def _close_to_reference(got, want):
    """The stream class: times and template ids identical, scores at
    rtol 1e-5."""
    assert got.utt_ids == want.utt_ids
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5)


def _faulty(module, real, monkeypatch, after=None):
    """Make ``module.scan_step`` call ``real``, counting the calls, and
    raise on the call after ``after`` of them (never with ``after=None``)."""
    calls = {"n": 0}

    def step(*a, **k):
        calls["n"] += 1
        if after is not None and calls["n"] > after:
            raise RuntimeError("injected fault")
        return real(*a, **k)

    monkeypatch.setattr(module, "scan_step", step)
    return calls


@pytest.mark.parametrize("group", ["1", "3", "8"])
def test_manifest_kill_and_resume_is_bitwise(synth, tbank, tmp_path, monkeypatch, group):
    """Batch 2 over the 7 utterances: shards 0-2 of the 1 s bucket and
    the 2 s tail (shard 3).  A scan that fails on its third batch leaves
    exactly shards 0 and 1 in the manifest (fetched after the fault when
    they still sat in an open group or an unread fetch); the resumed
    scan computes only shards 2 and 3, and its detections are bitwise a
    clean scan's, at ``SCAN_FETCH_GROUP`` 1, 3 and 8."""
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest

    monkeypatch.setenv("SCAN_FETCH_GROUP", group)
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2))
    clean = tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa")
    assert clean.counters["batches"] == 4
    mdir = str(tmp_path / "m")
    real = tscan.scan_step
    calls = _faulty(tscan, real, monkeypatch, after=2)
    with pytest.raises(RuntimeError, match="injected fault"):
        tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa",
                                   manifest=ScanManifest(mdir))
    assert ScanManifest(mdir).completed() == {0, 1}
    assert sorted(os.listdir(mdir)) == ["manifest.json", "shard_00000.npz",
                                        "shard_00001.npz"]
    calls = _faulty(tscan, real, monkeypatch)
    resumed = tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa",
                                         manifest=ScanManifest(mdir))
    assert calls["n"] == 2
    assert resumed.counters["batches"] == 2 and resumed.counters["shards_loaded"] == 2
    assert ScanManifest(mdir).completed() == {0, 1, 2, 3}
    _same_detections(resumed, clean)
    for key in ("utterances", "frames", "windows_scored", "detections", "audio_seconds"):
        assert resumed.counters[key] == clean.counters[key]
    shard = ScanManifest(mdir).load_shard(3)
    assert list(shard["gidx"]) == [3] and list(shard["ns"]) == [len(synth.utterances[3].waveform)]
    assert shard["s"].dtype == np.float32 and shard["t"].dtype == shard["k"].dtype == np.int32


def test_manifest_crosses_packages(synth, jbank, tbank, tmp_path, monkeypatch):
    """A manifest the reference's stream wrote, killed after two batches,
    resumes in the port (times and ids identical to the reference's clean
    scan, scores at rtol 1e-5); a complete one resumes with no
    ``scan_step`` call at all.  And a complete manifest of the port
    resumes in the reference with no step of its own."""
    from template_speech_recognition_tpu import scan as jscan
    from template_speech_recognition_tpu.checkpoint import ScanManifest as JManifest
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest

    monkeypatch.setenv("SCAN_FETCH_GROUP", "1")
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=2))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2))
    want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa")
    partial = str(tmp_path / "partial")
    jreal = jscan.scan_step
    _faulty(jscan, jreal, monkeypatch, after=2)
    with pytest.raises(RuntimeError, match="injected fault"):
        jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa",
                                 manifest=JManifest(partial))
    monkeypatch.setattr(jscan, "scan_step", jreal)
    assert ScanManifest(partial).completed() == {0, 1}
    calls = _faulty(tscan, tscan.scan_step, monkeypatch)
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank, tcfg, "aa",
                                     manifest=ScanManifest(partial))
    assert calls["n"] == 2
    _close_to_reference(got, want)
    full = str(tmp_path / "full")
    jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa",
                             manifest=JManifest(full))
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank, tcfg, "aa",
                                     manifest=ScanManifest(full))
    assert calls["n"] == 2 and got.counters["batches"] == 0
    _same_detections(got, want)
    ours = str(tmp_path / "ours")
    clean = tscan.detect_corpus_stream(TAdapter(synth), tbank, tcfg, "aa",
                                       manifest=ScanManifest(ours))
    jcalls = _faulty(jscan, jreal, monkeypatch)
    back = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa",
                                    manifest=JManifest(ours))
    assert jcalls["n"] == 0
    _same_detections(back, clean)


def test_manifest_rejects_changed_corpus(synth, tbank, tmp_path):
    """A manifest of another corpus (fewer utterances: a shard covers
    other utterances or lengths) raises the reference's ValueError."""
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest

    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2))
    mdir = str(tmp_path / "m")
    tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa", manifest=ScanManifest(mdir))
    shorter = O.make_synthetic_corpus(num_utterances=3, phones_per_utterance=5, seed=3)
    with pytest.raises(ValueError, match="corpus or config changed"):
        tscan.detect_corpus_stream(TAdapter(shorter), tbank, cfg, "aa",
                                   manifest=ScanManifest(mdir))


def _pcm16_corpus(base):
    """``base`` with every waveform snapped to the PCM16 grid."""
    utts = [type(u)(np.clip(np.round(u.waveform * 32768.0), -32768, 32767)
                    .astype(np.int16).astype(np.float32) / 32768.0, u.phones, u.utt_id)
            for u in base.utterances]
    return type(base)(utts, base.sample_rate, base.phone_names)


def test_pcm16_upload_is_bitwise_and_matches_reference(synth, jbank, tbank, monkeypatch):
    """``SCAN_UPLOAD_INT16=1``: the int16 upload of a PCM16-quantized
    corpus, and of the float corpus it was quantized from, is bitwise the
    float upload of the quantized corpus, down to the waveforms the
    frontend sees; against the reference's int16 scan, the stream
    class."""
    pcm = _pcm16_corpus(synth)
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2))
    seen = []
    real_step, real_fe = tscan.scan_step, tscan.frontend_batch_flat
    monkeypatch.setattr(tscan, "frontend_batch_flat",
                        lambda wavs, *a, **k: seen.append(wavs) or real_fe(wavs, *a, **k))
    want = tscan.detect_corpus_stream(TAdapter(pcm), tbank, cfg, "aa")
    floats, seen[:] = list(seen), []
    monkeypatch.setenv("SCAN_UPLOAD_INT16", "1")
    dtypes = []
    monkeypatch.setattr(tscan, "scan_step",
                        lambda wavs, *a, **k: dtypes.append(wavs.dtype) or real_step(wavs, *a, **k))
    got = tscan.detect_corpus_stream(TAdapter(pcm), tbank, cfg, "aa")
    assert dtypes == [torch.int16] * 4
    assert len(seen) == len(floats) == 4
    for a, b in zip(seen, floats):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _same_detections(got, want)
    _same_detections(tscan.detect_corpus_stream(TAdapter(synth), tbank, cfg, "aa"), want)
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=2))
    jwant = jax_detect_corpus_stream(SyntheticAdapter(pcm), jbank, jcfg, "aa")
    _close_to_reference(got, jwant)


@pytest.fixture(scope="module")
def jref3(synth, jbank):
    """The reference stream at batch 3 over the 7 utterances (three
    batches, the last a tail), its fetch knobs at their defaults."""
    env = {k: os.environ.pop(k) for k in ("SCAN_PIPELINE_DEPTH", "SCAN_FETCH_GROUP")
           if k in os.environ}
    try:
        jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3))
        return jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa")
    finally:
        os.environ.update(env)


@pytest.mark.parametrize("knob,value,fetches", [
    ("SCAN_PIPELINE_DEPTH", "1", 1), ("SCAN_PIPELINE_DEPTH", "2", 1),
    ("SCAN_PIPELINE_DEPTH", "0", 1),
    ("SCAN_FETCH_GROUP", "1", 3), ("SCAN_FETCH_GROUP", "2", 2),
    ("SCAN_FETCH_GROUP", "3", 1), ("SCAN_FETCH_GROUP", "8", 1),
])
def test_scan_fetch_knobs_keep_the_reference_detections(synth, jbank, tbank, jref3,
                                                        monkeypatch, knob, value, fetches):
    """The reference's fetch knobs, read with its meaning: each setting
    leaves the detections equal to the reference stream's (times and
    template ids identical, scores at rtol 1e-5), and to the port's own
    under the same setting of the reference; ``SCAN_FETCH_GROUP`` sets
    how many batches one fetch carries (three batches: 3 fetches at 1, 2
    at 2, one from 3 up; the default is 8), ``SCAN_PIPELINE_DEPTH`` how
    many fetches stay in flight (0 reads as 1, as in the reference)."""
    monkeypatch.setenv(knob, value)
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3))
    got = tscan.detect_corpus_stream(TAdapter(synth), tbank, tcfg, "aa")
    assert got.counters["batches"] == 3
    assert got.counters["fetches"] == fetches
    assert len(got.detections.scores) == len(jref3.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(jref3)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5)
    if knob == "SCAN_FETCH_GROUP" and value == "2":
        jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3))
        want = jax_detect_corpus_stream(SyntheticAdapter(synth), jbank, jcfg, "aa")
        for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
            np.testing.assert_array_equal(tg, tw)
            np.testing.assert_array_equal(kg, kw)
            np.testing.assert_allclose(sg, sw, rtol=1e-5)


def test_scan_fetch_group_is_bitwise_and_mixes_top_k(synth, tbank, monkeypatch):
    """Packing batches of different top-K (two buckets: 3 s and 6 s
    utterances) and sizes (a tail of 1) into one fetch is lossless: the
    detections are bitwise those of per-batch fetching."""
    adapter = TAdapter(synth)

    class Mixed:
        sample_rate = adapter.sample_rate

        def iter_utterances(self):
            for i, (uid, wav, ph) in enumerate(adapter.iter_utterances()):
                yield uid, (np.concatenate([wav, wav]) if i % 2 else wav), ph

    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2, top_k=2,
                                                    top_k_per_second=4.0))
    assert {tcfg.detect.effective_top_k(p, adapter.sample_rate)
            for p in (16384, 32768, 49152)} == {5, 9, 13}
    runs = {}
    for group in ("1", "8"):
        monkeypatch.setenv("SCAN_FETCH_GROUP", group)
        runs[group] = tscan.detect_corpus_stream(Mixed(), tbank, tcfg, "aa")
    a, b = runs["1"].detections, runs["8"].detections
    assert runs["1"].counters["fetches"] == runs["1"].counters["batches"] >= 4
    assert runs["8"].counters["fetches"] == 1
    assert len(a.scores) > 0
    for name in ("scores", "times", "template_ids", "utterance_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_refusals_name_a_roadmap_item():
    """No ``NotImplementedError`` of the port refuses unported work: the
    modules of ROADMAP Queue 1 are all ported, so none is left to cite
    an item ("Queue 1, item N, 'title'").  The four refusals of
    ``io/audio.py`` are the reference's own refusals of codings its
    readers do not read (sample widths, compressed SPHERE), not
    unported work, and cite nothing."""
    cites = []
    n_raise = 0
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, PKG)):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                src = f.read()
            n = len(re.findall(r"raise NotImplementedError\(", src))
            if os.path.relpath(path, os.path.join(REPO, PKG)) == os.path.join("io", "audio.py"):
                # the coding refusals: read_wav's width, read_sphere's
                # coding and width, read_audio_info's coding
                assert n == 4 and "ROADMAP" not in src
                continue
            n_raise += n
            cites += re.findall(r"ROADMAP\.md Queue 1, item (\d+), '([^']+)'",
                                re.sub(r'"\s*\n\s*f?"', "", src))
    # every module of Queue 1 is ported (item 7, parallel/, the last):
    # no refusal of unported work is left, so none cites an item
    assert n_raise == 0 and cites == [], (cites, n_raise)
    with open(os.path.join(REPO, PKG, "cli.py")) as f:
        assert not re.search(r"item (6|8|9|12)\b", f.read())


def test_config_json_round_trip():
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=5, top_k=9))
    assert TC.from_json(TC.to_json(cfg)) == cfg
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=5, top_k=9))
    assert TC.from_json(JC.to_json(jcfg)) == cfg


# the port's scripts at the repo root, held to the package's import rules
# (bench_cuda.py takes its corpus, bank and scan loop from chip_smoke.py;
# chip_smoke.py runs verify_cuda.py's checks and the two soaks, which
# share card_checks.py's checks with it)
PORT_SCRIPTS = ("bench_cuda", "chip_smoke", "card_checks", "verify_cuda", "soak_cuda",
                "soak_bank10k_cuda")


def _port_modules():
    root = os.path.join(REPO, PKG)
    mods = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)
                mods.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_port_modules() + list(PORT_SCRIPTS)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'template_speech_recognition_tpu'"
        " or m.startswith('template_speech_recognition_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|template_speech_recognition_tpu)(\.|\s|$)",
        re.M,
    )
    root = os.path.join(REPO, PKG)
    hits = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    hits += [(name, m.group(0)) for m in pat.finditer(f.read())]
    for script in PORT_SCRIPTS:
        with open(os.path.join(REPO, script + ".py")) as f:
            hits += [(script, m.group(0)) for m in pat.finditer(f.read())]
    assert not hits, hits


def test_cli_detect(tmp_path, capsys, jbank):
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = str(tmp_path / "bank.npz")
    jbank.save(bank_path)
    out = str(tmp_path / "dets.npz")
    assert main(["detect", "--bank", bank_path, "--phone", "aa",
                 "--device", "cpu", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"num_detections", "audio_seconds", "audio_s_per_s", "out"}
    z = np.load(out)
    assert len(z["scores"]) == line["num_detections"] > 0
    assert np.all(np.isfinite(z["scores"]))


def test_cli_detect_dtw_int8(tmp_path, capsys, jbank4):
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = str(tmp_path / "bank.npz")
    jbank4.save(bank_path)
    out = str(tmp_path / "dets.npz")
    assert main(["detect", "--bank", bank_path, "--phone", "aa", "--dtw-rescore",
                 "--dtw-top-r", "0", "--int8-spectra", "--device", "cpu",
                 "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"num_detections", "audio_seconds", "audio_s_per_s", "out"}
    z = np.load(out)
    assert len(z["scores"]) == line["num_detections"] > 0
    assert np.all(np.isfinite(z["scores"]))
    assert set(z["template_ids"].tolist()) <= set(range(4))


def test_bank_load_and_llr_match_reference(tmp_path, jbank):
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank

    path = str(tmp_path / "bank.npz")
    jbank.save(path)
    bank = TemplateBank.load(path, device="cpu")
    assert bank.labels == jbank.labels
    assert (bank.num_templates, bank.template_length) == (
        jbank.num_templates, jbank.template_length)
    np.testing.assert_array_equal(bank.templates.numpy(), np.asarray(jbank.templates))
    (w, c), (jw, jc) = bank.llr(), jbank.llr()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
