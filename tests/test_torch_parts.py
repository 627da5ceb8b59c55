"""The port's parts coding (``models/parts.py``) and the per-utterance
loop's parts branch against the JAX reference and the NumPy oracle, on
the CPU, in the classes the reference holds itself to
(``tests/test_classify_parts.py``): log-likelihoods allclose, indicator
maps apart on under 1e-3 of locations, dictionaries within 1e-3."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import oracle as O
from oracle.parts import code_parts as o_code_parts, learn_parts as o_learn_parts
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu import pipeline as jpipe
from template_speech_recognition_tpu.models import parts as jparts
from template_speech_recognition_tpu.pipeline import SyntheticAdapter
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import pipeline as tpipe
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.models import parts as tparts

from helpers import small_setup


@pytest.fixture(scope="module")
def fmaps():
    return [f for f in small_setup(0)["feats"] if f.shape[0] >= 10]


@pytest.fixture(scope="module")
def dictionary(fmaps):
    return o_learn_parts(fmaps, num_parts=4, patch_time=3, patch_freq=3, num_patches=64,
                         seed=5, num_iters=5)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (1, 3)])
def test_part_logliks_and_codes_match_reference(fmaps, dictionary, stride):
    st, sf = stride
    fm = fmaps[0]
    got = tparts.part_logliks(torch.from_numpy(fm), torch.from_numpy(dictionary), st, sf)
    want = np.asarray(jparts.part_logliks(jnp.asarray(fm), jnp.asarray(dictionary), st, sf))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    codes = tparts.code_parts(torch.from_numpy(fm), torch.from_numpy(dictionary),
                              stride_time=st, stride_freq=sf).numpy()
    jcodes = np.asarray(jparts.code_parts(jnp.asarray(fm), jnp.asarray(dictionary),
                                          stride_time=st, stride_freq=sf))
    ocodes = o_code_parts(fm, dictionary, stride_time=st, stride_freq=sf)
    assert codes.dtype == bool and codes.shape == jcodes.shape == ocodes.shape
    assert np.all(codes.sum(-1) == 1)
    assert np.mean(codes != jcodes) < 1e-3
    assert np.mean(codes != ocodes) < 1e-3


def test_code_parts_gate_and_batch(fmaps, dictionary, monkeypatch):
    """The log-likelihood gate (strided), and ``code_parts_batch`` over a
    padded batch: equal rows coded alike, each row within 1e-3 of
    ``code_parts`` and of the reference's batch, whatever the chunking
    (separate convolutions need not round alike, so codes of separate
    calls are held to the mismatch class)."""
    fm = torch.from_numpy(fmaps[0][:10])
    parts = torch.from_numpy(dictionary)
    ll = tparts.part_logliks(fm, parts, 2, 2)
    thr = float(ll.amax(dim=-1).median())
    gated = tparts.code_parts(fm, parts, thr, 2, 2)
    np.testing.assert_array_equal(gated.any(dim=-1).numpy(), (ll.amax(dim=-1) >= thr).numpy())
    jgated = np.asarray(jparts.code_parts(jnp.asarray(fm.numpy()), jnp.asarray(dictionary),
                                          thr, 2, 2))
    assert np.mean(gated.numpy() != jgated) < 1e-3
    batch = torch.stack([fm, torch.flip(fm, dims=[0]), fm])
    got = tparts.code_parts_batch(batch, parts, thr, 2, 2)
    assert torch.equal(got[0], got[2])
    assert np.mean((got[0] != gated).numpy()) < 1e-3
    assert np.mean((got[1] != tparts.code_parts(batch[1], parts, thr, 2, 2)).numpy()) < 1e-3
    want = np.asarray(jparts.code_parts_batch(jnp.asarray(batch.numpy()),
                                              jnp.asarray(dictionary), thr, 2, 2))
    assert np.mean(got.numpy() != want) < 1e-3
    monkeypatch.setattr(tparts, "CODE_CHUNK", 2)
    chunked = tparts.code_parts_batch(batch, parts, thr, 2, 2)
    assert chunked.shape == got.shape and np.mean((chunked != got).numpy()) < 1e-3


def test_learn_parts_matches_reference(fmaps):
    got = tparts.learn_parts(fmaps, num_parts=3, patch_time=3, patch_freq=3,
                             num_patches=48, seed=2, num_iters=6, device="cpu")
    want = np.asarray(jparts.learn_parts(fmaps, num_parts=3, patch_time=3, patch_freq=3,
                                         num_patches=48, seed=2, num_iters=6))
    orc = o_learn_parts(fmaps, num_parts=3, patch_time=3, patch_freq=3, num_patches=48,
                        seed=2, num_iters=6)
    assert tuple(got.shape) == want.shape == (3, 3, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), orc, rtol=1e-3, atol=1e-3)


# ---- the loop's parts branch --------------------------------------------

@pytest.fixture(scope="module")
def synth():
    return O.make_synthetic_corpus(num_utterances=5, phones_per_utterance=5, seed=3)


@pytest.fixture(scope="module")
def parts_banks(synth):
    """A parts bank trained by the reference (8 parts), and the same
    arrays carried across."""
    cfg = JC.PipelineConfig(parts=JC.PartsConfig(enabled=True, num_parts=8))
    jb = jpipe.train_bank(SyntheticAdapter(synth), ["aa", "iy"], cfg)
    tb = bank_from_numpy(np.asarray(jb.templates), np.asarray(jb.background), jb.labels,
                         device="cpu", parts=np.asarray(jb.parts))
    return jb, tb


def test_router_sends_a_parts_bank_to_the_loop(synth, parts_banks, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a parts bank reached the streaming scan")

    monkeypatch.setattr(tpipe, "detect_corpus_stream", refuse)
    _jb, tb = parts_banks
    cfg = TC.PipelineConfig(parts=TC.PartsConfig(enabled=True, num_parts=8))
    res = tpipe.detect_corpus(TAdapter(synth), tb, cfg, "aa")
    assert "batches" not in res.counters
    assert len(res.detections.scores) > 0


@pytest.mark.parametrize("detect_kw", [{}, {"exact_scores": True}, {"dtw_rescore": True}],
                         ids=["fft-default", "exact", "dtw"])
def test_parts_loop_matches_reference_loop(synth, parts_banks, detect_kw):
    """The loop on a parts bank: the reference's detections (utterance,
    time, template) on the same bank; scores within 1e-5 (bitwise on
    the exact path); the valid windows and counters alike."""
    jb, tb = parts_banks
    pk = dict(enabled=True, num_parts=8)
    jcfg = JC.PipelineConfig(parts=JC.PartsConfig(**pk), detect=JC.DetectConfig(**detect_kw))
    tcfg = TC.PipelineConfig(parts=TC.PartsConfig(**pk), detect=TC.DetectConfig(**detect_kw))
    want = jpipe.detect_corpus(SyntheticAdapter(synth), jb, jcfg, "aa")
    got = tpipe.detect_corpus(TAdapter(synth), tb, tcfg, "aa")
    wd, gd = want.detections, got.detections
    assert len(gd.scores) == len(wd.scores) > 0
    for ui in range(len(got.utt_ids)):
        a, b = gd.utterance_ids == ui, wd.utterance_ids == ui
        oa = np.lexsort((gd.template_ids[a], gd.times[a]))
        ob = np.lexsort((wd.template_ids[b], wd.times[b]))
        np.testing.assert_array_equal(gd.times[a][oa], wd.times[b][ob])
        np.testing.assert_array_equal(gd.template_ids[a][oa], wd.template_ids[b][ob])
        sa, sb = gd.scores[a][oa], wd.scores[b][ob]
        if detect_kw.get("exact_scores"):
            np.testing.assert_array_equal(sa.astype(np.float32), sb.astype(np.float32))
        else:
            np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-5)
    for key in ("utterances", "frames", "windows_scored", "detections"):
        assert got.counters[key] == want.counters[key]
