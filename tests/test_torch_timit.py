"""TIMIT input end to end in the port against the JAX reference, on the
CPU, over a synthetic TIMIT tree the reference's ``write_synthetic_timit``
writes (9 utterances: 5 TRAIN, 4 TEST, WAV and SPHERE alternating):
``TimitAdapter``, ``train_bank`` on the TRAIN split, the stream and the
exact loop on the TEST split, the PCM16 upload, and the CLI's
``--corpus timit:<root>`` from ``train`` to ``classify``.  Classes: the
adapter's samples, phones and clips bitwise; banks within the reference's
training class (``tests/test_torch_train.py``); detections as
``tests/test_torch_scan.py`` and ``tests/test_torch_pipeline.py`` hold
them; the PCM16 upload bitwise the float upload."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

from template_speech_recognition_tpu import checkpoint as jckpt
from template_speech_recognition_tpu import cli as jcli
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu import pipeline as jpipe
from template_speech_recognition_tpu.io import corpus as jcorpus
from template_speech_recognition_tpu.io import fixtures as jfixtures
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu.scan import (
    detect_corpus_stream as jax_detect_corpus_stream,
)
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import pipeline as tpipe
from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import TimitAdapter
from template_speech_recognition_tpu_torch.io import corpus as tcorpus

PHONES = ["aa", "iy"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("timit"))
    jfixtures.write_synthetic_timit(root, num_train=5, num_test=4, phones_per_utterance=6,
                                    seed=3)
    return root


def _adapters(root, split=None):
    return (TimitAdapter(tcorpus.TimitCorpus(root), split),
            jpipe.TimitAdapter(jcorpus.TimitCorpus(root), split))


# ---- the adapter ---------------------------------------------------------

@pytest.mark.parametrize("split", [None, "TRAIN", "TEST"])
def test_adapter_iterations_match_reference(tree, split):
    t, j = _adapters(tree, split)
    got, want = list(t.iter_utterances()), list(j.iter_utterances())
    assert len(got) == len(want) == {None: 9, "TRAIN": 5, "TEST": 4}[split]
    for (ut, wt, pt), (uj, wj, pj) in zip(got, want):
        assert ut == uj and pt == pj and wt.dtype == wj.dtype == np.float32
        np.testing.assert_array_equal(wt, wj)
    infos_t, infos_j = list(t.iter_utterance_infos()), list(j.iter_utterance_infos())
    assert infos_t == infos_j
    assert [n for _u, n, _p in infos_t] == [len(w) for _u, w, _p in got]
    for gidx, (_u, w, _p) in enumerate(got):
        np.testing.assert_array_equal(t.get_waveform(gidx), w)
        np.testing.assert_array_equal(t.get_waveform(gidx), j.get_waveform(gidx))


@pytest.mark.parametrize("split", [None, "TRAIN"])
def test_adapter_clips_match_reference(tree, split):
    t, j = _adapters(tree, split)
    for phone in PHONES + ["sil"]:
        for name in ("exemplar_clips", "background_clips"):
            ct, cj = getattr(t, name)(phone), getattr(j, name)(phone)
            assert len(ct) == len(cj) > 0
            for a, b in zip(ct, cj):
                np.testing.assert_array_equal(a, b)


def test_adapter_sample_rate_follows_the_corpus(tmp_path):
    """``sample_rate`` starts at 16000 and takes each decoded or probed
    utterance's rate while iterating, as the reference's does."""
    root = str(tmp_path / "t8k")
    jfixtures.write_synthetic_timit(root, num_train=2, num_test=1, phones_per_utterance=3,
                                    seed=1, sample_rate=8000)
    for it in ("iter_utterances", "iter_utterance_infos"):
        t, j = _adapters(root)
        assert t.sample_rate == j.sample_rate == 16000
        first = next(getattr(t, it)())
        next(getattr(j, it)())
        assert t.sample_rate == j.sample_rate == 8000 and first[0] == "TEST/DR1/SPK2/SYNTH_0002"


# ---- training on the TRAIN split ------------------------------------------

CASES = {"template": {}, "mixture": dict(num_components=2)}


@pytest.fixture(scope="module")
def trained(tree):
    out = {}
    for name, tkw in CASES.items():
        jb = jpipe.train_bank(_adapters(tree, "TRAIN")[1], PHONES,
                              JC.PipelineConfig(template=JC.TemplateConfig(**tkw)))
        tb = tpipe.train_bank(_adapters(tree, "TRAIN")[0], PHONES,
                              TC.PipelineConfig(template=TC.TemplateConfig(**tkw)),
                              device="cpu")
        out[name] = (jb, tb)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_bank_on_timit_matches_reference(trained, case):
    jb, tb = trained[case]
    assert tb.labels == jb.labels
    assert tuple(tb.templates.shape) == np.asarray(jb.templates).shape
    assert tb.num_templates == (4 if case == "mixture" else 2)
    np.testing.assert_allclose(tb.templates.numpy(), np.asarray(jb.templates), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.background.numpy(), np.asarray(jb.background), rtol=1e-6,
                               atol=1e-6)


# ---- detection on the TEST split -------------------------------------------

def _per_utt(result):
    d = result.detections
    out = []
    for ui in range(len(result.utt_ids)):
        sel = d.utterance_ids == ui
        order = np.lexsort((d.template_ids[sel], d.times[sel]))
        out.append((d.scores[sel][order], d.times[sel][order], d.template_ids[sel][order]))
    return out


def _same_class(got, want, exact):
    """Identical detections; scores bitwise on the exact path, else at
    rtol 1e-5; the labels, audio seconds and counters equal."""
    assert got.utt_ids == want.utt_ids
    assert len(got.detections.scores) == len(want.detections.scores) > 0
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(want)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        if exact:
            np.testing.assert_array_equal(sg.astype(np.float32), sw.astype(np.float32))
        else:
            np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-6)
    for lg, lw in zip(got.labels_per_utterance, want.labels_per_utterance):
        np.testing.assert_array_equal(lg, lw)
    assert got.audio_seconds == want.audio_seconds
    for key in ("utterances", "frames", "windows_scored", "detections"):
        assert got.counters[key] == want.counters[key]


def _bank_pair(trained):
    jb = trained["mixture"][0]
    return jb, bank_from_numpy(np.asarray(jb.templates), np.asarray(jb.background),
                               jb.labels, device="cpu")


def test_stream_on_timit_matches_reference(tree, trained):
    """The default scan of the TEST split (batch 3: a full batch and a
    tail) with the reference's TRAIN bank."""
    jb, tb = _bank_pair(trained)
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(batch_size=3))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3))
    t, j = _adapters(tree, "TEST")
    got = tpipe.detect_corpus(t, tb, tcfg, "aa")
    want = jax_detect_corpus_stream(j, jb, jcfg, "aa")
    _same_class(got, want, exact=False)
    assert got.counters["batches"] >= 2


def test_exact_loop_on_timit_matches_reference(tree, trained):
    jb, tb = _bank_pair(trained)
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(exact_scores=True))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True))
    t, j = _adapters(tree, "TEST")
    _same_class(tpipe.detect_corpus(t, tb, tcfg, "iy"),
                jpipe.detect_corpus(j, jb, jcfg, "iy"), exact=True)


def test_pcm16_upload_of_timit_is_bitwise(tree, trained, monkeypatch):
    """TIMIT's samples are PCM16 values (int16 / 32768), so the int16
    upload gives the frontend the float upload's waveforms and the scan
    its detections, bit for bit."""
    _jb, tb = _bank_pair(trained)
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=2))
    seen, dtypes = [], []
    real_step, real_fe = tscan.scan_step, tscan.frontend_batch_flat
    monkeypatch.setattr(tscan, "frontend_batch_flat",
                        lambda wavs, *a, **k: seen.append(wavs) or real_fe(wavs, *a, **k))
    want = tscan.detect_corpus_stream(_adapters(tree, "TEST")[0], tb, cfg, "aa")
    floats, seen[:] = list(seen), []
    monkeypatch.setenv("SCAN_UPLOAD_INT16", "1")
    monkeypatch.setattr(tscan, "scan_step",
                        lambda wavs, *a, **k: dtypes.append(wavs.dtype) or real_step(wavs, *a, **k))
    got = tscan.detect_corpus_stream(_adapters(tree, "TEST")[0], tb, cfg, "aa")
    assert dtypes == [torch.int16] * len(floats) and len(floats) >= 2
    for a, b in zip(seen, floats):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for name in ("scores", "times", "template_ids", "utterance_ids"):
        np.testing.assert_array_equal(getattr(got.detections, name),
                                      getattr(want.detections, name))


# ---- the CLI ---------------------------------------------------------------

def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_timit_train_to_classify_matches_reference(tree, tmp_path, capsys):
    """``train`` -> ``detect`` -> ``evaluate`` -> ``classify [--dtw]`` with
    ``--corpus timit:<root> --device cpu``: each JSON line equals the
    reference CLI's on the same tree, but for the bank's path and format
    (the port's ``.npz``, the reference's orbax directory) and the scan's
    measured rate.  ``train`` is held to the reference's; the later
    steps scan the port's bank in both CLIs."""
    from template_speech_recognition_tpu_torch.cli import main

    spec = f"timit:{tree}"
    npz, odir = str(tmp_path / "bank.npz"), str(tmp_path / "bank_orbax")
    assert main(["train", "--corpus", spec, "--phones", "aa,iy", "--components", "2",
                 "--bank", npz, "--device", "cpu"]) == 0
    got = _line(capsys)
    args = jcli.build_parser().parse_args(["train", "--corpus", spec, "--phones", "aa,iy",
                                           "--components", "2", "--bank",
                                           str(tmp_path / "ref_orbax")])
    assert jcli.cmd_train(args) == 0
    want = _line(capsys)
    assert got.pop("bank") == npz and want.pop("bank") == str(tmp_path / "ref_orbax")
    assert got == want and got["num_templates"] == 4
    jckpt.save_bank(odir, JBank.load(npz))
    runs = (
        (["detect", "--phone", "aa"], {"out", "audio_s_per_s"}),
        (["evaluate", "--phone", "aa"], set()),
        (["evaluate", "--phone", "iy", "--exact"], set()),
        (["classify"], set()),
        (["classify", "--dtw"], set()),
    )
    for argv, differ in runs:
        assert main([argv[0], "--corpus", spec, "--bank", npz, "--device", "cpu",
                     *argv[1:]]) == 0
        got = _line(capsys)
        args = jcli.build_parser().parse_args([argv[0], "--corpus", spec, "--bank", odir,
                                               *argv[1:]])
        assert args.fn(args) == 0
        want = _line(capsys)
        assert set(got) == set(want), argv
        for key in set(got) - differ:
            assert got[key] == want[key], (argv, key, got, want)
        if argv[0] == "detect":
            assert got["num_detections"] > 0 and got["audio_seconds"] > 0
        if argv[0] == "classify":
            assert got["num_segments"] > 0 and got["classes"] == PHONES


def test_cli_refuses_an_unknown_corpus_spec():
    from template_speech_recognition_tpu_torch.cli import main

    with pytest.raises(SystemExit, match=r"synthetic \| timit:<root>"):
        main(["detect", "--corpus", "librispeech:/x", "--bank", "b.npz", "--phone", "aa",
              "--device", "cpu"])
