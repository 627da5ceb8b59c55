"""The port's ``detect/classify.py`` and the CLI's ``classify`` against the
JAX reference, on the CPU: the sliding and DTW routes on segments longer
and shorter than the templates, the tie rule, the DTW kernel's schedule
at classification's shapes, and the CLI with plain and parts banks."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import oracle as O
from oracle.frontend import FrontendParams
from template_speech_recognition_tpu import checkpoint as jckpt
from template_speech_recognition_tpu import cli as jcli
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu import pipeline as jpipe
from template_speech_recognition_tpu.detect import classify as jcls
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.detect import classify as tcls
from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd

from test_classify_parts import _two_class_setup


@pytest.fixture(scope="module")
def banks():
    """The reference test's two-class bank (aa, iy; L 13) in both packages."""
    s, classes = _two_class_setup()
    jb = JBank.from_classes(classes, s["background"])
    tb = bank_from_numpy(np.asarray(jb.templates), np.asarray(jb.background), jb.labels,
                         device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def segments():
    """Exemplar maps of aa and iy from an 8-utterance corpus (the
    oracle's frontend) and three cut shorter than L = 13: 8, 1 and 12
    rows."""
    p = FrontendParams()
    corpus = O.make_synthetic_corpus(num_utterances=8, phones_per_utterance=5, seed=11)
    segs = [O.frontend(c, p).astype(np.float32) for ph in ("aa", "iy")
            for c in corpus.exemplar_clips(ph) if len(c) >= p.frame_length + 3 * p.hop_length]
    return segs + [segs[0][:8], segs[1][:1], segs[-1][:12]]


def _against_reference(batch, lens, jb, tb, **kw):
    """Identical predictions; per-class scores within 1e-5 x max|score|
    (-inf alike)."""
    jp, js = jcls.classify_segments(batch, lens, jb, **kw)
    tp, ts = tcls.classify_segments(batch, lens, tb, **kw)
    assert tp == jp
    assert ts.shape == js.shape == (len(lens), 2)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_array_equal(ts[~fin], js[~fin])
    top = np.abs(js[fin]).max()
    assert np.abs(ts[fin] - js[fin]).max() <= 1e-5 * top
    return tp, ts


@pytest.mark.parametrize("use_dtw,band", [(False, 6), (True, 4), (True, 6), (True, 1)],
                         ids=["sliding", "dtw-band4", "dtw-band6", "dtw-band1"])
def test_classify_matches_reference(banks, segments, use_dtw, band):
    """Segments longer and shorter than L (one of a single row) in one
    padded batch: the reference's predictions, its scores within 1e-5 x
    max|score|; both classes are predicted."""
    jb, tb = banks
    batch, lens = jcls.pad_segments(segments)
    assert lens.min() == 1 and (lens < jb.template_length).sum() >= 3
    assert batch.shape[1] > jb.template_length
    preds, _ = _against_reference(batch, lens, jb, tb, use_dtw=use_dtw, band=band)
    assert set(preds) == {"aa", "iy"}


def test_classify_dtw_shorter_than_every_template(banks, segments):
    """DTW where the whole batch is shorter than L (M_pad 11 < L 13, rows
    of 1): the reference's predictions and scores; on the sliding route
    the port scores such a batch by the registered product alone, where
    the reference's window max has no window to take (ROADMAP.md Queue 3,
    "classify, sliding, M_pad < L")."""
    jb, tb = banks
    short = [s[: jb.template_length - 2] for s in segments[:6]] + [segments[2][:1]]
    batch, lens = jcls.pad_segments(short)
    assert batch.shape[1] == jb.template_length - 2
    _against_reference(batch, lens, jb, tb, use_dtw=True, band=4)
    with pytest.raises(ValueError):
        jcls.classify_segments(batch, lens, jb)
    _tp, ts = tcls.classify_segments(batch, lens, tb)
    w, c = tb.llr()
    reg = tcls._register_to_length(torch.from_numpy(batch), torch.from_numpy(lens),
                                   jb.template_length)
    want = reg.reshape(len(lens), -1) @ w.reshape(2, -1).T + c
    np.testing.assert_allclose(ts, want.numpy(), rtol=1e-6, atol=1e-3)


def test_classify_ties_go_to_the_lower_class(segments):
    """Two classes with one template (aa's) between them: their scores tie
    on every segment, and the aa-like segments go to the lower class id,
    as in the reference; a third class (with iy's template) takes the
    others."""
    s, classes = _two_class_setup()
    tpl = classes["aa"]
    jb = JBank.from_classes({"iy": tpl, "aa": tpl, "uw": classes["iy"]},
                            s["background"])
    tb = bank_from_numpy(np.asarray(jb.templates), np.asarray(jb.background), jb.labels,
                         device="cpu")
    batch, lens = jcls.pad_segments(segments)
    for use_dtw in (False, True):
        jp, js = jcls.classify_segments(batch, lens, jb, use_dtw=use_dtw)
        tp, ts = tcls.classify_segments(batch, lens, tb, use_dtw=use_dtw)
        assert tp == jp
        np.testing.assert_array_equal(ts[:, 0], ts[:, 1])
        assert "iy" not in tp and {"aa", "uw"} <= set(tp)
    pred, per_class = tcls._per_class_best(torch.tensor([[1.0, 2.0, 2.0, -1.0]]),
                                           torch.tensor([2, 1, 0, 0]), 3)
    assert int(pred[0]) == 0 and per_class.tolist() == [[2.0, 2.0, 1.0]]


def test_pad_and_register_match_reference(segments):
    batch, lens = tcls.pad_segments(segments, pad_to=14)
    jbatch, jlens = jcls.pad_segments(segments, pad_to=14)
    np.testing.assert_array_equal(batch, jbatch)
    np.testing.assert_array_equal(lens, jlens)
    for length in (1, 5, 13, 30):
        got = tcls._register_to_length(torch.from_numpy(batch), torch.from_numpy(lens),
                                       length).numpy()
        for i in range(len(lens)):
            want = np.asarray(jcls._register_to_length(jbatch[i], np.int32(jlens[i]), length))
            np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("length,m_pad,band", [(13, 11, 4), (13, 15, 6), (13, 15, 0),
                                               (32, 20, 6), (32, 60, 100), (1, 9, 6)])
def test_dtw_kernel_schedule_at_classification_shapes(length, m_pad, band):
    """Classification hands the DTW kernel shapes no scan does: M_pad the
    longest segment (shorter than L or longer), the exhaustive GEMM's
    output read through its strides (so the ring path, no whole tiles),
    lengths from 1 to M_pad (and L, the one length band 0 admits).  The kernel's schedule (``banded_dtw_emulated``)
    is bitwise its plain version there, -inf alike for out-of-band pairs."""
    rng = np.random.default_rng(length * 100 + m_pad + band)
    nb, k, d = 7, 3, 24
    segs = torch.from_numpy((rng.random((nb, m_pad, d)) < 0.3).astype(np.float32))
    lens = torch.from_numpy(np.r_[1, m_pad, min(length, m_pad),
                                  rng.integers(1, m_pad + 1, nb - 3)].astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(k, length, d)).astype(np.float32))
    c_rows = torch.from_numpy(rng.normal(size=(k, length)).astype(np.float32))
    llr = (segs.reshape(nb * m_pad, d) @ w.reshape(k * length, d).T).reshape(
        nb, m_pad, k, length).permute(0, 2, 3, 1)
    assert not kd.whole_tile(llr, band)
    want = kd.banded_dtw_scores_plain(llr, lens, c_rows, band)
    got = kd.banded_dtw_emulated(llr, lens, band, c_tab=c_rows)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if band == 0 and length > 1:
        assert bool(torch.isneginf(want).any())
    assert bool(torch.isfinite(want).any())


# ---- the CLI's classify ------------------------------------------------

@pytest.fixture(scope="module")
def cli_banks(tmp_path_factory):
    """A plain and a parts-coded reference bank, trained on a 5-utterance
    corpus, each as the port's ``.npz`` and the reference's orbax
    directory."""
    root = tmp_path_factory.mktemp("classify")
    corpus = jpipe.SyntheticAdapter(O.make_synthetic_corpus(5, 5, seed=3))
    out = {}
    for name, cfg in (("plain", JC.PipelineConfig(template=JC.TemplateConfig(
                          num_components=2))),
                      ("parts", JC.PipelineConfig(parts=JC.PartsConfig(enabled=True,
                                                                      num_parts=4)))):
        bank = jpipe.train_bank(corpus, ["aa", "iy"], cfg)
        npz, odir = str(root / f"{name}.npz"), str(root / f"{name}_orbax")
        bank.save(npz)
        jckpt.save_bank(odir, bank)
        out[name] = (npz, odir)
    return out


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", [1, 3])
@pytest.mark.parametrize("dtw", [False, True], ids=["sliding", "dtw"])
@pytest.mark.parametrize("kind", ["plain", "parts"])
def test_cli_classify_matches_reference(cli_banks, capsys, kind, dtw, seed):
    """``classify`` on ``synthetic`` with ``--device cpu``: the reference's
    ``cmd_classify`` line (segments, classes, accuracy) on the same bank
    arrays; a parts bank skips the segments its coding leaves no row."""
    from template_speech_recognition_tpu_torch.cli import main

    npz, odir = cli_banks[kind]
    flags = ["--dtw"] if dtw else []
    assert main(["classify", "--bank", npz, "--device", "cpu", "--seed", str(seed),
                 *flags]) == 0
    got = _line(capsys)
    args = jcli.build_parser().parse_args(["classify", "--bank", odir, "--seed", str(seed),
                                           *flags])
    assert jcli.cmd_classify(args) == 0
    want = _line(capsys)
    assert got == want
    assert got["num_segments"] > 0 and got["classes"] == ["aa", "iy"] and got["dtw"] == dtw


def test_clip_maps_keep_their_indices():
    """``pipeline._clip_maps_kept`` names the clips its maps come from:
    clips shorter than one frame are dropped, the rest keep their order,
    so ``classify``'s labels stay with their maps."""
    from template_speech_recognition_tpu_torch import config as TC
    from template_speech_recognition_tpu_torch import pipeline as tpipe

    corpus = O.make_synthetic_corpus(6, 5, seed=2)
    long = [c for ph in ("aa", "iy") for c in corpus.exemplar_clips(ph)][:3]
    assert len(long) == 3
    fcfg = TC.FrontendConfig()
    tiny = np.zeros(fcfg.frame_length + fcfg.hop_length - 1, np.float32)
    clips = [long[0], tiny, long[1], tiny[:5], long[2]]
    cfg = TC.PipelineConfig()
    stack, lengths, kept = tpipe._clip_maps_kept(clips, cfg, "cpu", batch=2)
    np.testing.assert_array_equal(kept, [0, 2, 4])
    want, want_len = tpipe._clip_feature_maps(long, cfg, "cpu", batch=2)
    np.testing.assert_array_equal(lengths, want_len)
    assert torch.equal(stack, want)
