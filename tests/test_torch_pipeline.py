"""The port's ``pipeline.py`` (the ``detect_corpus`` router, the
per-utterance loop: exact int32, conv and pallas; ``evaluate_detections``)
and the CLI's ``--exact``, ``--score-backend`` and ``evaluate`` against
the JAX reference and the NumPy oracle, on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import oracle as O
from oracle.detect import bank_nms
from oracle.frontend import FrontendParams
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu import pipeline as jpipe
from template_speech_recognition_tpu.pipeline import SyntheticAdapter, train_bank
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import pipeline as tpipe
from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.detect import evaluate as tev
from template_speech_recognition_tpu_torch.scan import CorpusDetections, bucket_length


@pytest.fixture(scope="module")
def synth():
    return O.make_synthetic_corpus(num_utterances=5, phones_per_utterance=5, seed=3)


@pytest.fixture(scope="module")
def jbank4(synth):
    """Two classes x two mixture components: K = 4 templates."""
    cfg = JC.PipelineConfig(template=JC.TemplateConfig(num_components=2))
    return train_bank(SyntheticAdapter(synth), ["aa", "iy"], cfg)


@pytest.fixture(scope="module")
def tbank4(jbank4):
    return bank_from_numpy(np.asarray(jbank4.templates), np.asarray(jbank4.background),
                           jbank4.labels, device="cpu")


def _per_utt(result):
    d = result.detections
    out = []
    for ui in range(len(result.utt_ids)):
        sel = d.utterance_ids == ui
        order = np.lexsort((d.template_ids[sel], d.times[sel]))
        out.append((d.scores[sel][order], d.times[sel][order],
                    d.template_ids[sel][order]))
    return out


def _assert_same(got, want, exact):
    """Identical detections (utterance, time, template); scores bitwise
    on the exact path, else at rtol 1e-5 (f32 summation order)."""
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
    assert got.audio_seconds == pytest.approx(want.audio_seconds)
    for key in ("utterances", "frames", "windows_scored", "detections"):
        assert got.counters[key] == want.counters[key]


@pytest.mark.parametrize("detect_kw", [
    {"score_backend": "pallas"},
    {"exact_scores": True},
    {"exact_scores": True, "dtw_rescore": True},
    {"score_backend": "pallas", "dtw_rescore": True},
], ids=["pallas", "exact", "exact-dtw", "pallas-dtw"])
def test_detect_corpus_loop_matches_reference(synth, jbank4, tbank4, detect_kw):
    """The routes the reference sends through its per-utterance loop:
    ``pallas`` (scored by the f32 conv, as in the reference) and exact
    int32 scores, with and without DTW rescoring (verify-the-winner)."""
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(**detect_kw))
    tcfg = TC.PipelineConfig(detect=TC.DetectConfig(**detect_kw))
    want = jpipe.detect_corpus(SyntheticAdapter(synth), jbank4, jcfg, "aa")
    got = tpipe.detect_corpus(TAdapter(synth), tbank4, tcfg, "aa")
    exact = detect_kw.get("exact_scores", False) and not detect_kw.get("dtw_rescore")
    _assert_same(got, want, exact)


@pytest.fixture(scope="module")
def dtw_case(synth, jbank4, tbank4):
    """One utterance's flat map and its top-K peaks (f32 conv scores,
    NMS), with the reference bank's flat per-row filters: the inputs of
    the verify-the-winner rescore, as numpy arrays for both packages."""
    from template_speech_recognition_tpu.ops.layout import filters_to_flat as jflat
    from template_speech_recognition_tpu_torch.detect.nms import top_detections
    from template_speech_recognition_tpu_torch.detect.scorer import (
        masked_scores,
        sliding_scores,
    )
    from template_speech_recognition_tpu_torch.frontend import frontend_batch_flat
    from template_speech_recognition_tpu_torch.ops.layout import filters_to_flat

    cfg = TC.PipelineConfig()
    fcfg = cfg.frontend
    _uid, wav, _ph = next(iter(TAdapter(synth).iter_utterances()))
    pad = bucket_length(len(wav))
    buf = torch.zeros((1, pad), dtype=torch.float32)
    buf[0, : len(wav)] = torch.from_numpy(np.asarray(wav, np.float32))
    fm = frontend_batch_flat(buf, torch.tensor([len(wav)], dtype=torch.int32), fcfg)
    fmap = fm.binary[0, : fcfg.num_feature_frames(pad)]
    valid = fm.valid_frames[0]
    w, c = tbank4.llr()
    sc = masked_scores(sliding_scores(fmap, filters_to_flat(w), c), valid,
                       tbank4.template_length)
    s, t, k = top_detections(sc, cfg.detect.nms_radius,
                             cfg.detect.effective_top_k(pad, fcfg.sample_rate))
    jw, jc = jbank4.llr_rows()
    return dict(fmap=fmap.numpy().astype(np.float32), valid=int(valid), s=s.numpy(),
                t=t.numpy(), k=k.numpy(), w_rows=np.array(jflat(jnp.asarray(jw))),
                c_rows=np.array(jc), band=cfg.dtw.band,
                m_seg=tbank4.template_length + cfg.dtw.band)


def _reference_rescore(case):
    s, k = jpipe.dtw_rescore_detections(
        jnp.asarray(case["fmap"]), jnp.int32(case["valid"]), jnp.asarray(case["s"]),
        jnp.asarray(case["t"]), jnp.asarray(case["w_rows"]), jnp.asarray(case["c_rows"]),
        case["m_seg"], case["band"], ids=jnp.asarray(case["k"]), top_r=1,
    )
    return np.asarray(s), np.asarray(k)


@pytest.mark.parametrize("route,rel", [("gathered", 1e-5), ("map", 4e-3)])
def test_dtw_rescore_routes_against_reference_loop(dtw_case, route, rel):
    """``dtw_rescore_batched``'s two verify-the-winner routes against the
    reference loop's rescore (f32 filters at HIGHEST) on the same peaks.
    The gathered route is the loop's, f32 throughout: within 1e-5 x
    max|score| (f32 summation order).  The map route rounds the filters
    to bf16 (the reference stream's class, 4e-3 x max|score|); on this
    fixture it sits about 1e-4 x max|score| off, past the loop's 1e-5,
    which is why the loop does not take it."""
    want_s, want_k = _reference_rescore(dtw_case)
    got_s, got_k = tscan.dtw_rescore_batched(
        torch.from_numpy(dtw_case["fmap"] > 0)[None],
        torch.tensor([dtw_case["valid"]], dtype=torch.int32),
        torch.from_numpy(dtw_case["s"])[None], torch.from_numpy(dtw_case["t"])[None],
        torch.from_numpy(dtw_case["k"])[None], torch.from_numpy(dtw_case["w_rows"]),
        torch.from_numpy(dtw_case["c_rows"]), dtw_case["m_seg"], dtw_case["band"],
        top_r=1, plain=True, route=route,
    )
    got_s, got_k = got_s[0].numpy(), got_k[0].numpy()
    finite = np.isfinite(want_s)
    assert finite.sum() > 0
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_array_equal(got_k, want_k)
    top = np.max(np.abs(want_s[finite]))
    assert np.max(np.abs(got_s[finite] - want_s[finite])) <= rel * top


def test_dtw_rescore_rejects_unknown_route(dtw_case):
    with pytest.raises(ValueError, match="route"):
        tscan.dtw_rescore_batched(
            torch.zeros((1, 4, 8), dtype=torch.bool), torch.tensor([4]),
            torch.zeros((1, 1)), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 2, 8)),
            torch.zeros((1, 2)), 3, 1, top_r=1, route="bf16",
        )


def test_loop_dtw_asks_for_the_f32_route(synth, tbank4, monkeypatch):
    """The per-utterance loop rescores on f32 filters on every device:
    it names the gathered route, and the map route (bf16 filters) is
    never reached, here made to raise so the test holds on the CPU."""
    routes = []
    inner = tpipe.dtw_rescore_batched

    def spy(*args, **kwargs):
        routes.append(kwargs.get("route"))
        return inner(*args, **kwargs)

    def refuse(*_a, **_k):
        raise AssertionError("the loop reached the bf16 map route")

    monkeypatch.setattr(tpipe, "dtw_rescore_batched", spy)
    monkeypatch.setattr(tscan, "dtw_pairwise_scores_from_map", refuse)
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True, dtw_rescore=True))
    res = tpipe._detect_corpus_loop(TAdapter(synth), tbank4, cfg, "aa")
    assert len(res.detections.scores) > 0
    assert routes == ["gathered"] * len(res.utt_ids)


def test_loop_fft_branch_matches_reference(synth, jbank4, tbank4):
    """The loop's per-utterance FFT branch (which the router reaches
    only through ``_detect_corpus_loop`` itself, in both packages)."""
    want = jpipe._detect_corpus_loop(SyntheticAdapter(synth), jbank4,
                                     JC.PipelineConfig(), "aa")
    got = tpipe._detect_corpus_loop(TAdapter(synth), tbank4, TC.PipelineConfig(), "aa")
    _assert_same(got, want, exact=False)


@pytest.mark.parametrize("backend", ["fft", "conv"])
def test_detect_corpus_routes_batchable_to_stream(synth, tbank4, backend, tmp_path):
    """``fft`` and ``conv`` go through the streaming scan (its
    ``batches`` counter), the loop's results with them up to f32
    summation order; a manifest goes to the stream: the scan records its
    three shards there, and a second scan loads them all, bitwise."""
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(score_backend=backend, batch_size=2))
    got = tpipe.detect_corpus(TAdapter(synth), tbank4, cfg, "aa")
    assert got.counters["batches"] == 3
    loop = tpipe._detect_corpus_loop(TAdapter(synth), tbank4, cfg, "aa")
    for (sg, tg, kg), (sw, tw, kw) in zip(_per_utt(got), _per_utt(loop)):
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_array_equal(kg, kw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-6)
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest

    mdir = str(tmp_path / "m")
    first = tpipe.detect_corpus(TAdapter(synth), tbank4, cfg, "aa", manifest=ScanManifest(mdir))
    assert ScanManifest(mdir).completed() == {0, 1, 2}
    again = tpipe.detect_corpus(TAdapter(synth), tbank4, cfg, "aa", manifest=ScanManifest(mdir))
    assert (first.counters["batches"], again.counters["batches"]) == (3, 0)
    assert again.counters["shards_loaded"] == 3
    for name in ("scores", "times", "template_ids", "utterance_ids"):
        np.testing.assert_array_equal(getattr(got.detections, name),
                                      getattr(first.detections, name))
        np.testing.assert_array_equal(getattr(again.detections, name),
                                      getattr(first.detections, name))


def test_evaluate_detections_matches_reference(synth, jbank4, tbank4):
    """ROC / EER of one scan through both packages' evaluation, with and
    without a template mask: identical arrays."""
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True))
    res = tpipe.detect_corpus(TAdapter(synth), tbank4, cfg, "aa")
    jres = jpipe.CorpusDetections(res.detections, res.labels_per_utterance,
                                  res.audio_seconds, res.utt_ids, res.counters)
    mask = np.asarray([lbl == "aa" for lbl in tbank4.labels])
    for tm in (None, mask):
        got = tpipe.evaluate_detections(res, 10, template_mask=tm)
        want = jpipe.evaluate_detections(jres, 10, template_mask=tm)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def _write_bank(tmp_path, jbank):
    path = str(tmp_path / "bank.npz")
    jbank.save(path)
    return path


@pytest.mark.parametrize("flags", [["--exact"], ["--score-backend", "pallas"],
                                   ["--score-backend", "conv", "--dtw-rescore"]],
                         ids=["exact", "pallas", "conv-dtw"])
def test_cli_detect_exact_and_backends(tmp_path, capsys, jbank4, flags):
    from template_speech_recognition_tpu_torch.cli import main

    out = str(tmp_path / "dets.npz")
    assert main(["detect", "--bank", _write_bank(tmp_path, jbank4), "--phone", "aa",
                 "--device", "cpu", "--out", out, *flags]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"num_detections", "audio_seconds", "audio_s_per_s", "out"}
    z = np.load(out)
    assert len(z["scores"]) == line["num_detections"] > 0
    assert np.all(np.isfinite(z["scores"]))
    if flags == ["--exact"]:
        # int32 scores over quant_scale 256: multiples of 1/256
        np.testing.assert_array_equal(z["scores"] * 256, np.round(z["scores"] * 256))


def test_cli_evaluate_artifacts(tmp_path, capsys, jbank4):
    """``evaluate --exact --artifacts``: the reference's JSON line and
    its three artifacts, the ROC arrays equal to ``evaluate_detections``
    on the same scan."""
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = _write_bank(tmp_path, jbank4)
    art = str(tmp_path / "art")
    assert main(["evaluate", "--bank", bank_path, "--phone", "aa", "--exact",
                 "--device", "cpu", "--artifacts", art]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"phone", "eer", "best_tpr", "num_labels", "num_detections",
                         "artifacts"}
    assert sorted(os.listdir(art)) == ["detections.npz", "metrics.json", "roc.npz"]
    roc = np.load(os.path.join(art, "roc.npz"))
    dets = np.load(os.path.join(art, "detections.npz"))
    with open(os.path.join(art, "metrics.json")) as f:
        saved = json.load(f)
    assert saved["num_detections"] == line["num_detections"] == len(dets["scores"])
    assert saved["counters"]["utterances"] == 6
    corpus = TAdapter(O.make_synthetic_corpus(num_utterances=6, phones_per_utterance=5,
                                              seed=0))
    from template_speech_recognition_tpu_torch.models.bank import TemplateBank

    cfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True))
    res = tpipe.detect_corpus(corpus, TemplateBank.load(bank_path, device="cpu"), cfg,
                              "aa")
    m = tpipe.evaluate_detections(res, cfg.detect.match_tolerance)
    for key in ("thresholds", "tpr", "fp_per_sec"):
        np.testing.assert_array_equal(roc[key], m[key])
    assert float(roc["eer"]) == pytest.approx(line["eer"], abs=5e-5)


@pytest.mark.parametrize("argv", [["evaluate", "--tensorboard", "tb"]])
def test_cli_unported_flags_raise(tmp_path, capsys, jbank4, argv):
    """``evaluate --tensorboard DIR``, refused until the flag was ported,
    now writes the reference's scalars under its tags: the events hold
    ``--artifacts``' ROC and EER of the same run, and the reference CLI's
    tags and ROC on the same bank (exact int32 scores: the same
    detections)."""
    from template_speech_recognition_tpu import checkpoint as jckpt
    from template_speech_recognition_tpu import cli as jcli
    from template_speech_recognition_tpu_torch.cli import main

    tags = {"eval/eer", "eval/best_tpr", "eval/audio_s_per_s", "roc/tpr", "roc/fp_per_sec"}
    tb, art = str(tmp_path / argv[2]), str(tmp_path / "art")
    assert main([argv[0], "--bank", _write_bank(tmp_path, jbank4), "--phone", "aa",
                 "--device", "cpu", "--exact", "--artifacts", art, *argv[1:2], tb]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        assert "tensorboard unavailable" in out.err and "tensorboard" not in line
        return
    assert line["tensorboard"] == tb

    def scalars(path):
        ea = EventAccumulator(path)
        ea.Reload()
        assert set(ea.Tags()["scalars"]) == tags
        return {t: [(e.step, e.value) for e in ea.Scalars(t)] for t in tags}

    got = scalars(tb)
    roc = np.load(os.path.join(art, "roc.npz"))
    with open(os.path.join(art, "metrics.json")) as f:
        counters = json.load(f)["counters"]
    f32 = np.float32
    assert len(roc["tpr"]) > 1
    assert got["roc/tpr"] == [(i, f32(v)) for i, v in enumerate(roc["tpr"])]
    assert got["roc/fp_per_sec"] == [(i, f32(v)) for i, v in enumerate(roc["fp_per_sec"])]
    assert got["eval/eer"] == [(0, f32(roc["eer"]))]
    assert got["eval/best_tpr"] == [(0, f32(roc["tpr"].max()))]
    assert got["eval/audio_s_per_s"] == [(0, f32(counters["audio_s_per_s"]))]
    odir = str(tmp_path / "bank_orbax")
    jckpt.save_bank(odir, jbank4)
    jtb = str(tmp_path / "jtb")
    args = jcli.build_parser().parse_args(["evaluate", "--bank", odir, "--phone", "aa",
                                           "--exact", "--tensorboard", jtb])
    assert jcli.cmd_evaluate(args) == 0
    want = scalars(jtb)
    for tag in tags - {"eval/audio_s_per_s"}:
        assert got[tag] == want[tag], tag


@pytest.mark.parametrize("command", ["detect", "evaluate"])
def test_cli_scan_with_manifest(tmp_path, capsys, jbank4, command):
    """``--manifest DIR``: the scan records its shards in DIR and gives the
    clean scan's detections; run again, it loads them all and gives them
    again (``detect``'s ``--out``, ``evaluate``'s artifacts and line)."""
    from template_speech_recognition_tpu_torch.checkpoint import ScanManifest
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = _write_bank(tmp_path, jbank4)
    mdir = str(tmp_path / "m")
    runs = []
    for tag, extra in (("clean", []), ("record", ["--manifest", mdir]),
                       ("resume", ["--manifest", mdir])):
        out = str(tmp_path / tag)
        where = ["--out", out + ".npz"] if command == "detect" else ["--artifacts", out]
        assert main([command, "--bank", bank_path, "--phone", "aa", "--device", "cpu",
                     *where, *extra]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        path = out + ".npz" if command == "detect" else os.path.join(out, "detections.npz")
        runs.append((line, dict(np.load(path))))
        if tag == "record":
            assert ScanManifest(mdir).completed() == {0}
    (line0, dets0), *rest = runs
    assert len(dets0["scores"]) > 0
    for line, dets in rest:
        for key in ("scores", "times", "template_ids", "utterance_ids"):
            np.testing.assert_array_equal(dets[key], dets0[key])
        keys = ("num_detections",) if command == "detect" else (
            "eer", "best_tpr", "num_labels", "num_detections")
        assert {k: line[k] for k in keys} == {k: line0[k] for k in keys}


# ---- the port twin of tests/test_roc_equality.py -----------------------

@pytest.fixture(scope="module")
def roc_corpus():
    return O.make_synthetic_corpus(num_utterances=6, phones_per_utterance=6, seed=11)


def _oracle_detect_corpus(corpus, bank, cfg, target_phone):
    """The NumPy oracle pipeline on the exact path (oracle frontend,
    int32 bank scoring, NMS/top-K with the same per-bucket budget), on
    the port bank's own ``llr_quantized``."""
    p = FrontendParams()
    fcfg = cfg.frontend
    w_int, c_int = (x.numpy() for x in bank.llr_quantized(cfg.detect.quant_scale))
    scale = np.float32(cfg.detect.quant_scale)
    per_utt, labels, total = [], [], 0
    for _uid, wav, phones in corpus.iter_utterances():
        total += len(wav)
        si = O.sliding_score_int(O.frontend(wav, p), w_int, c_int)
        top_k = cfg.detect.effective_top_k(bucket_length(len(wav)), fcfg.sample_rate)
        times, s_int, tids = bank_nms(si, cfg.detect.nms_radius, max_peaks=top_k)
        per_utt.append((s_int.astype(np.float32) / scale, times, tids))
        labels.append(np.asarray(
            [s0 // fcfg.hop_length for (ph, s0, _e) in phones if ph == target_phone],
            dtype=np.int64))
    return CorpusDetections(tev.DetectionSet.from_per_utterance(per_utt), labels,
                            total / corpus.sample_rate, list(range(len(per_utt))), {})


def test_int32_roc_equality_end_to_end(roc_corpus):
    """A bank trained by the reference (fixture seed 11), carried across:
    the port's ``detect_corpus(exact_scores=True)`` and the oracle
    pipeline give identical detections and bitwise-equal ROC arrays."""
    jcfg = JC.PipelineConfig(detect=JC.DetectConfig(exact_scores=True))
    jbank = train_bank(SyntheticAdapter(roc_corpus), ["aa"], jcfg)
    bank = bank_from_numpy(np.asarray(jbank.templates), np.asarray(jbank.background),
                           jbank.labels, device="cpu")
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True))
    port = tpipe.detect_corpus(TAdapter(roc_corpus), bank, cfg, target_phone="aa")
    orc = _oracle_detect_corpus(TAdapter(roc_corpus), bank, cfg, "aa")
    for field in ("utterance_ids", "times", "template_ids"):
        np.testing.assert_array_equal(getattr(port.detections, field),
                                      getattr(orc.detections, field))
    np.testing.assert_array_equal(np.asarray(port.detections.scores, np.float32),
                                  np.asarray(orc.detections.scores, np.float32))
    m = tpipe.evaluate_detections(port, cfg.detect.match_tolerance)
    is_tp = np.concatenate([
        O.match_detections(
            orc.detections.times[orc.detections.utterance_ids == u],
            orc.detections.scores[orc.detections.utterance_ids == u],
            orc.labels_per_utterance[u], cfg.detect.match_tolerance)
        for u in range(len(orc.labels_per_utterance))
    ])
    num_labels = int(sum(len(lb) for lb in orc.labels_per_utterance))
    thr, tpr, fps = O.roc_curve(orc.detections.scores, is_tp, num_labels,
                                orc.audio_seconds)
    np.testing.assert_array_equal(m["thresholds"], thr)
    np.testing.assert_array_equal(m["tpr"], tpr)
    np.testing.assert_array_equal(m["fp_per_sec"], fps)
    assert m["num_labels"] == num_labels
    assert m["best_tpr"] >= 0.9, m
    assert m["eer"] <= 0.15, m
    assert torch.equal(bank.llr_quantized(256)[0],
                       torch.from_numpy(np.array(jbank.llr_quantized(256)[0])))
