"""The port's sharded corpus scan (``parallel.detect_corpus_sharded``) on
real gloo processes against the reference's sharded scan on the 8 fake
CPU devices, at the same mesh shapes, in the reference's own classes
(``tests/test_detect_sharded.py``):

* the fft and conv scans: times and template ids equal, scores rtol
  1e-4 / atol 1e-3, the same EER;
* DTW rescoring (top_r 1 and 0): times and ids equal, scores rtol 1e-4
  / atol 1e-4;
* exact int32 scores: bitwise;
* DTW + int8 spectra + PCM16 upload (the "kitchen sink"): int8 block
  spectra quantize per shard call, so borderline peaks may differ: the
  matched peaks keep their template and their score within 2e-2 of
  max|score|, and at most 2 peaks differ; against the single-device
  scan only in that class.

Also: a bank of K = 2 over 4 bank ranks (padded to 8 a rank, pads never
win), per-rank feeding (each utterance decoded by one rank of its data
block only), a manifest-resumed scan bitwise the clean one, the
collective-bytes counter, and the ``ValueError`` of a time shard shorter
than the NMS radius or the halo.  One module fixture runs every 4-rank
case in one group of workers while the reference runs here; one test
runs the (2, 2, 2) mesh on 8 ranks.
"""

from __future__ import annotations

import numpy as np
import pytest

from oracle.fixtures import make_synthetic_corpus
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu.parallel import build_mesh as j_build_mesh
from template_speech_recognition_tpu.parallel.detect_sharded import (
    detect_corpus_sharded as j_detect_corpus_sharded,
)
from template_speech_recognition_tpu.pipeline import SyntheticAdapter, train_bank
from template_speech_recognition_tpu.scan import (
    detect_corpus_stream as j_detect_corpus_stream,
)
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import pipeline as tpipe
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.detect.evaluate import DetectionSet
from template_speech_recognition_tpu_torch.parallel import detect_corpus_sharded, local_mesh
from template_speech_recognition_tpu_torch.scan import CorpusDetections, detect_corpus_stream
from torch_dist import Workers
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

WORLD = 4
CORPUS = dict(num_utterances=4, phones_per_utterance=4, seed=0)
KITCHEN_CORPUS = dict(num_utterances=4, phones_per_utterance=4, seed=11)
RESUME_CORPUS = dict(num_utterances=6, phones_per_utterance=4, seed=0)
FEED_CORPUS = dict(num_utterances=4, phones_per_utterance=4, seed=5)
PARTS = dict(enabled=True, num_parts=4, patch_time=3, patch_freq=3, num_patches=200,
             em_iters=5)


def _tag(mesh) -> str:
    return "x".join(map(str, mesh))


def _cfg(detect=None, dtw=None, parts=None) -> dict:
    out = {}
    if detect:
        out["detect"] = detect
    if dtw:
        out["dtw"] = dtw
    if parts:
        out["parts"] = parts
    return out


def _case(name, mesh, cfg=None, bank="bank.npz", corpus=CORPUS, **kw):
    return dict(name=name, mesh=mesh, cfg=cfg or {}, bank=bank, corpus=corpus, **kw)


FFT_MESHES = [(1, 1, 4), (2, 2, 1), (1, 2, 2)]
DTW_MESHES = [(1, 1, 4), (2, 2, 1), (1, 2, 2)]
EXACT_MESHES = [(1, 1, 4), (2, 2, 1), (1, 2, 2)]
PARTS_MESHES = [(2, 2, 1), (1, 2, 2), (2, 1, 2)]
KITCHEN = _cfg({"batch_size": 2, "dtw_rescore": True, "int8_spectra": True}, {"top_r": 1})

CASES = (
    [_case(f"fft/{_tag(m)}", m) for m in FFT_MESHES]
    + [_case("conv/2x1x2", (2, 1, 2), _cfg({"score_backend": "conv"}))]
    + [_case("pad/1x4x1", (1, 4, 1))]
    + [_case(f"dtw/{_tag(m)}", m, _cfg({"dtw_rescore": True})) for m in DTW_MESHES]
    + [_case("dtw0/1x2x2", (1, 2, 2), _cfg({"dtw_rescore": True}, {"top_r": 0}))]
    + [_case(f"exact/{_tag(m)}", m, _cfg({"exact_scores": True})) for m in EXACT_MESHES]
    + [_case(f"parts/{_tag(m)}", m, _cfg({"score_backend": "conv"}, parts=PARTS),
             bank="parts.npz") for m in PARTS_MESHES]
    + [_case("kitchen/2x1x2", (2, 1, 2), KITCHEN, bank="kitchen.npz",
             corpus=KITCHEN_CORPUS, env={"SCAN_UPLOAD_INT16": "1"})]
    + [_case("resume/clean", (1, 2, 2), _cfg({"batch_size": 2}), corpus=RESUME_CORPUS),
       _case("resume/fault", (1, 2, 2), _cfg({"batch_size": 2}), corpus=RESUME_CORPUS,
             manifest="manifest", fail_after=2),
       _case("resume/resumed", (1, 2, 2), _cfg({"batch_size": 2}), corpus=RESUME_CORPUS,
             manifest="manifest")]
    + [_case("feed/2x1x1", (2, 1, 1), _cfg({"batch_size": 4}), bank="feed.npz",
             corpus=FEED_CORPUS),
       _case("feed/2x2x1", (2, 2, 1), _cfg({"batch_size": 4}), bank="feed.npz",
             corpus=FEED_CORPUS)]
    + [_case("short/nms", (1, 1, 4), _cfg({"nms_radius": 200})),
       _case("short/halo", (1, 1, 4), _cfg({"dtw_rescore": True}, {"band": 40}))]
)


def _jcfg(cfg: dict) -> JC.PipelineConfig:
    return JC.pipeline_from_dict(cfg)


def _jcorpus(spec):
    return SyntheticAdapter(make_synthetic_corpus(**spec))


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The reference's banks (aa/iy of the default config, K = 2; a parts
    bank; the kitchen sink's and the feeding test's), saved for the
    workers."""
    root = tmp_path_factory.mktemp("sharded_scan")
    corpus = _jcorpus(CORPUS)
    out = {
        "bank.npz": train_bank(corpus, ["aa", "iy"], JC.PipelineConfig()),
        "parts.npz": train_bank(corpus, ["aa"], _jcfg(_cfg({"score_backend": "conv"},
                                                          parts=PARTS))),
        "kitchen.npz": train_bank(_jcorpus(KITCHEN_CORPUS), ["aa", "iy"], _jcfg(KITCHEN)),
        "feed.npz": train_bank(_jcorpus(FEED_CORPUS), ["aa"], _jcfg(_cfg({"batch_size": 4}))),
    }
    assert out["parts.npz"].parts is not None
    for name, bank in out.items():
        bank.save(str(root / name))
    return root, out


def _reference(case, banks):
    """The reference's sharded scan of ``case``, under the case's
    environment (the PCM16 upload)."""
    _root, jbanks = banks
    mesh = j_build_mesh(JC.MeshConfig(*case["mesh"]))
    with pytest.MonkeyPatch.context() as mp:
        for key, val in case.get("env", {}).items():
            mp.setenv(key, val)
        return j_detect_corpus_sharded(_jcorpus(case["corpus"]), jbanks[case["bank"]],
                                       _jcfg(case["cfg"]), mesh, target_phone="aa")


@pytest.fixture(scope="module")
def scans(banks):
    root, _jbanks = banks
    w = Workers("scan", WORLD, {"cases": CASES, "dir": str(root)}, root, timeout=420)
    refs = {}
    for case in CASES:
        if case["name"].startswith(("resume/", "short/")):
            continue
        refs[case["name"]] = _reference(case, banks)
    arrays, recs = w.result()
    return refs, arrays, recs


def _port(arrays, recs, name, rank=0):
    """The port's ``CorpusDetections`` of case ``name`` as rank ``rank``
    returned it."""
    d = DetectionSet(*(arrays[f"{name}/{f}"] for f in
                       ("scores", "times", "template_ids", "utterance_ids")))
    rec = recs[rank]
    return CorpusDetections(d, [np.asarray(lb, np.int64) for lb in rec["labels"][name]],
                            rec["audio_seconds"][name], rec["utt_ids"][name],
                            rec["counters"][name])


def _torch_bank(banks, name):
    jb = banks[1][name]
    return bank_from_numpy(np.asarray(jb.templates), np.asarray(jb.background), jb.labels,
                           device="cpu")


def _sorted(d):
    order = np.lexsort((d.times, d.utterance_ids))
    return d.scores[order], d.times[order], d.template_ids[order], d.utterance_ids[order]


def _same_peaks(got, want, rtol, atol, bitwise=False):
    gs, gt, gk, gu = _sorted(got.detections)
    ws, wt, wk, wu = _sorted(want.detections)
    assert len(gs) == len(ws) > 0
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gk, wk)
    if bitwise:
        np.testing.assert_array_equal(np.asarray(gs, np.float32), np.asarray(ws, np.float32))
    else:
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)


def _every_rank_alike(arrays, recs, name, mesh):
    """Every rank of the mesh returned the same detections (rank 0's are
    in ``arrays``; the others' counts and utterances are compared)."""
    n = int(np.prod(mesh))
    for rec in recs[1:n]:
        assert rec["counters"][name]["detections"] == recs[0]["counters"][name]["detections"]
        assert rec["utt_ids"][name] == recs[0]["utt_ids"][name]
    for rec in recs[n:]:
        assert name not in rec.get("counters", {})


@pytest.mark.parametrize("mesh", FFT_MESHES, ids=_tag)
def test_sharded_fft_scan_matches_reference(scans, mesh):
    """The default (fft) scan: the reference's sharded scan's peaks, the
    same labels, audio seconds and EER."""
    refs, arrays, recs = scans
    name = f"fft/{_tag(mesh)}"
    got, want = _port(arrays, recs, name), refs[name]
    assert got.utt_ids == want.utt_ids
    assert got.audio_seconds == pytest.approx(want.audio_seconds)
    _same_peaks(got, want, rtol=1e-4, atol=1e-3)
    for lg, lw in zip(got.labels_per_utterance, want.labels_per_utterance):
        np.testing.assert_array_equal(lg, lw)
    m_got = tpipe.evaluate_detections(got, 10)
    m_want = tpipe.evaluate_detections(want, 10)
    assert m_got["num_labels"] == m_want["num_labels"]
    np.testing.assert_allclose(m_got["eer"], m_want["eer"], atol=1e-6)
    _every_rank_alike(arrays, recs, name, mesh)


def test_sharded_conv_scan_matches_reference(scans):
    refs, arrays, recs = scans
    _same_peaks(_port(arrays, recs, "conv/2x1x2"), refs["conv/2x1x2"], rtol=1e-4, atol=1e-3)


def test_sharded_bank_padding(scans, banks):
    """K = 2 over a 4-way bank axis: each rank holds 8 templates (the
    card's kernels take K in multiples of 8), the 30 pads carry c = -inf
    and never appear; the peaks are the reference's (K padded to 4)."""
    refs, arrays, recs = scans
    got = _port(arrays, recs, "pad/1x4x1")
    assert banks[1]["bank.npz"].num_templates == 2
    assert got.detections.template_ids.max() < 2
    _same_peaks(got, refs["pad/1x4x1"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mesh", DTW_MESHES, ids=_tag)
def test_sharded_dtw_rescore_matches_reference(scans, mesh):
    """Config 4 inside the step (verify-the-winner): the owner time shard
    rescores each merged peak from its halo-extended map."""
    refs, arrays, recs = scans
    name = f"dtw/{_tag(mesh)}"
    _same_peaks(_port(arrays, recs, name), refs[name], rtol=1e-4, atol=1e-4)


def test_sharded_exhaustive_dtw_matches_reference(scans):
    """top_r 0: every bank shard rescores against its templates, the best
    combines over ``bank`` (lowest id on ties)."""
    refs, arrays, recs = scans
    _same_peaks(_port(arrays, recs, "dtw0/1x2x2"), refs["dtw0/1x2x2"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh", EXACT_MESHES, ids=_tag)
def test_sharded_exact_scores_bitwise(scans, mesh):
    """int32 sums are order-independent: not one bit differs from the
    reference's sharded exact scan."""
    refs, arrays, recs = scans
    name = f"exact/{_tag(mesh)}"
    _same_peaks(_port(arrays, recs, name), refs[name], 0, 0, bitwise=True)


@pytest.mark.parametrize("mesh", PARTS_MESHES, ids=_tag)
def test_sharded_parts_bank_matches_reference(scans, mesh):
    """A parts-coded bank: the step re-codes each batch's maps before
    the time split."""
    refs, arrays, recs = scans
    name = f"parts/{_tag(mesh)}"
    _same_peaks(_port(arrays, recs, name), refs[name], rtol=1e-4, atol=1e-3)


def _kitchen_class(got, want):
    """The reference's class at ``test_detect_sharded.py:270-284``."""
    r, g = want.detections, got.detections
    rset = {(int(u), int(t)): (int(k), float(s))
            for u, t, k, s in zip(r.utterance_ids, r.times, r.template_ids, r.scores)}
    gset = {(int(u), int(t)): (int(k), float(s))
            for u, t, k, s in zip(g.utterance_ids, g.times, g.template_ids, g.scores)}
    common = set(rset) & set(gset)
    assert len(rset) > 0
    assert len(common) >= max(len(rset), len(gset)) - 2
    scale = np.max(np.abs(r.scores)) + 1e-6
    for key in common:
        assert rset[key][0] == gset[key][0], key
        assert abs(rset[key][1] - gset[key][1]) / scale < 2e-2, key


def test_sharded_kitchen_sink_matches_reference(scans, banks, monkeypatch):
    """DTW (top_r 1) + int8 spectra + PCM16 upload at (2, 1, 2): against
    the reference's sharded scan at the same mesh and against the
    reference's single-device stream, both in the reference's class."""
    refs, arrays, recs = scans
    got = _port(arrays, recs, "kitchen/2x1x2")
    _kitchen_class(got, refs["kitchen/2x1x2"])
    monkeypatch.setenv("SCAN_UPLOAD_INT16", "1")
    single = j_detect_corpus_stream(_jcorpus(KITCHEN_CORPUS), banks[1]["kitchen.npz"],
                                    _jcfg(KITCHEN), target_phone="aa")
    _kitchen_class(got, single)


def test_sharded_scan_manifest_resume(scans):
    """A scan failed in its third step resumes from the manifest (written
    by rank (0, 0, 0), read by every rank) bitwise the clean scan."""
    _refs, arrays, recs = scans
    for rec in recs:
        assert rec["errors"]["resume/fault"] == "RuntimeError: injected fault"
        assert rec["completed"]["resume/fault"] == [0, 1]
        assert rec["completed"]["resume/resumed"] == [0, 1, 2]
        assert rec["counters"]["resume/resumed"]["shards_loaded"] == 2
        assert rec["counters"]["resume/resumed"]["batches"] == 1
    for field in ("scores", "times", "template_ids", "utterance_ids"):
        np.testing.assert_array_equal(arrays[f"resume/resumed/{field}"],
                                      arrays[f"resume/clean/{field}"])
    assert len(arrays["resume/clean/scores"]) > 0


def test_sharded_scan_reports_collective_bytes(scans):
    """Bytes cross where an axis splits: > 0 on (1, 2, 2), none on a
    data-only mesh."""
    _refs, _arrays, recs = scans
    assert recs[0]["counters"]["fft/1x2x2"]["collective_bytes"] > 0
    assert recs[0]["counters"]["feed/2x1x1"].get("collective_bytes", 0.0) == 0.0


def test_per_rank_feeding_decodes_only_a_ranks_rows(scans):
    """Batches form from the metadata; a rank decodes the waveforms of its
    data block's rows only.  At (2, 1, 1) each utterance is decoded by
    exactly one rank and no rank decodes them all; at (2, 2, 1) the two
    bank ranks of a data block decode the same rows.  The detections are
    the reference's."""
    refs, arrays, recs = scans
    dec = [sorted(r["decoded"]["feed/2x1x1"]) for r in recs[:2]]
    assert sorted(dec[0] + dec[1]) == [0, 1, 2, 3]
    assert max(len(d) for d in dec) < 4
    dec4 = [sorted(r["decoded"]["feed/2x2x1"]) for r in recs]
    assert dec4[0] == dec4[1] and dec4[2] == dec4[3]
    assert sorted(dec4[0] + dec4[2]) == [0, 1, 2, 3]
    for name in ("feed/2x1x1", "feed/2x2x1"):
        _same_peaks(_port(arrays, recs, name), refs[name], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["nms", "halo"])
def test_short_time_shards_raise(scans, banks, kind):
    """A time shard shorter than the NMS radius or the halo raises
    ``ValueError`` on every rank, as in the reference."""
    _refs, _arrays, recs = scans
    name = f"short/{kind}"
    case = next(c for c in CASES if c["name"] == name)
    for rec in recs:
        assert rec["errors"][name].startswith("ValueError: time shard length")
        assert ("nms_radius" if kind == "nms" else "halo") in rec["errors"][name]
    with pytest.raises(ValueError, match="time shard length"):
        _reference(case, banks)


def test_local_mesh_scan_matches_the_stream(banks, monkeypatch):
    """A world of one on a 1x1x1 mesh (no worker): the port's sharded
    scan gives the single-device stream's detections bit for bit, in
    batches of the same shapes (with one data block the tail batches
    shrink to the next power of two that holds their rows, as the
    stream's: 4 utterances in batches of 3)."""
    import torch.distributed as dist

    from template_speech_recognition_tpu_torch import scan as tscan
    from template_speech_recognition_tpu_torch.parallel import detect_sharded as ds

    shapes = {"stream": [], "sharded": []}

    def spy(fn, key):
        def run(wavs, *a, **k):
            shapes[key].append(tuple(wavs.shape))
            return fn(wavs, *a, **k)
        return run

    monkeypatch.setattr(tscan, "scan_step", spy(tscan.scan_step, "stream"))
    monkeypatch.setattr(ds, "sharded_scan_step", spy(ds.sharded_scan_step, "sharded"))
    tbank = _torch_bank(banks, "bank.npz")
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(batch_size=3))
    corpus = TAdapter(make_synthetic_corpus(**CORPUS))
    want = detect_corpus_stream(corpus, tbank, cfg, "aa")
    try:
        got = detect_corpus_sharded(corpus, tbank, cfg, local_mesh(), "aa")
    finally:
        dist.destroy_process_group()
    _same_peaks(got, want, 0, 0, bitwise=True)
    assert got.counters["batches"] == want.counters["batches"]
    assert shapes["sharded"] == shapes["stream"]
    assert min(s[0] for s in shapes["stream"]) < 3


def test_sharded_scan_2x2x2_matches_reference(banks, tmp_path):
    """The reference's (2, 2, 2) mesh on 8 ranks: data, bank and time all
    split at once."""
    root, _jbanks = banks
    case = _case("fft/2x2x2", (2, 2, 2))
    w = Workers("scan", 8, {"cases": [case], "dir": str(root)}, tmp_path, timeout=300)
    want = _reference(case, banks)
    arrays, recs = w.result()
    _same_peaks(_port(arrays, recs, "fft/2x2x2"), want, rtol=1e-4, atol=1e-3)
    _every_rank_alike(arrays, recs, "fft/2x2x2", (2, 2, 2))


def test_local_mesh_plain_run_matches_the_kernel_route(banks):
    """``plain=True`` reaches every stage of the sharded step (DTW + int8
    spectra, verify-the-winner): on the CPU, where each wrapper runs its
    plain version, the two runs agree bit for bit."""
    import torch.distributed as dist

    cfg = TC.pipeline_from_dict(KITCHEN)
    corpus = TAdapter(make_synthetic_corpus(**KITCHEN_CORPUS))
    bank = _torch_bank(banks, "kitchen.npz")
    try:
        mesh = local_mesh()
        got = detect_corpus_sharded(corpus, bank, cfg, mesh, "aa")
        plain = detect_corpus_sharded(corpus, bank, cfg, mesh, "aa", plain=True)
    finally:
        dist.destroy_process_group()
    _same_peaks(got, plain, 0, 0, bitwise=True)
