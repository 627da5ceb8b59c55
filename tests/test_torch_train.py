"""The port's training path (config 3) against the JAX reference, on the
CPU: registration, template and background estimation, Bernoulli
mixture EM with restarts in lockstep, ``train_bank`` with and without
parts, ``TemplateBank.save`` / ``load`` across both packages, and the
CLI's ``train``.  The same inputs (numpy, fixed seeds) go through both
packages; the port is held to the classes the reference holds itself
to (``tests/test_models.py``, ``tests/test_em_restarts.py``)."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle as O
from oracle.mixture import init_responsibilities
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu import models as jmodels
from template_speech_recognition_tpu import pipeline as jpipe
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu.pipeline import SyntheticAdapter
from template_speech_recognition_tpu_torch import config as TC
from template_speech_recognition_tpu_torch import models as tmodels
from template_speech_recognition_tpu_torch import pipeline as tpipe
from template_speech_recognition_tpu_torch.corpus import SyntheticAdapter as TAdapter
from template_speech_recognition_tpu_torch.models import mixture as tmix
from template_speech_recognition_tpu_torch.models.bank import TemplateBank


def _em_data(seed=0, n=40, d=64, protos=3):
    rng = np.random.default_rng(seed)
    p = rng.random((protos, d)) < 0.3
    comp = rng.integers(0, protos, n)
    flip = rng.random((n, d)) < 0.1
    return (p[comp] ^ flip).astype(np.float32)


def _hist_close(got, want):
    """NaN-padded histories: NaN alike, finite within the reference's
    class (rtol 1e-4, atol 1e-3)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-3)


# ---- registration and estimation --------------------------------------

def test_register_exemplars_bitwise():
    """Lengths 1, L and longer than L (and between), bitwise against the
    reference and the oracle."""
    rng = np.random.default_rng(0)
    target = 7
    lengths = np.array([1, target, 12, 3, 9, 2])
    stack = rng.random((len(lengths), 12, 6, 8)) < 0.4
    for i, ln in enumerate(lengths):
        stack[i, ln:] = False
    got = tmodels.register_exemplars(torch.from_numpy(stack), torch.from_numpy(lengths),
                                     target)
    want = np.asarray(jmodels.register_exemplars(jnp.asarray(stack), jnp.asarray(lengths),
                                                 target))
    assert got.dtype == torch.bool and got.shape == want.shape == (6, target, 6, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    orc = O.register_exemplars([stack[i, :ln] for i, ln in enumerate(lengths)], target)
    np.testing.assert_array_equal(got.numpy(), orc)


def test_template_and_background_estimates():
    rng = np.random.default_rng(1)
    stack = rng.random((9, 5, 6, 8)) < 0.3
    got = tmodels.estimate_template(torch.from_numpy(stack), 0.01)
    want = np.asarray(jmodels.estimate_template(jnp.asarray(stack), 0.01))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    valid = np.array([5, 0, 3, 1, 5, 2, 4, 5, 1])
    maps = stack.copy()
    for i, v in enumerate(valid):
        maps[i, v:] = False
    got = tmodels.estimate_background(torch.from_numpy(maps), torch.from_numpy(valid), 0.02)
    want = np.asarray(jmodels.estimate_background(jnp.asarray(maps), jnp.asarray(valid),
                                                  0.02))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- EM ---------------------------------------------------------------

def test_em_step_mask_acts_as_absent_rows():
    """Masked rows behave as absent rows: one step against the step on
    the subset, and the whole fit against the reference's masked fit."""
    x = _em_data(seed=4, n=32)
    resp = init_responsibilities(24, 2, seed=1)
    full = np.zeros((32, 2), np.float32)
    full[:24] = resp
    mask = np.zeros(32, np.float32)
    mask[:24] = 1.0
    masked = tmodels.em_step(torch.from_numpy(x), torch.from_numpy(full),
                             torch.from_numpy(mask), 0.01)
    subset = tmodels.em_step(torch.from_numpy(x[:24]), torch.from_numpy(resp),
                             torch.ones(24), 0.01)
    for a, b in zip(masked[1:], subset[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(masked[0][:24].numpy(), subset[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    got = tmodels.bernoulli_mixture_em(torch.from_numpy(x), full, num_iters=10,
                                       mask=torch.from_numpy(mask))
    want = jmodels.bernoulli_mixture_em(jnp.asarray(x), jnp.asarray(full), num_iters=10,
                                        mask=jnp.asarray(mask))
    assert int(got.iteration) == int(want.iteration)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=1e-4,
                               atol=1e-5)
    sub = tmodels.bernoulli_mixture_em(torch.from_numpy(x[:24]), resp, num_iters=10)
    np.testing.assert_allclose(got.means.numpy(), sub.means.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,k,iters,tol", [(0, 3, 25, 1e-4), (3, 4, 30, 0.0),
                                              (5, 2, 40, 1e-3)])
def test_em_matches_reference(seed, k, iters, tol):
    """The same iteration count, means, weights and history as the
    reference; the history never falls by more than 1e-3."""
    x = _em_data(seed=seed)
    resp = init_responsibilities(x.shape[0], k, seed=seed + 5)
    got = tmodels.bernoulli_mixture_em(torch.from_numpy(x), resp, num_iters=iters, tol=tol)
    want = jmodels.bernoulli_mixture_em(jnp.asarray(x), jnp.asarray(resp), num_iters=iters,
                                        tol=tol)
    assert int(got.iteration) == int(want.iteration)
    assert bool(got.done) == bool(want.done)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-4,
                               atol=1e-6)
    _hist_close(got.history.numpy(), want.history)
    hist = got.history.numpy()
    hist = hist[np.isfinite(hist)]
    assert len(hist) == int(got.iteration)
    assert np.all(np.diff(hist) >= -1e-3)
    np.testing.assert_allclose(got.responsibilities.numpy(),
                               np.asarray(want.responsibilities), rtol=1e-4, atol=1e-5)


def _restart_data():
    rng = np.random.default_rng(0)
    protos = rng.random((2, 24)) < 0.5
    who = rng.integers(0, 2, 60)
    return (protos[who] ^ (rng.random((60, 24)) < 0.1)).astype(np.float32)


def test_restarts_match_reference_and_freeze():
    """Four restarts in lockstep that stop at different iterations: the
    reference's winner and state, and each restart equal to its own
    single run (a finished restart freezes while the others go on)."""
    x = _restart_data()
    r, k = 4, 3
    resps = np.stack([init_responsibilities(x.shape[0], k, 7 + i) for i in range(r)])
    got, best = tmodels.bernoulli_mixture_em_restarts(torch.from_numpy(x), resps,
                                                      num_iters=25)
    want, jbest = jmodels.bernoulli_mixture_em_restarts(jnp.asarray(x), jnp.asarray(resps),
                                                        num_iters=25)
    assert best == int(jbest)
    assert int(got.iteration) == int(want.iteration)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=1e-4,
                               atol=1e-5)
    _hist_close(got.history.numpy(), want.history)
    _m, _w, _h, _it, obest = O.bernoulli_mixture_em_restarts(x, k, r, seed=7, num_iters=25)
    assert best == obest
    every = tmix._fit(torch.from_numpy(x), resps, 25, 0.01, 1e-4, None)
    iters = every.iteration.tolist()
    assert len(set(iters)) > 1, iters
    for i in range(r):
        one = tmodels.bernoulli_mixture_em(torch.from_numpy(x), resps[i], num_iters=25)
        assert iters[i] == int(one.iteration)
        np.testing.assert_allclose(every.means[i].numpy(), one.means.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(every.weights[i].numpy(), one.weights.numpy(),
                                   rtol=1e-5, atol=1e-7)
        _hist_close(every.history[i].numpy(), one.history.numpy())


def test_restart_ties_go_to_the_lowest_index():
    """Restarts from equal inits end equal: the winner is the lowest
    index among the best, as in the reference."""
    x = _restart_data()
    a = init_responsibilities(x.shape[0], 3, 7)
    b = init_responsibilities(x.shape[0], 3, 9)
    for resps in (np.stack([a, a, a]), np.stack([b, a, a]), np.stack([a, b, b])):
        _s, best = tmodels.bernoulli_mixture_em_restarts(torch.from_numpy(x), resps,
                                                         num_iters=25)
        _js, jbest = jmodels.bernoulli_mixture_em_restarts(jnp.asarray(x),
                                                           jnp.asarray(resps), num_iters=25)
        ll = tmix._fit(torch.from_numpy(x), resps, 25, 0.01, 1e-4, None).log_likelihood
        assert best == int(jbest) == int(np.flatnonzero(ll.numpy() == ll.numpy().max())[0])
        assert best in (0, 1)


def test_models_exports_match_reference():
    assert set(tmodels.__all__) == set(jmodels.__all__)
    assert tmodels.EMState._fields == jmodels.EMState._fields


# ---- train_bank ---------------------------------------------------------

CASES = {
    "one-component": dict(template={}, parts={}),
    "mixture": dict(template=dict(num_components=2), parts={}),
    "mixture-restarts": dict(template=dict(num_components=2, em_restarts=3), parts={}),
    "parts": dict(template={}, parts=dict(enabled=True)),
}


@pytest.fixture(scope="module")
def synth():
    return O.make_synthetic_corpus(num_utterances=5, phones_per_utterance=5, seed=3)


def _spy(module, name, seen, monkeypatch):
    inner = getattr(module, name)

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        state, best = (out, 0) if hasattr(out, "iteration") else out
        seen.append((int(state.iteration), int(best)))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def trained(synth):
    """Both packages' banks for every case, with each class's EM
    iteration count and winning restart."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jseen, tseen = [], []
        _spy(jpipe, "bernoulli_mixture_em", jseen, mp)
        _spy(jmodels, "bernoulli_mixture_em_restarts", jseen, mp)
        _spy(tpipe, "bernoulli_mixture_em", tseen, mp)
        _spy(tpipe, "bernoulli_mixture_em_restarts", tseen, mp)
        for name, case in CASES.items():
            jcfg = JC.PipelineConfig(template=JC.TemplateConfig(**case["template"]),
                                     parts=JC.PartsConfig(**case["parts"]))
            tcfg = TC.PipelineConfig(template=TC.TemplateConfig(**case["template"]),
                                     parts=TC.PartsConfig(**case["parts"]))
            del jseen[:], tseen[:]
            jb = jpipe.train_bank(SyntheticAdapter(synth), ["aa", "iy"], jcfg)
            tb = tpipe.train_bank(TAdapter(synth), ["aa", "iy"], tcfg, device="cpu")
            out[name] = (jb, tb, list(jseen), list(tseen))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_bank_matches_reference(trained, case):
    """Labels equal; templates, background and parts within the
    reference's classes; the same EM iteration counts and winners."""
    jb, tb, jseen, tseen = trained[case]
    assert tb.labels == jb.labels
    assert tuple(tb.templates.shape) == np.asarray(jb.templates).shape
    np.testing.assert_allclose(tb.templates.numpy(), np.asarray(jb.templates), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.background.numpy(), np.asarray(jb.background),
                               rtol=1e-6, atol=1e-6)
    assert (tb.parts is None) == (jb.parts is None)
    if tb.parts is not None:
        np.testing.assert_allclose(tb.parts.numpy(), np.asarray(jb.parts), rtol=1e-3,
                                   atol=1e-3)
        assert tuple(tb.templates.shape[2:]) == (252, 32)
    assert tseen == jseen
    assert len(tseen) == (2 if CASES[case]["template"] else 0)


def test_clip_feature_maps_match_reference(synth):
    """The batched exemplar maps (a chunk of 4 with one padding row of no
    valid sample): the reference's maps, bitwise, and its lengths;
    registration of them bitwise too."""
    cfg = TC.PipelineConfig()
    clips = TAdapter(synth).exemplar_clips("aa")
    stack, lengths = tpipe._clip_feature_maps(clips, cfg, device="cpu", batch=4)
    maps, jlengths = jpipe._clip_feature_maps(clips, JC.PipelineConfig(), batch=4)
    assert len(clips) % 4 != 0
    np.testing.assert_array_equal(lengths, jlengths)
    assert stack.dtype == torch.bool and stack.shape[0] == len(maps)
    for i, m in enumerate(maps):
        np.testing.assert_array_equal(stack[i, : m.shape[0]].numpy(), m)
        assert not bool(stack[i, m.shape[0]:].any())
    target = int(np.median(lengths))
    got = tmodels.register_exemplars(stack, lengths, target)
    padded = np.zeros((len(maps), int(jlengths.max())) + maps[0].shape[1:], bool)
    for i, m in enumerate(maps):
        padded[i, : m.shape[0]] = m
    want = jmodels.register_exemplars(jnp.asarray(padded), jnp.asarray(jlengths), target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- save / load across packages ------------------------------------------

@pytest.mark.parametrize("case", ["mixture", "parts"])
def test_bank_save_load_both_ways(tmp_path, trained, case):
    jb, tb, _j, _t = trained[case]
    path = str(tmp_path / "port.npz")
    tb.save(path)
    back = TemplateBank.load(path, device="cpu")
    assert back.labels == tb.labels
    for name in ("templates", "background", "parts"):
        a, b = getattr(back, name), getattr(tb, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    jl = JBank.load(path)
    np.testing.assert_array_equal(np.asarray(jl.templates), tb.templates.numpy())
    assert jl.labels == tb.labels and (jl.parts is None) == (tb.parts is None)
    if jl.parts is not None:
        np.testing.assert_array_equal(np.asarray(jl.parts), tb.parts.numpy())
    jpath = str(tmp_path / "jax.npz")
    jb.save(jpath)
    tl = TemplateBank.load(jpath, device="cpu")
    np.testing.assert_array_equal(tl.templates.numpy(), np.asarray(jb.templates))
    np.testing.assert_array_equal(tl.background.numpy(), np.asarray(jb.background))
    assert tl.labels == jb.labels and (tl.parts is None) == (jb.parts is None)
    if tl.parts is not None:
        np.testing.assert_array_equal(tl.parts.numpy(), np.asarray(jb.parts))


def test_from_classes_sorts_and_splits_components():
    rng = np.random.default_rng(2)
    one = rng.uniform(0.1, 0.9, (4, 6, 8)).astype(np.float32)
    two = rng.uniform(0.1, 0.9, (2, 4, 6, 8)).astype(np.float32)
    bg = rng.uniform(0.1, 0.9, (6, 8)).astype(np.float32)
    tb = TemplateBank.from_classes({"iy": two, "aa": one}, bg, device="cpu")
    jb = JBank.from_classes({"iy": two, "aa": one}, bg)
    assert tb.labels == jb.labels == ["aa", "iy", "iy"]
    np.testing.assert_array_equal(tb.templates.numpy(), np.asarray(jb.templates))
    assert tb.parts is None


# ---- the trained bank end to end -------------------------------------------

def test_int32_roc_equality_on_a_port_trained_bank():
    """The ROC twin (``test_torch_pipeline.py``) on a bank the port
    trained: ``detect_corpus(exact_scores=True)`` and the oracle pipeline
    give identical detections and ROC arrays, and the bank equals the
    reference's."""
    from test_torch_pipeline import _oracle_detect_corpus

    corpus = O.make_synthetic_corpus(num_utterances=6, phones_per_utterance=6, seed=11)
    cfg = TC.PipelineConfig(detect=TC.DetectConfig(exact_scores=True))
    bank = tpipe.train_bank(TAdapter(corpus), ["aa"], cfg, device="cpu")
    jbank = jpipe.train_bank(SyntheticAdapter(corpus), ["aa"],
                             JC.PipelineConfig(detect=JC.DetectConfig(exact_scores=True)))
    np.testing.assert_allclose(bank.templates.numpy(), np.asarray(jbank.templates),
                               rtol=1e-6, atol=1e-7)
    port = tpipe.detect_corpus(TAdapter(corpus), bank, cfg, target_phone="aa")
    orc = _oracle_detect_corpus(TAdapter(corpus), bank, cfg, "aa")
    for field in ("utterance_ids", "times", "template_ids"):
        np.testing.assert_array_equal(getattr(port.detections, field),
                                      getattr(orc.detections, field))
    np.testing.assert_array_equal(np.asarray(port.detections.scores, np.float32),
                                  np.asarray(orc.detections.scores, np.float32))
    m = tpipe.evaluate_detections(port, cfg.detect.match_tolerance)
    assert m["best_tpr"] >= 0.9, m
    assert m["eer"] <= 0.15, m


@pytest.mark.parametrize("flags", [["--components", "2"], ["--parts", "4"]],
                         ids=["components", "parts"])
def test_cli_train_then_detect(tmp_path, capsys, flags):
    """``train`` writes the reference's JSON line and a ``.npz`` that both
    packages load and that equals the reference's bank; ``detect`` scans
    with it."""
    from template_speech_recognition_tpu_torch.cli import main

    bank_path = str(tmp_path / "bank.npz")
    assert main(["train", "--phones", "aa,iy", "--bank", bank_path, "--device", "cpu",
                 *flags]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["trained"] == ["aa", "iy"] and line["bank"] == bank_path
    assert set(line) == {"trained", "num_templates", "template_length", "bank"}
    jl = JBank.load(bank_path)
    assert line["num_templates"] == jl.num_templates
    assert line["template_length"] == jl.template_length
    jcfg = JC.PipelineConfig()
    if flags[0] == "--components":
        jcfg = JC.override(jcfg, template=JC.override(jcfg.template, num_components=2))
        assert jl.num_templates == 4 and jl.parts is None
    else:
        jcfg = JC.override(jcfg, parts=JC.override(jcfg.parts, enabled=True, num_parts=4))
        assert np.asarray(jl.parts).shape[0] == 4
    want = jpipe.train_bank(
        SyntheticAdapter(O.make_synthetic_corpus(num_utterances=6, phones_per_utterance=5,
                                                 seed=0)), ["aa", "iy"], jcfg)
    np.testing.assert_allclose(np.asarray(jl.templates), np.asarray(want.templates),
                               rtol=1e-4, atol=1e-5)
    out = str(tmp_path / "dets.npz")
    assert main(["detect", "--bank", bank_path, "--phone", "aa", "--device", "cpu",
                 "--out", out]) == 0
    dline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    z = np.load(out)
    assert len(z["scores"]) == dline["num_detections"] > 0
    assert np.all(np.isfinite(z["scores"]))
    assert set(z["template_ids"].tolist()) <= set(range(line["num_templates"]))
