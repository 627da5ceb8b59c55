"""The port's ``checkpoint.py`` against the JAX reference's, on the CPU:
the scan manifest's format both ways, bank and EM-state checkpoints, and
``run_em_checkpointed`` killed and resumed."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

from oracle.mixture import init_responsibilities
from template_speech_recognition_tpu import checkpoint as jckpt
from template_speech_recognition_tpu.models.bank import TemplateBank as JBank
from template_speech_recognition_tpu_torch import checkpoint as tckpt
from template_speech_recognition_tpu_torch.models import mixture as tmix
from template_speech_recognition_tpu_torch.models.bank import TemplateBank


def _same(a, b):
    """Bitwise equal arrays or tensors, NaN equal to NaN, dtypes alike."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_state(got, want):
    for f in tmix.EMState._fields:
        _same(getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy())


def _hist_close(got, want):
    """NaN-padded histories: NaN alike, finite within rtol 1e-4, atol 1e-3."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-3)


# ---- ScanManifest ------------------------------------------------------

def _shard(seed):
    rng = np.random.default_rng(seed)
    return {"s": rng.random((4, 5)).astype(np.float32),
            "t": rng.integers(0, 99, (4, 5)).astype(np.int32),
            "k": rng.integers(0, 7, (4, 5)).astype(np.int32),
            "gidx": np.arange(seed, seed + 3, dtype=np.int64),
            "ns": rng.integers(1000, 9000, 3).astype(np.int64)}


@pytest.mark.parametrize("writer,reader", [(tckpt, jckpt), (jckpt, tckpt)],
                         ids=["port-to-reference", "reference-to-port"])
def test_manifest_format_crosses_packages(tmp_path, writer, reader):
    """Each package's ``ScanManifest`` reads the other's directory: the
    completed set and every shard's arrays, bitwise."""
    root = str(tmp_path / "m")
    shards = {sid: _shard(sid) for sid in (0, 1, 3)}
    for sid, arrays in shards.items():
        writer.ScanManifest(root).record(sid, arrays)
    m = reader.ScanManifest(root)
    assert m.completed() == {0, 1, 3}
    for sid, arrays in shards.items():
        got = m.load_shard(sid)
        assert set(got) == set(arrays)
        for key in arrays:
            _same(got[key], arrays[key])
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
        "manifest.json", "shard_00000.npz", "shard_00001.npz", "shard_00003.npz"]


def test_manifest_partial_shard_never_marked(tmp_path):
    """A stray temp file of a shard a crash left is not a completed shard;
    ``run`` recomputes it (the reference's own test, on the port)."""
    m = tckpt.ScanManifest(str(tmp_path / "m"))
    m.record(0, {"x": np.arange(3)})
    (tmp_path / "m" / "shard_00001.npz.tmp.npz").write_bytes(b"garbage")
    assert m.completed() == {0}
    out = m.run([0, 1], lambda sid: {"x": np.arange(3) + sid})
    np.testing.assert_array_equal(out[1]["x"], np.arange(3) + 1)
    assert jckpt.ScanManifest(str(tmp_path / "m")).completed() == {0, 1}


def test_manifest_run_resumes_after_a_crash(tmp_path):
    """``run`` killed at shard 3 keeps 0-2; run again, it calls the work
    only for 3-5 and returns every shard as an unbroken run does."""
    data = {sid: np.random.default_rng(sid).random(8).astype(np.float32) for sid in range(6)}
    calls = []

    def work(sid):
        calls.append(sid)
        return {"scores": data[sid] * 2.0}

    ref = tckpt.ScanManifest(str(tmp_path / "ref")).run(range(6), work)

    def crashing(sid):
        if sid == 3:
            raise RuntimeError("crash")
        return work(sid)

    crash = tckpt.ScanManifest(str(tmp_path / "crash"))
    with pytest.raises(RuntimeError):
        crash.run(range(6), crashing)
    assert crash.completed() == {0, 1, 2}
    calls.clear()
    resumed = tckpt.ScanManifest(str(tmp_path / "crash")).run(range(6), work)
    assert calls == [3, 4, 5]
    for sid in range(6):
        _same(resumed[sid]["scores"], ref[sid]["scores"])


# ---- bank and EM-state checkpoints --------------------------------------

@pytest.mark.parametrize("parts", [False, True], ids=["plain", "parts"])
def test_bank_checkpoint_round_trip(tmp_path, parts):
    """``save_bank`` / ``restore_bank``: the arrays bitwise, the labels in
    their order, a parts bank with its dictionary; the directory's
    ``.npz`` loads in the reference's ``TemplateBank.load`` alike."""
    rng = np.random.default_rng(0)
    tpl = np.clip(rng.random((3, 5, 4, 8)), 0.01, 0.99).astype(np.float32)
    bg = np.clip(rng.random((4, 8)), 0.01, 0.99).astype(np.float32)
    dic = rng.random((6, 3, 3, 8)).astype(np.float32) if parts else None
    labels = ["iy", "aa", "iy"]
    bank = TemplateBank(torch.from_numpy(tpl), torch.from_numpy(bg), labels,
                        None if dic is None else torch.from_numpy(dic))
    path = str(tmp_path / "bank")
    tckpt.save_bank(path, bank)
    got = tckpt.restore_bank(path, device="cpu")
    assert got.labels == labels
    _same(got.templates.numpy(), tpl)
    _same(got.background.numpy(), bg)
    if parts:
        _same(got.parts.numpy(), dic)
    else:
        assert got.parts is None
    j = JBank.load(str(tmp_path / "bank" / tckpt.BANK_FILE))
    assert j.labels == labels
    _same(np.asarray(j.templates), tpl)
    assert (j.parts is None) == (not parts)


def test_em_state_round_trip(tmp_path):
    """``save_em_state`` / ``restore_em_state``: every field bitwise, its
    dtype and shape kept (NaN history slots included)."""
    rng = np.random.default_rng(1)
    hist = np.full(20, np.nan, np.float32)
    hist[:7] = rng.random(7)
    state = tmix.EMState(
        iteration=torch.tensor(7, dtype=torch.int32),
        responsibilities=torch.from_numpy(rng.random((10, 4)).astype(np.float32)),
        means=torch.from_numpy(rng.random((4, 16)).astype(np.float32)),
        weights=torch.full((4,), 0.25),
        log_likelihood=torch.tensor(-12.5),
        done=torch.tensor(False),
        history=torch.from_numpy(hist),
    )
    path = str(tmp_path / "em")
    tckpt.save_em_state(path, state)
    _same_state(tckpt.restore_em_state(path, device="cpu"), state)


# ---- run_em_checkpointed ------------------------------------------------

def _em_data(seed=3, n=40, d=24):
    rng = np.random.default_rng(seed)
    protos = rng.random((3, d)) < 0.4
    return (protos[rng.integers(0, 3, n)] ^ (rng.random((n, d)) < 0.1)).astype(np.float32)


@pytest.mark.parametrize("tol,iters,chunk", [(0.0, 8, 3), (1e-4, 40, 4), (1e-3, 30, 1)])
def test_em_checkpointed_killed_and_resumed_is_bitwise(tmp_path, monkeypatch, tol, iters,
                                                       chunk):
    """Killed after its first chunk (the state saved, the second chunk
    never returns), then called again with the same arguments: bitwise
    equal to an unbroken run, and to ``bernoulli_mixture_em``."""
    x = torch.from_numpy(_em_data())
    resp = init_responsibilities(x.shape[0], 3, seed=0)
    kw = dict(num_iters=iters, chunk_iters=chunk, tol=tol)
    whole = tckpt.run_em_checkpointed(x, resp, str(tmp_path / "whole"), **kw)
    real = tckpt.resume_fit
    chunks = {"n": 0}

    def dies_after_one(*a, **k):
        chunks["n"] += 1
        if chunks["n"] > 1:
            raise RuntimeError("killed")
        return real(*a, **k)

    monkeypatch.setattr(tckpt, "resume_fit", dies_after_one)
    path = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="killed"):
        tckpt.run_em_checkpointed(x, resp, path, **kw)
    assert int(tckpt.restore_em_state(path, "cpu").iteration) == chunk
    monkeypatch.setattr(tckpt, "resume_fit", real)
    resumed = tckpt.run_em_checkpointed(x, resp, path, **kw)
    _same_state(resumed, whole)
    _same_state(whole, tmix.bernoulli_mixture_em(x, resp, num_iters=iters, tol=tol))
    assert int(whole.iteration) > chunk


@pytest.mark.parametrize("runs", [
    [dict(num_iters=3, chunk_iters=3, tol=1e-4), dict(num_iters=40, chunk_iters=3, tol=1e-4)],
    [dict(num_iters=40, chunk_iters=7, tol=1e-3)],
], ids=["crash-then-resume", "unbroken"])
def test_em_checkpointed_matches_reference(tmp_path, runs):
    """Against the reference's ``run_em_checkpointed``, with the reference
    test's crash (a run of 3 iterations, then the full budget from the
    same directory) and unbroken: the same iteration count and stop,
    means within rtol 1e-4 / atol 1e-5, histories within rtol 1e-4 /
    atol 1e-3."""
    x = _em_data()
    resp = init_responsibilities(x.shape[0], 3, seed=0)
    for kw in runs:
        got = tckpt.run_em_checkpointed(torch.from_numpy(x), resp, str(tmp_path / "t"), **kw)
        want = jckpt.run_em_checkpointed(x, resp, str(tmp_path / "j"), **kw)
        assert int(got.iteration) == int(want.iteration)
        assert bool(got.done) == bool(want.done)
        np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                                   rtol=1e-4, atol=1e-5)
        _hist_close(got.history.numpy(), np.asarray(want.history))
    assert bool(got.done) and int(got.iteration) < 40


def test_em_checkpointed_tol0_against_reference(tmp_path):
    """The reference test's own case, tol 0 (3 iterations, then 8 from
    the same directory).  Here the stop test ``improvement < 0`` decides
    on the last bits of an f32 sum at the fixed point: the port's mean
    log-likelihood falls by ~1.5e-6 at iteration 7 and its fit stops
    there, the reference's runs all 8 (ROADMAP.md Queue 3, "EM at tol
    0").  Held: the history over the iterations both ran and the means,
    within the classes above; the history never falls by more than
    1e-3."""
    x = _em_data()
    resp = init_responsibilities(x.shape[0], 3, seed=0)
    for kw in (dict(num_iters=3, chunk_iters=3, tol=0.0),
               dict(num_iters=8, chunk_iters=3, tol=0.0)):
        got = tckpt.run_em_checkpointed(torch.from_numpy(x), resp, str(tmp_path / "t"), **kw)
        want = jckpt.run_em_checkpointed(x, resp, str(tmp_path / "j"), **kw)
    common = min(int(got.iteration), int(want.iteration), 3)
    assert (int(got.iteration), int(want.iteration)) == (7, 8)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=1e-4,
                               atol=1e-5)
    hg, hw = got.history.numpy(), np.asarray(want.history)
    assert hg.shape == hw.shape == (3,)           # the first run's history length
    np.testing.assert_allclose(hg[:common], hw[:common], rtol=1e-4, atol=1e-3)
    direct = tmix.bernoulli_mixture_em(torch.from_numpy(x), resp, num_iters=8, tol=0.0)
    assert np.all(np.diff(direct.history.numpy()[: int(direct.iteration)]) >= -1e-3)


def test_em_checkpointed_unreadable_directory_starts_fresh(tmp_path):
    """A directory that holds no readable state starts EM from zero, as
    an empty one does, as in the reference."""
    x = torch.from_numpy(_em_data())
    resp = init_responsibilities(x.shape[0], 3, seed=0)
    fresh = tckpt.run_em_checkpointed(x, resp, str(tmp_path / "fresh"), num_iters=6,
                                      chunk_iters=4, tol=0.0)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / tckpt.EM_FILE).write_bytes(b"not an npz")
    got = tckpt.run_em_checkpointed(x, resp, str(bad), num_iters=6, chunk_iters=4, tol=0.0)
    _same_state(got, fresh)
    assert int(tckpt.restore_em_state(str(bad), "cpu").iteration) == 6
