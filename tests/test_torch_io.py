"""The port's ``io`` package (WAV and NIST SPHERE, the native reader, the
synthetic TIMIT tree, ``TimitCorpus``) against the JAX reference's
``io``, bitwise: samples, headers, files and records.  The reference's
``io`` is jax-free; both packages share ``native/libtsr_audio.so``."""

from __future__ import annotations

import dataclasses
import filecmp
import os
import wave

import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.io import audio as jaudio
from template_speech_recognition_tpu.io import corpus as jcorpus
from template_speech_recognition_tpu.io import fixtures as jfixtures
from template_speech_recognition_tpu.io import native as jnative
from template_speech_recognition_tpu_torch.io import audio as taudio
from template_speech_recognition_tpu_torch.io import corpus as tcorpus
from template_speech_recognition_tpu_torch.io import fixtures as tfixtures
from template_speech_recognition_tpu_torch.io import native as tnative
from template_speech_recognition_tpu_torch.ops import framing as tframing

needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="native library unavailable")


def _tone(n=5000, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def _same(a, b):
    (xa, ra), (xb, rb) = a, b
    assert ra == rb and xa.dtype == xb.dtype == np.float32
    np.testing.assert_array_equal(xa, xb)


def dataclass_tuple(x):
    return dataclasses.astuple(x)


def _sphere(path, body: str, payload: bytes):
    header = (b"NIST_1A\n   1024\n" + body.encode()).ljust(1024, b" ")
    with open(path, "wb") as f:
        f.write(header + payload)


@pytest.mark.parametrize("kind", ["wav", "sphere"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_writers_and_readers_cross(tmp_path, kind, writer):
    """Either package writes, both read: the files are byte-identical and
    the samples bitwise equal (int16 / 32768 as float32)."""
    x = _tone(seed=1 if kind == "sphere" else 0)
    mods = {"port": taudio, "reference": jaudio}
    paths = {}
    for name, mod in mods.items():
        paths[name] = str(tmp_path / f"{name}.{kind}")
        getattr(mod, f"write_{kind}")(paths[name], x, 16000)
    assert filecmp.cmp(paths["port"], paths["reference"], shallow=False)
    p = paths[writer]
    read = f"read_{kind}"
    _same(getattr(taudio, read)(p), getattr(jaudio, read)(p))
    _same(taudio.read_audio(p), jaudio.read_audio(p))
    y, sr = taudio.read_audio(p)
    assert sr == 16000 and len(y) == len(x)
    np.testing.assert_allclose(y, x, atol=1.0 / 32768)
    assert taudio.read_audio_info(p) == jaudio.read_audio_info(p) == (len(x), 16000)


def test_read_audio_sniffs_container(tmp_path):
    x = _tone()
    wav_p, sph_p = str(tmp_path / "w.wav"), str(tmp_path / "s.wav")  # SPHERE behind .wav
    taudio.write_wav(wav_p, x, 16000)
    taudio.write_sphere(sph_p, x, 16000)
    for p in (wav_p, sph_p):
        _same(taudio.read_audio(p), jaudio.read_audio(p))
    with open(sph_p, "rb") as f:
        assert f.read(7) == b"NIST_1A"


def test_sphere_handcrafted_header(tmp_path):
    """A header the writer did not write."""
    p = str(tmp_path / "h.sph")
    _sphere(p, "sample_rate -i 8000\nchannel_count -i 1\nsample_n_bytes -i 2\n"
               "sample_count -i 10\nsample_byte_format -s2 01\n"
               "sample_coding -s3 pcm\nend_head\n",
            (np.arange(-5, 5, dtype="<i2") * 1000).tobytes())
    y, sr = taudio.read_sphere(p)
    assert sr == 8000 and len(y) == 10 and y[0] == np.float32(-5000 / 32768)
    _same((y, sr), jaudio.read_sphere(p))
    assert taudio.read_audio_info(p) == jaudio.read_audio_info(p) == (10, 8000)


@pytest.mark.parametrize("case", ["big_endian", "stereo", "one_byte", "no_count"])
def test_sphere_variants_match_reference(tmp_path, case):
    """Big-endian PCM16 (TIMIT's "10"), two interleaved channels, 8-bit
    offset PCM, and a header without ``sample_count``: samples and the
    header-only info equal the reference's."""
    x = _tone(n=1000, seed=3)
    pcm = np.round(x * 32767.0)
    fields = {"sample_rate": "-i 16000", "channel_count": "-i 1", "sample_n_bytes": "-i 2",
              "sample_count": f"-i {len(pcm)}", "sample_byte_format": "-s2 01",
              "sample_coding": "-s3 pcm"}
    payload = pcm.astype("<i2").tobytes()
    if case == "big_endian":
        fields["sample_byte_format"] = "-s2 10"
        payload = pcm.astype(">i2").tobytes()
    elif case == "stereo":
        fields["channel_count"] = "-i 2"
        fields["sample_count"] = f"-i {len(pcm)}"
    elif case == "one_byte":
        fields["sample_n_bytes"] = "-i 1"
        payload = (np.round(x * 127) + 128).astype(np.uint8).tobytes()
    else:
        del fields["sample_count"]
    body = "".join(f"{k} {v}\n" for k, v in fields.items()) + "end_head\n"
    p = str(tmp_path / f"{case}.sph")
    _sphere(p, body, payload)
    _same(taudio.read_sphere(p), jaudio.read_sphere(p))
    _same(taudio.read_audio(p), jaudio.read_audio(p))
    assert taudio.read_audio_info(p) == jaudio.read_audio_info(p)
    assert taudio.read_audio_info(p)[0] == len(taudio.read_sphere(p)[0])


@pytest.mark.parametrize("case", ["wav_width3", "sphere_shorten", "sphere_width4",
                                  "not_sphere", "header_too_long", "info_shorten"])
def test_errors_match_reference(tmp_path, case):
    """The reference's refusals, with its error types."""
    p = str(tmp_path / "bad.bin")
    want = NotImplementedError
    body = ("sample_rate -i 16000\nchannel_count -i 1\nsample_n_bytes -i 2\n"
            "sample_count -i 4\nsample_byte_format -s2 01\nsample_coding -s3 pcm\n"
            "end_head\n")
    if case == "wav_width3":
        with wave.open(p, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(3)
            f.setframerate(16000)
            f.writeframes(bytes(12))
        calls = ("read_wav", "read_audio")
    elif case in ("sphere_shorten", "info_shorten"):
        _sphere(p, body.replace("-s3 pcm", "-s7 shorten"), bytes(8))
        calls = ("read_audio_info",) if case == "info_shorten" else ("read_sphere", "read_audio")
    elif case == "sphere_width4":
        _sphere(p, body.replace("sample_n_bytes -i 2", "sample_n_bytes -i 4"), bytes(16))
        calls = ("read_sphere", "read_audio")
    elif case == "not_sphere":
        with open(p, "wb") as f:
            f.write(b"RIFF" + bytes(100))
        want, calls = ValueError, ("read_sphere",)
    else:
        x = np.zeros(4, np.float32)
        for mod in (taudio, jaudio):
            with pytest.raises(ValueError):
                mod.write_sphere(p, x, 10 ** 1000)
        return
    for name in calls:
        for mod in (taudio, jaudio):
            with pytest.raises(want):
                getattr(mod, name)(p)


@needs_native
@pytest.mark.parametrize("kind", ["wav", "sphere"])
def test_native_read_audio_matches_python_and_reference(tmp_path, kind):
    x = _tone(seed=4)
    p = str(tmp_path / f"a.{kind}")
    getattr(taudio, f"write_{kind}")(p, x, 16000)
    got = tnative.read_audio(p)
    _same(got, taudio.read_audio(p))
    _same(got, jnative.read_audio(p))
    _same(tcorpus.read_audio(p), jcorpus.read_audio(p))


@needs_native
@pytest.mark.parametrize("n,fl,hop", [(4000, 400, 160), (4321, 400, 160), (499, 37, 13)])
def test_native_read_frames_matches_framing(tmp_path, n, fl, hop):
    x = _tone(n=n, seed=2)
    p = str(tmp_path / "b.wav")
    taudio.write_wav(p, x, 16000)
    decoded, _ = taudio.read_wav(p)
    y = tframing.preemphasize(torch.from_numpy(decoded), 0.95)
    want = tframing.frame_signal(y, fl, hop).numpy()
    got, sr = tnative.read_frames(p, 0.95, fl, hop)
    assert sr == 16000 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ref, _ = jnative.read_frames(p, 0.95, fl, hop)
    np.testing.assert_array_equal(got, ref)


@needs_native
def test_native_read_batch(tmp_path):
    paths, xs = [], []
    for i in range(6):
        p = str(tmp_path / f"u{i}.wav")
        (taudio.write_wav if i % 2 else taudio.write_sphere)(p, _tone(n=3000 + 100 * i, seed=i),
                                                           16000)
        paths.append(p)
        xs.append(taudio.read_audio(p)[0])
    arena, counts, rates = tnative.read_batch(paths, max_samples=4096, num_threads=3)
    ref = jnative.read_batch(paths, max_samples=4096, num_threads=3)
    for a, b in zip((arena, counts, rates), ref):
        np.testing.assert_array_equal(a, b)
    assert arena.shape == (6, 4096)
    for i, x in enumerate(xs):
        assert counts[i] == len(x) and rates[i] == 16000
        np.testing.assert_array_equal(arena[i, : len(x)], x)
        assert not arena[i, len(x):].any()


@needs_native
def test_native_error_paths(tmp_path):
    garbage = tmp_path / "bad.wav"
    garbage.write_bytes(b"not audio at all")
    for p in (str(tmp_path / "nope.wav"), str(garbage)):
        with pytest.raises(IOError):
            tnative.read_audio(p)


def test_native_loader_finds_the_shared_library():
    """The port's loader points at the library the reference loads (the
    repo's ``native/``), and never rebuilds one that exists."""
    assert tnative._SO_PATH == jnative._SO_PATH
    assert tnative._NATIVE_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


def _tree_files(root):
    out = []
    for dirpath, _dirs, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("args", [dict(num_train=3, num_test=2, phones_per_utterance=4, seed=0),
                                  dict(num_train=2, num_test=3, phones_per_utterance=6, seed=5,
                                       sample_rate=8000)])
def test_synthetic_timit_tree_is_byte_identical(tmp_path, args):
    tfixtures.write_synthetic_timit(str(tmp_path / "port"), **args)
    jfixtures.write_synthetic_timit(str(tmp_path / "ref"), **args)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "ref")
    assert len(files) == 2 * (args["num_train"] + args["num_test"])
    for rel in files:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "ref" / rel, shallow=False), rel


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("timit"))
    jfixtures.write_synthetic_timit(root, num_train=3, num_test=2, phones_per_utterance=4,
                                    seed=0)
    return root


def test_timit_corpus_matches_reference(tree):
    t, j = tcorpus.TimitCorpus(tree), jcorpus.TimitCorpus(tree)
    assert [dataclass_tuple(r) for r in t.records] == [dataclass_tuple(r) for r in j.records]
    assert len(t.records) == 5
    for split in ("TRAIN", "TEST", "train", "DEV"):
        assert [r.utt_id for r in t.split(split)] == [r.utt_id for r in j.split(split)]
    assert len(t.split("TRAIN")) == 3 and len(t.split("TEST")) == 2
    for rt, rj in zip(t.records, j.records):
        assert (rt.split, rt.dialect, rt.speaker) == (rj.split, rj.dialect, rj.speaker)
        _same(t.load_waveform(rt), j.load_waveform(rj))
        assert t.load_info(rt) == j.load_info(rj)
        assert t.load_info(rt)[0] == len(t.load_waveform(rt)[0])
        assert ([dataclass_tuple(s) for s in t.load_phones(rt)]
                == [dataclass_tuple(s) for s in j.load_phones(rj)])
    inv = t.phone_inventory()
    assert inv == j.phone_inventory() and "sil" in inv


@pytest.mark.parametrize("split", [None, "TRAIN", "TEST"])
def test_timit_corpus_spans_match_reference(tree, split):
    t, j = tcorpus.TimitCorpus(tree), jcorpus.TimitCorpus(tree)
    for phone in t.phone_inventory():
        occ_t, occ_j = t.occurrences(phone, split), j.occurrences(phone, split)
        assert ([(r.utt_id, dataclass_tuple(s)) for r, s in occ_t]
                == [(r.utt_id, dataclass_tuple(s)) for r, s in occ_j])
        ct, cj = t.exemplar_clips(phone, split), j.exemplar_clips(phone, split)
        assert len(ct) == len(cj) == len(occ_t)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a, b)
        for max_clips in (5, 64):
            bt = t.background_clips(phone, split, max_clips=max_clips)
            bj = j.background_clips(phone, split, max_clips=max_clips)
            assert len(bt) == len(bj) <= max_clips
            for a, b in zip(bt, bj):
                np.testing.assert_array_equal(a, b)


def test_timit_corpus_refuses_an_empty_tree(tmp_path):
    for mod in (tcorpus, jcorpus):
        with pytest.raises(FileNotFoundError):
            mod.TimitCorpus(str(tmp_path))
