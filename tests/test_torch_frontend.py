"""The PyTorch port's frontend against the JAX reference, on the CPU.

Kernel 1 (response planes) and kernel 2 (select + binarize + spread)
run their plain PyTorch versions here (CPU tensors); the reference runs
its Pallas kernels in interpret mode.  Inputs come from numpy with a
fixed seed and go to both as arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle as O
from template_speech_recognition_tpu.config import FrontendConfig as JFrontendConfig
from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.ops import edges as jedges
from template_speech_recognition_tpu.ops.frontend_pallas import (
    edge_response_planes_stacked_pallas,
)
from template_speech_recognition_tpu.ops.selbin_pallas import (
    select_binspread_pallas,
)
from template_speech_recognition_tpu_torch.config import FrontendConfig
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import edges as tedges
from template_speech_recognition_tpu_torch.ops.frontend_kernel import (
    edge_response_planes,
)
from template_speech_recognition_tpu_torch.ops.selbin_kernel import (
    select_binspread,
)

# nfft 256 -> F = 128 (the reference's fused kernels need F % 128 == 0)
NFFT = 256


def _utterances(n, seed=3, phones=6):
    corpus = O.make_synthetic_corpus(
        num_utterances=n, phones_per_utterance=phones, seed=seed
    )
    return [u.waveform for u in corpus.utterances]


def _padded(wavs, pad=None):
    pad = pad or max(len(w) for w in wavs)
    out = np.zeros((len(wavs), pad), np.float32)
    for i, w in enumerate(wavs):
        out[i, : min(len(w), pad)] = w[:pad]
    return out, np.asarray([min(len(w), pad) for w in wavs], np.int32)


def _frames(cfg, t_pad):
    """Windowed frames of real audio, [B*T_pad, frame_length]."""
    wavs, lens = _padded(_utterances(2), pad=cfg.frame_length + (t_pad - 1) * 160)
    frames = tplanes._windowed_frames(torch.from_numpy(wavs), cfg).numpy()
    return frames.reshape(-1, cfg.frame_length)


def test_windowed_frames_match_reference():
    cfg, jcfg = FrontendConfig(nfft=NFFT), JFrontendConfig(nfft=NFFT)
    wavs, _ = _padded(_utterances(2))
    got = tplanes._windowed_frames(torch.from_numpy(wavs), cfg).numpy()
    want = np.asarray(jplanes._windowed_frames(jnp.asarray(wavs), jcfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [0.3, 0.98])
def test_dual_ranks_match_reference(q):
    valid = np.asarray([0, 1, 7, 255, 3070], np.int32)
    got = tplanes._dual_ranks(torch.from_numpy(valid), 256, q).numpy()
    want = np.asarray(jplanes._dual_ranks(jnp.asarray(valid), 256, q))
    np.testing.assert_array_equal(got, want)


def well_conditioned(frames, nfft, floor=1e-2):
    """[N-1, F] mask of plane cells whose four spectrum inputs have a
    power of at least ``floor`` (float64): four decades above LOG_EPS,
    where the log no longer amplifies fp32 summation-order error."""
    from template_speech_recognition_tpu_torch.ops.dft import _dft_np

    c, s = (m.astype(np.float64) for m in _dft_np(frames.shape[1], nfft))
    x = frames.astype(np.float64)
    ok = ((x @ c) ** 2 + (x @ s) ** 2) >= floor
    f = nfft // 2
    return ok[:-1, :f] & ok[:-1, 1 : f + 1] & ok[1:, :f] & ok[1:, 1 : f + 1]


def test_response_planes_match_stacked_pallas():
    """Kernel 1's plain version vs the reference kernel in interpret
    mode.  Scaled error (max |error| / max |reference|) <= 1e-5 on the
    well-conditioned cells; everywhere within the reference's own
    fused-vs-unfused tolerance (rtol 1e-4, atol 1e-3): next to the
    LOG_EPS floor two fp32 summation orders differ by up to ~3e-4
    (both sides measured against float64 on this input).  The row past
    the last is garbage by contract in both and is left out."""
    cfg = FrontendConfig(nfft=NFFT)
    frames = _frames(cfg, t_pad=128)
    got = edge_response_planes(torch.from_numpy(frames), NFFT).numpy()
    want = np.asarray(edge_response_planes_stacked_pallas(
        jnp.asarray(frames), NFFT, interpret=True
    ))
    assert got.shape == want.shape == (4, frames.shape[0], NFFT // 2)
    got, want = got[:, :-1], want[:, :-1]
    ok = well_conditioned(frames, NFFT)
    assert ok.mean() > 0.5
    err = np.max(np.abs(got - want)[:, ok])
    assert err / np.max(np.abs(want)) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def _random_planes(b, p, t, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, b, t, f)).astype(np.float32)
    # heavy ties and signed zeros exercise rank ties and the +/-0 canon
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
    x[:, :, 5, :7] = -0.0
    return x


@pytest.mark.parametrize("q", [0.3, 0.98])
@pytest.mark.parametrize("rf,rt", [(0, 0), (1, 1), (2, 1)])
def test_select_binspread_bitwise(q, rf, rt):
    """Kernel 2's plain version vs select_binspread_pallas(interpret):
    map and keys bitwise, including an utterance with no valid row."""
    b, p, t, f = 4, 4, 256, 128
    planes = _random_planes(b, p, t, f)
    valid = np.asarray([t, t // 2, 7, 0], np.int32)
    need = np.array(jplanes._dual_ranks(jnp.asarray(valid), f, q))
    flat_j, keys_j = select_binspread_pallas(
        jnp.asarray(planes), jnp.asarray(need), jnp.asarray(valid), rf, rt,
        interpret=True,
    )
    flat_t, keys_t = select_binspread(
        torch.from_numpy(planes), torch.from_numpy(need),
        torch.from_numpy(valid), rf, rt,
    )
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(
        keys_t.numpy().astype(np.uint32), np.asarray(keys_j)
    )


def test_order_keys_round_trip():
    x = np.asarray([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    got = tedges.order_keys(torch.from_numpy(x)).numpy()
    want = np.asarray(jedges.order_keys(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    back = tedges.key_to_float(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))


def test_frontend_batch_flat_matches_reference():
    """End to end: the port's map (T_pad rows) agrees with the JAX CPU
    frontend (T - 1 rows) on every row below valid; rows past valid are
    False."""
    cfg, jcfg = FrontendConfig(nfft=NFFT), JFrontendConfig(nfft=NFFT)
    wavs, lens = _padded(_utterances(3, seed=5))
    fm = tplanes.frontend_batch_flat(
        torch.from_numpy(wavs), torch.from_numpy(lens), cfg
    )
    jfm = jplanes.frontend_batch_flat(jnp.asarray(wavs), jnp.asarray(lens), jcfg)
    valid = fm.valid_frames.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jfm.valid_frames))
    got, want = fm.binary.numpy(), np.asarray(jfm.binary)
    assert got.shape[1] % 128 == 0 and got.shape[1] >= want.shape[1]
    assert got.shape[2] == want.shape[2] == 8 * (NFFT // 2)
    agree = total = 0
    for i, v in enumerate(valid):
        agree += int(np.sum(got[i, :v] == want[i, :v]))
        total += got[i, :v].size
        assert not got[i, v:].any()
    assert agree / total >= 0.999


def test_cuda_default_without_gpu_raises():
    from template_speech_recognition_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


def test_layout_conversions_match_reference():
    from template_speech_recognition_tpu.ops import layout as jlayout
    from template_speech_recognition_tpu_torch.ops import layout as tlayout

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)   # [B, T, F', E]
    flat = tlayout.channels_to_flat(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jlayout.channels_to_flat(jnp.asarray(x))))
    back = tlayout.flat_to_channels(torch.from_numpy(flat), 7).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        tlayout.filters_to_flat(torch.from_numpy(x)).numpy(),
        np.asarray(jlayout.filters_to_flat(jnp.asarray(x))),
    )
