"""The port's direct scorers (``detect/scorer.py``), the correlation
kernel's plain version and ``TemplateBank.llr_quantized`` against the
JAX reference and the NumPy oracle, on the CPU.  Inputs come from
seeded numpy; the reference's Pallas kernel runs in interpret mode."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import oracle as O
from template_speech_recognition_tpu import config as JC
from template_speech_recognition_tpu.detect import scorer as js
from template_speech_recognition_tpu.ops.correlation_pallas import (
    correlation_scores_pallas,
    correlation_scores_reference,
)
from template_speech_recognition_tpu.pipeline import SyntheticAdapter, train_bank
from template_speech_recognition_tpu_torch.convert import bank_from_numpy
from template_speech_recognition_tpu_torch.detect import scorer as ts
from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops import correlation_kernel as kc


def _rand(t, d, k, length, seed=0):
    rng = np.random.default_rng(seed)
    feats = (rng.random((t, d)) < 0.2).astype(np.float32)
    w = rng.standard_normal((k, length, d)).astype(np.float32)
    c = rng.standard_normal((k,)).astype(np.float32)
    return feats, w, c


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("t,d,k,length", [(256, 128, 128, 16), (256, 256, 128, 9),
                                          (256, 128, 128, 32)])
def test_correlation_plain_matches_pallas_interpret(t, d, k, length):
    """The plain version against the TPU kernel (interpret mode) at the
    shapes of tests/test_correlation_pallas.py, on the valid region
    t < T - L + 1 (the kernel's clamped tail is not reproduced), rtol
    and atol 1e-4 as there."""
    feats, w, c = _rand(t, d, k, length, seed=length)
    want = np.asarray(correlation_scores_pallas(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(c),
        block_k=128, block_t=128, block_d=128, interpret=True,
    ))
    got = kc.correlation_scores_plain(*_t(feats[None], w, c))[0].numpy()
    assert got.shape == (k, t - length + 1)
    np.testing.assert_allclose(got, want[:, : t - length + 1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,d,k,length", [(77, 40, 3, 9), (50, 504, 5, 48),
                                          (31, 8, 2, 1), (12, 16, 4, 12)])
def test_correlation_plain_matches_reference_ragged(t, d, k, length):
    """Shapes the port takes unpadded (T not a multiple of a tile,
    K = 3, D = 40 and 504, L = 1 and L = T) against the reference's jnp
    twin, rtol and atol 1e-4; two utterances in one batch score as each
    alone."""
    feats, w, c = _rand(t, d, k, length, seed=t)
    feats2, _, _ = _rand(t, d, k, length, seed=t + 1)
    want = np.asarray(correlation_scores_reference(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(c)))[:, : t - length + 1]
    got = kc.correlation_scores_plain(*_t(np.stack([feats, feats2]), w, c)).numpy()
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    alone = kc.correlation_scores_plain(*_t(feats2[None], w, c))[0].numpy()
    np.testing.assert_array_equal(got[1], alone)


def test_correlation_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper is its plain version and counts no
    launch; CPU and non-CPU tensors together are refused."""
    feats, w, c = _t(*_rand(40, 16, 3, 5))
    _cuda.reset_launches()
    got = kc.correlation_scores(feats[None].to(torch.bfloat16), w.to(torch.bfloat16), c)
    want = kc.correlation_scores_plain(feats[None].to(torch.bfloat16),
                                       w.to(torch.bfloat16), c)
    assert torch.equal(got, want)
    assert _cuda.launch_counts() == {}
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        kc.correlation_scores(feats[None], w.to("meta"), c)


# (B, T, D, K, L) for the kernel's schedule: D below, across and on
# 64-column chunks; T'' = T - L + 1 not a multiple of the 192-start tile
# (two t-tiles at T'' 242, 200 and 252); K = 1, 3, 5 and 129 (two
# template tiles); L = 1, 9, 48 and L = T; B = 1, 2, 3, whose last
# utterance (B > 1) is all zero and scores exactly c
TILED_CASES = [(1, 77, 40, 3, 9), (3, 250, 504, 129, 9), (1, 60, 2048, 1, 9),
               (2, 48, 64, 5, 48), (1, 200, 504, 3, 1), (3, 230, 40, 1, 48),
               (1, 260, 2048, 129, 9), (2, 31, 8, 2, 31)]


@pytest.fixture(scope="module", params=TILED_CASES,
                ids=lambda c: "B{}-T{}-D{}-K{}-L{}".format(*c))
def tiled(request):
    """A case, its seeded binary maps (the last utterance zeroed when
    B > 1), a normal bank, and the schedule's scores."""
    case = request.param
    b, t, d, k, length = case
    rng = np.random.default_rng(sum(case))
    feats = (rng.random((b, t, d)) < 0.2).astype(np.float32)
    if b > 1:
        feats[-1] = 0
    w = rng.standard_normal((k, length, d)).astype(np.float32)
    c = rng.standard_normal((k,)).astype(np.float32)
    return case, feats, w, c, kc.correlation_scores_tiled(*_t(feats, w, c)).numpy()


def test_correlation_tiled_matches_plain(tiled):
    """The kernel's tile schedule (zero-filled partial d-chunk, rows past
    T, templates past K, starts past T'' dropped) against the plain
    version within 1e-5 x max|plain| (both sum the same exact products in
    float32, in other orders); an all-zero utterance scores c exactly."""
    (b, t, _, k, length), feats, w, c, got = tiled
    want = kc.correlation_scores_plain(*_t(feats, w, c)).numpy()
    assert got.shape == want.shape == (b, k, t - length + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if b > 1:
        np.testing.assert_array_equal(got[-1], np.broadcast_to(c[:, None], got[-1].shape))


def test_correlation_tiled_matches_reference(tiled):
    """The schedule against the reference on the valid region t < T'':
    its jnp twin for every utterance and its Pallas kernel in interpret
    mode (one block over the whole shape, which interpret mode takes at
    any size) for the first, within 1e-5 x max|reference|."""
    (b, t, d, k, length), feats, w, c, got = tiled
    tv = t - length + 1
    for i in range(b):
        want = np.asarray(correlation_scores_reference(
            jnp.asarray(feats[i]), jnp.asarray(w), jnp.asarray(c)))[:, :tv]
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5 * np.abs(want).max())
    want = np.asarray(correlation_scores_pallas(
        jnp.asarray(feats[0]), jnp.asarray(w), jnp.asarray(c),
        block_k=k, block_t=t, block_d=d, interpret=True))[:, :tv]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5 * np.abs(want).max())


def _filters(seed, k=6, length=9, f=5, e=8, t=140):
    rng = np.random.default_rng(seed)
    feats = rng.random((t, f, e)) < 0.3
    w = rng.standard_normal((k, length, f, e)).astype(np.float32)
    c = rng.standard_normal(k).astype(np.float32)
    return feats, w, c


@pytest.mark.parametrize("flat", [False, True])
def test_sliding_scores_match_reference(flat):
    """f32 ``sliding_scores`` in both layouts (channels-minor [T', F, E]
    and pre-flattened [T', D]) against the reference, rtol 1e-5."""
    feats, w, c = _filters(1)
    if flat:
        feats, w = feats.reshape(feats.shape[0], -1), w.reshape(w.shape[0], w.shape[1], -1)
    want = np.asarray(js.sliding_scores(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(c)))
    got = ts.sliding_scores(*_t(feats, w, c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sliding_scores_batch_matches_reference():
    """The batched conv over two utterances, rtol 1e-5, and each row
    the per-utterance scores up to f32 summation order (1e-5)."""
    feats, w, c = _filters(2)
    feats2, _, _ = _filters(3)
    stack = np.stack([feats, feats2])
    want = np.asarray(js.sliding_scores_batch(jnp.asarray(stack), jnp.asarray(w),
                                              jnp.asarray(c)))
    got = ts.sliding_scores_batch(*_t(stack, w, c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], ts.sliding_scores(*_t(feats2, w, c)).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_t", [32, 100, 512])
def test_sliding_scores_blockwise_matches_reference(block_t):
    """Chunks with the L-1 halo: equal to the reference's blockwise scan
    (rtol 1e-5) and to the whole-utterance conv; a halo wider than the
    block raises as in the reference."""
    feats, w, c = _filters(4)
    want = np.asarray(js.sliding_scores_blockwise(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(c), block_t=block_t))
    got = ts.sliding_scores_blockwise(*_t(feats, w, c), block_t=block_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ts.sliding_scores(*_t(feats, w, c)).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="halo"):
        ts.sliding_scores_blockwise(*_t(feats, w, c), block_t=4)


@pytest.mark.parametrize("case", ["small", "wraps"])
def test_sliding_scores_int_bitwise(case):
    """int32 scores bitwise equal to the reference and to the oracle;
    ``wraps`` draws weights across the whole int32 range, so sums pass
    2**31 and wrap."""
    rng = np.random.default_rng(5)
    feats = rng.random((90, 5, 8)) < 0.4
    if case == "small":
        w = rng.integers(-3000, 3000, (6, 9, 5, 8)).astype(np.int32)
        c = rng.integers(-10**5, 10**5, 6).astype(np.int32)
    else:
        w = rng.integers(-2**31, 2**31, (6, 9, 5, 8), dtype=np.int64).astype(np.int32)
        c = rng.integers(-2**31, 2**31, 6, dtype=np.int64).astype(np.int32)
    oracle = O.sliding_score_int(feats, w, c)
    want = np.asarray(js.sliding_scores_int(jnp.asarray(feats), jnp.asarray(w),
                                            jnp.asarray(c)))
    got = ts.sliding_scores_int(*_t(feats, w, c)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(got, oracle)
    if case == "wraps":
        exact = np.einsum("tlfe,klfe->kt",
                          np.lib.stride_tricks.sliding_window_view(
                              feats.astype(np.int64), 9, axis=0).transpose(0, 3, 1, 2),
                          w.astype(np.int64)) + c.astype(np.int64)[:, None]
        assert np.abs(exact).max() >= 2**31


def test_sliding_scores_int_rejects_inexact_inputs():
    """Non-binary features, or more terms than float64 sums exactly."""
    w = torch.zeros((2, 3, 4), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="binary"):
        ts.sliding_scores_int(torch.full((10, 4), 2, dtype=torch.int32), w, c)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        ts.sliding_scores_int(torch.zeros((10, 2**21), dtype=torch.bool),
                              torch.zeros((1, 4, 2**21), dtype=torch.int32), c[:1])


@pytest.mark.parametrize("backend", ["fft", "conv", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_scores_backend_matches_reference(backend, dtype):
    """Each backend in the reference's [T', F, E] / [K, L, F, E]
    signature against the reference's same backend (its Pallas kernel in
    interpret mode): f32 at 1e-5 x max|score|; bf16 operands at 4e-3 x
    max|score|, the reference's bf16 class (the two frameworks round to
    bf16 at different places in the FFT scorer)."""
    feats, w, c = _filters(6, k=5, length=8, f=4, e=8, t=150)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(js.sliding_scores_backend(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(c), backend=backend,
        compute_dtype=jdt)).astype(np.float32)
    got = ts.sliding_scores_backend(*_t(feats, w, c), backend=backend,
                                    compute_dtype=tdt).float().numpy()
    assert got.shape == want.shape == (5, 150 - 8 + 1)
    tol = 1e-5 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown scoring backend"):
        ts.sliding_scores_backend(*_t(feats, w, c), backend="xla")


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_masked_scores_matches_reference(time_major, batched):
    rng = np.random.default_rng(7)
    shape = (3, 50, 4) if time_major else (3, 4, 50)
    scores = rng.standard_normal(shape if batched else shape[1:]).astype(np.float32)
    valid = np.asarray([40, 9, 0], np.int32) if batched else np.int32(40)
    if batched:
        want = np.stack([np.asarray(js.masked_scores(
            jnp.asarray(scores[i]), jnp.int32(valid[i]), 8, time_major=time_major))
            for i in range(3)])
    else:
        want = np.asarray(js.masked_scores(jnp.asarray(scores), jnp.int32(valid), 8,
                                           time_major=time_major))
    got = ts.masked_scores(torch.from_numpy(scores), torch.as_tensor(valid), 8,
                           time_major=time_major).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jbank4():
    synth = O.make_synthetic_corpus(num_utterances=7, phones_per_utterance=5, seed=3)
    cfg = JC.PipelineConfig(template=JC.TemplateConfig(num_components=2))
    return train_bank(SyntheticAdapter(synth), ["aa", "iy"], cfg)


def test_llr_quantized_bitwise(jbank4):
    """``round(llr * quant_scale)`` to int32 for W and c, bitwise equal
    to the reference on a trained bank (K = 4) at the config's scale.
    At scale 4096 W stays bitwise while c, a float32 sum of L*F*E =
    65,280 terms added in another order by each framework, may differ
    by the scale times a few ulp of |c| (ROADMAP.md Queue 3)."""
    bank = bank_from_numpy(np.asarray(jbank4.templates), np.asarray(jbank4.background),
                           jbank4.labels, device="cpu")
    scale = JC.DetectConfig().quant_scale
    (w, c), (jw, jc) = bank.llr_quantized(scale), jbank4.llr_quantized(scale)
    assert w.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    (w, c), (jw, jc) = bank.llr_quantized(4096), jbank4.llr_quantized(4096)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    ulp = np.spacing(np.abs(np.asarray(jbank4.llr()[1])))
    assert np.all(np.abs(c.numpy().astype(np.int64) - np.asarray(jc)) <= 4096 * 4 * ulp + 1)
