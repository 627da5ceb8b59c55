"""The port's classic per-map edge helpers (``ops.edges``:
``radix_kth_smallest``, ``quantile_threshold`` by both methods,
``binarize``, ``spread_binary``, ``mask_rows``) against the JAX
reference's, bitwise, at the cases of ``tests/test_radix_quantile.py``,
and the classic sequence against the port's planes path, as
``tests/test_planes_frontend.py`` holds the reference's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from template_speech_recognition_tpu.ops import edges as jedges
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import edges as tedges
from template_speech_recognition_tpu_torch.ops.layout import flat_to_channels


def _random_responses(rng, t, f, c):
    r = rng.standard_normal((t, f, c)).astype(np.float32)
    # ties, zeros of both signs, repeated rows
    r[t // 3] = r[0]
    r[:, f // 2, :] = 0.0
    r[1, :, :] = -0.0
    return r


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("method", ["radix", "sort"])
@pytest.mark.parametrize("q", [0.98, 0.5, 0.1, 0.999, 0.0])
def test_quantile_threshold_unmasked(q, method):
    r = _random_responses(np.random.default_rng(0), 37, 13, 8)
    want = jedges.quantile_threshold(jnp.asarray(r), q, method=method)
    got = tedges.quantile_threshold(torch.from_numpy(r), q, method=method)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the two methods select the same value (a zero's sign aside)
    other = tedges.quantile_threshold(torch.from_numpy(r), q,
                                      method="sort" if method == "radix" else "radix")
    np.testing.assert_array_equal(got.numpy(), other.numpy())


@pytest.mark.parametrize("method", ["radix", "sort"])
@pytest.mark.parametrize("valid", [1, 7, 36, 37])
def test_quantile_threshold_masked(valid, method):
    r = _random_responses(np.random.default_rng(1), 37, 13, 8)
    want = jedges.quantile_threshold(jnp.asarray(r), 0.98, jnp.int32(valid), method=method)
    got = tedges.quantile_threshold(torch.from_numpy(r), 0.98, valid, method=method)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_quantile_threshold_matches_oracle_partition():
    from oracle.frontend import quantile_threshold as oracle_tau

    r = _random_responses(np.random.default_rng(2), 64, 17, 8)
    got = tedges.quantile_threshold(torch.from_numpy(r), 0.98).numpy()
    np.testing.assert_array_equal(got, oracle_tau(r, 0.98))
    np.testing.assert_array_equal(
        _bits(got), _bits(jedges.quantile_threshold(jnp.asarray(r), 0.98)))


@pytest.mark.parametrize("k", [0, 1, 17, 38, 39])
def test_radix_kth_smallest_across_the_sign_bit(k):
    """uint32 keys held in int64, on both sides of 0x80000000, with
    masked keys (0xFFFFFFFF) past the valid ones; k a scalar and [C]."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2 ** 32, size=(48, 6), dtype=np.uint64).astype(np.uint32)
    keys[:4] = 0x7FFFFFFF
    keys[4:7] = 0x80000000
    keys[7:9] = 0
    keys[9, :] = keys[10, :]
    keys[40:] = 0xFFFFFFFF
    want = np.asarray(jedges.radix_kth_smallest(jnp.asarray(keys), jnp.int32(k)))
    got = tedges.radix_kth_smallest(torch.from_numpy(keys.astype(np.int64)), k).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, np.sort(keys[:40].astype(np.int64), axis=0)[k])
    ks = np.asarray([k, 0, 39, k // 2, 20, 5], np.int32)
    want_c = np.asarray(jedges.radix_kth_smallest(jnp.asarray(keys), jnp.asarray(ks)))
    got_c = tedges.radix_kth_smallest(torch.from_numpy(keys.astype(np.int64)),
                                      torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(got_c, want_c.astype(np.int64))


@pytest.mark.parametrize("rt,rf", [(0, 0), (1, 1), (2, 1), (1, 3)])
def test_spread_matches_reduce_window(rt, rf):
    rng = np.random.default_rng(4)
    b = rng.random((30, 14, 8)) < 0.1
    got = tedges.spread_binary(torch.from_numpy(b), rt, rf).numpy()
    want = lax.reduce_window(
        jnp.asarray(b).astype(jnp.int8), jnp.int8(0), lax.max,
        window_dimensions=(2 * rt + 1, 2 * rf + 1, 1), window_strides=(1, 1, 1),
        padding=((rt, rt), (rf, rf), (0, 0)),
    ).astype(jnp.bool_)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(jedges.spread_binary(jnp.asarray(b), rt, rf)))


@pytest.mark.parametrize("valid", [None, 0, 1, 20, 30])
def test_binarize_and_mask_rows_match_reference(valid):
    r = _random_responses(np.random.default_rng(5), 30, 11, 8)
    vj = None if valid is None else jnp.int32(valid)
    if valid == 0:
        # no valid cell: only the row mask is defined
        b = np.random.default_rng(6).random((30, 11, 8)) < 0.5
        got = tedges.mask_rows(torch.from_numpy(b), 0).numpy()
        np.testing.assert_array_equal(got, np.asarray(jedges.mask_rows(jnp.asarray(b), vj)))
        assert not got.any()
        return
    got = tedges.binarize(torch.from_numpy(r), 0.9, valid).numpy()
    np.testing.assert_array_equal(got, np.asarray(jedges.binarize(jnp.asarray(r), 0.9, vj)))
    if valid is not None:
        spread = tedges.spread_binary(torch.from_numpy(got), 1, 1)
        np.testing.assert_array_equal(
            tedges.mask_rows(spread, valid).numpy(),
            np.asarray(jedges.mask_rows(jedges.spread_binary(jnp.asarray(got), 1, 1), vj)))


def _stack_channels(planes):
    """[B, 4, T, F] -> [B, T, F, 8]: channel 2i is plane i, 2i+1 its
    negation."""
    return torch.stack([p for i in range(4) for p in (planes[:, i], -planes[:, i])], dim=-1)


@pytest.mark.parametrize("rt,rf", [(0, 0), (1, 1), (2, 1)])
def test_classic_sequence_matches_the_planes_path(rt, rf):
    """binarize -> spread -> mask_rows per map, on CPU tensors, gives the
    port's planes path's flat map (the order statistics by the radix
    select's plain version, binarize + spread's plain version)."""
    rng = np.random.default_rng(7)
    planes = torch.from_numpy(rng.standard_normal((2, 4, 30, 11)).astype(np.float32))
    vf = torch.tensor([30, 12], dtype=torch.int32)
    q = 0.9
    os_hi, os_lo = tplanes.plane_order_statistics(planes, vf, q)
    flat = tplanes.binarize_spread_flat(planes, os_hi, os_lo, vf, rt, rf)
    resp = _stack_channels(planes)
    for i in range(2):
        v = int(vf[i])
        want = tedges.mask_rows(
            tedges.spread_binary(tedges.binarize(resp[i], q, v), rt, rf), v)
        np.testing.assert_array_equal(flat_to_channels(flat[i], 11).numpy(), want.numpy())
        tau = tedges.quantile_threshold(resp[i], q, v)
        np.testing.assert_array_equal(tau[0::2].numpy(), os_hi[i].numpy())
        np.testing.assert_array_equal(tau[1::2].numpy(), (-os_lo[i]).numpy())
