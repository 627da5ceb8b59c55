"""The PyTorch port's masking, NMS and top-K against the JAX reference.

Decisions are held bitwise: scores, times and template ids, including
constructed ties (template ties go to the lowest id, time ties to the
earliest frame) and -inf slots.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from template_speech_recognition_tpu import scan as jscan
from template_speech_recognition_tpu.detect import nms as jnms
from template_speech_recognition_tpu.detect.scorer import masked_scores as jmasked
from template_speech_recognition_tpu_torch import scan as tscan
from template_speech_recognition_tpu_torch.detect import nms as tnms
from template_speech_recognition_tpu_torch.detect.scorer import (
    masked_scores as tmasked,
)


def _tied_scores(k=6, t=60, seed=0):
    """Scores on a coarse grid (many exact ties), with plateaus in time
    and duplicated template rows."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.standard_normal((k, t)) * 2) / 2
    s[1] = s[0]                        # template tie everywhere
    s[:, 10:14] = 3.0                  # a plateau over time
    s[:, 40] = s[:, 41] = 5.0          # an adjacent peak pair
    s[3, 50:] = -np.inf
    return s.astype(np.float32)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("radius", [0, 1, 3, 10])
def test_nms_mask_bitwise(radius):
    s = _tied_scores()
    got = tnms.nms_mask(torch.from_numpy(s), radius).numpy()
    want = np.asarray(jnms.nms_mask(jnp.asarray(s), radius))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("radius,top_k", [(0, 8), (2, 5), (3, 100)])
def test_top_detections_ties_bitwise(time_major, radius, top_k):
    s = _tied_scores()
    if time_major:
        s = np.ascontiguousarray(s.T)
    got = tnms.top_detections(torch.from_numpy(s), radius, top_k,
                              time_major=time_major)
    want = jnms.top_detections(jnp.asarray(s), radius, top_k,
                               time_major=time_major)
    _assert_same(got, want)


def test_masked_scores_bitwise():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((3, 40, 5)).astype(np.float32)      # time-major
    valid = np.asarray([40, 17, 0], np.int32)
    got = tmasked(torch.from_numpy(s), torch.from_numpy(valid), 8,
                  time_major=True).numpy()
    want = np.stack([
        np.asarray(jmasked(jnp.asarray(s[i]), jnp.int32(valid[i]), 8,
                           time_major=True))
        for i in range(3)
    ])
    np.testing.assert_array_equal(got, want)


def test_batched_top_detections_bitwise():
    """The scan's batched masking + NMS + top-K, time-major, with an
    all-padding row (valid 0)."""
    rng = np.random.default_rng(2)
    s = (np.round(rng.standard_normal((3, 64, 7)) * 2) / 2).astype(np.float32)
    valid = np.asarray([64, 30, 0], np.int32)
    got = tscan.batched_top_detections(
        torch.from_numpy(s), torch.from_numpy(valid), 8, 4, 12, time_major=True
    )
    want = jax.jit(
        jscan.batched_top_detections, static_argnums=(2, 3, 4, 5)
    )(jnp.asarray(s), jnp.asarray(valid), 8, 4, 12, True)
    _assert_same(got, want)
