"""Kernel 2's cluster design in plain PyTorch against its definition and
the JAX reference, on the CPU.

``select_binspread_emulated`` replays the CUDA cluster variant's
schedule (16 row slices, slice histograms summed, four 8-bit digits,
level-1 candidates, packed-word frequency dilation, time halos read
from the neighbouring slice); it must give ``select_binspread_plain``'s
map and keys bit for bit, and both the reference kernel's
(``select_binspread_pallas`` in interpret mode, which takes T and F
multiples of 128).  Inputs come from numpy with fixed seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.ops.selbin_pallas import select_binspread_pallas
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import selbin_kernel as k2
from template_speech_recognition_tpu_torch.ops.edges import _dilate_axis


def _planes(p, b, t, f, seed=0):
    """Random planes with ties (the first third of the rows quantised to
    0.25) and a run of -0.0, as the frontend tests build them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, b, t, f)).astype(np.float32)
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
    x[:, :, min(5, t - 1), : min(7, f)] = -0.0
    return x


def _inputs(t, f, q, seed=0):
    """Four planes of four utterances: all rows valid, half, 7 and none;
    utterance 2's first rank is 0 and utterance 1's second rank lies past
    its valid cells."""
    planes = _planes(4, 4, t, f, seed)
    valid = np.asarray([t, t // 2, min(7, t), 0], np.int32)
    need = tplanes._dual_ranks(torch.from_numpy(valid), f, q).numpy().copy()
    need[2, 0] = 0
    need[1, 1] = int(valid[1]) * f + 5
    return planes, need, valid


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rt", [0, 1, 2])
@pytest.mark.parametrize("rf", [0, 1, 2])
@pytest.mark.parametrize(
    "t,f",
    [(256, 128), (200, 100), (37, 36), (5, 4)],
    ids=["T256-F128", "T200-F100", "T37-F36", "T5-F4"],
)
def test_emulation_matches_plain(t, f, rf, rt):
    """The cluster schedule against the plain version: T not a multiple
    of 16 (200, 37, 5: the last slices short or empty), F a multiple of
    4 but not of 32 (100, 36, 4: a partial last word), an utterance with
    no valid row, rank 0 and a rank past the valid count, ties and -0.0,
    both quantiles."""
    for q in (0.3, 0.98):
        planes, need, valid = _torch(*_inputs(t, f, q, seed=t + f))
        flat_e, keys_e = k2.select_binspread_emulated(planes, need, valid, rf, rt)
        flat_p, keys_p = k2.select_binspread_plain(planes, need, valid, rf, rt)
        assert torch.equal(flat_e, flat_p)
        assert torch.equal(keys_e, keys_p)


@pytest.mark.parametrize(
    "t_data,rf,rt",
    [(128, 0, 0), (128, 1, 1), (128, 2, 2), (256, 0, 2), (256, 2, 0), (200, 1, 2)],
)
def test_emulation_matches_pallas(t_data, rf, rt):
    """The cluster schedule against the reference kernel in interpret
    mode, map and keys bitwise.  The reference takes T and F multiples of
    128, so T = 200 reaches it padded to 256 rows past valid (they are
    neither counted nor set, and a row past T is out of the time halo in
    both); F not a multiple of 32 is held against the plain version
    only (test_emulation_matches_plain)."""
    f = 128
    planes, need, valid = _inputs(t_data, f, 0.98, seed=7 + t_data)
    t_pad = -(-t_data // 128) * 128
    padded = np.zeros((4, 4, t_pad, f), np.float32)
    padded[:, :, :t_data] = planes
    flat_j, keys_j = select_binspread_pallas(
        jnp.asarray(padded), jnp.asarray(need), jnp.asarray(valid), rf, rt, interpret=True
    )
    flat_e, keys_e = k2.select_binspread_emulated(*_torch(planes, need, valid), rf, rt)
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(flat_j)[:, :t_data])
    np.testing.assert_array_equal(keys_e.numpy().astype(np.uint32), np.asarray(keys_j))


def test_pallas_ranks_match_port():
    """The ranks the reference's frontend computes are the port's (the
    inputs of the tests above)."""
    valid = np.asarray([256, 128, 7, 0], np.int32)
    got = tplanes._dual_ranks(torch.from_numpy(valid), 128, 0.98).numpy()
    want = np.asarray(jplanes._dual_ranks(jnp.asarray(valid), 128, 0.98))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [0, 1, 2, 31, 32, 33])
@pytest.mark.parametrize("f", [36, 100, 128])
def test_packed_dilation_matches_dilate_axis(f, radius):
    """Frequency dilation on packed 32-bit words (the kernel's word shifts
    with carries across words) against dilation of the cells."""
    rng = np.random.default_rng(f * 100 + radius)
    cells = torch.from_numpy(rng.random((5, f)) < 0.05)
    w = -(-f // 32)
    padded = torch.nn.functional.pad(cells, (0, 32 * w - f)).reshape(5, w, 32)
    weights = torch.ones(32, dtype=torch.int64) << torch.arange(32)
    words = (padded.to(torch.int64) * weights).sum(-1)
    got = (k2._dilate_words(words, radius)[..., None] >> torch.arange(32)) & 1
    got = got.reshape(5, 32 * w)[:, :f].to(torch.bool)
    assert torch.equal(got, _dilate_axis(cells, radius, 1))


@pytest.mark.parametrize(
    "t,f,variant",
    [
        (3072, 256, "cluster"),        # the scan's T_pad for 30 s utterances
        (3264, 256, "cluster"),        # the capacity at F = 256
        (3265, 256, "multipass"),      # one row past it
        (5, 4, "cluster"),
        (100, 1024, "cluster"),
        (100, 1028, "multipass"),      # a row's words past one warp's lanes
        (40000, 64, "multipass"),
    ],
)
def test_route_reads_the_shape(t, f, variant):
    """The variant is chosen from (T, F) alone, by the shared memory a CTA
    of the cluster variant needs."""
    assert k2.route(t, f) == variant
    need = k2.cluster_need_bytes(t, f)
    assert (need <= k2.MAX_SMEM and f <= k2.MAX_CLUSTER_F) == (variant == "cluster")


def test_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper is the plain version (the card's
    variants are checked by chip_smoke.py)."""
    planes, need, valid = _torch(*_inputs(37, 36, 0.98))
    got = k2.select_binspread(planes, need, valid, 1, 1)
    want = k2.select_binspread_plain(planes, need, valid, 1, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64
