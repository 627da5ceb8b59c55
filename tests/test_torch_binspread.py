"""Kernel 9's whole-row schedule (``ops.binspread_kernel``) against the
JAX reference and the plain versions, on the CPU.

``binarize_freqspread_bits`` emulates the CUDA kernel's word operations:
the 32-bit masks its ballots make, the frequency spread as funnel
shifts across word boundaries (F = 63 and 65: one word and a bit past
one; F = 513: seventeen), the time spread as an OR over halo rows, the
words ORed into each tile's bit string in flat order (``tile_rows``
rows a tile), and the 16 bits to 16 bytes of each 16-byte chunk, the
chunks aligned to the map's address (odd T puts tile starts 8 bytes
off).  It is held bitwise to
``binarize_freqspread_plain`` (which, with ``spread_time``, also applies
the reference's time dilation and row mask) and to the reference's
``binarize_spread_flat`` through its Pallas kernel in interpret mode
(``binarize_freqspread_pallas``; T a multiple of 128) and through XLA.
Inputs come from numpy with fixed seeds: rounded values and signed
zeros put cells on the thresholds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu.ops.binspread_pallas import binarize_freqspread_pallas
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import binspread_kernel as k9


def _problem(b, p, t, f, valid, seed):
    """Planes with ties and signed zeros, thresholds on cell values (one
    plane at +0.0 / -0.0), ragged valid frames."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, t, f)).astype(np.float32)
    x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
    x[:, :, 5, :7] = -0.0
    x[:, :, 6, :7] = 0.0
    hi = np.round(np.quantile(x, 0.8, axis=(2, 3)) * 4).astype(np.float32) / 4
    lo = np.round(np.quantile(x, 0.2, axis=(2, 3)) * 4).astype(np.float32) / 4
    hi[0, 0], lo[0, 0] = 0.0, -0.0
    return x, hi, lo, np.asarray(valid, np.int32)


def _torch(x, hi, lo, valid):
    return tuple(torch.from_numpy(a) for a in (x, hi, lo, valid))


@pytest.mark.parametrize("f", [63, 65])
@pytest.mark.parametrize("rt", [0, 1, 2])
@pytest.mark.parametrize("rf", [0, 1, 2])
def test_bits_match_plain(rf, rt, f):
    x, hi, lo, valid = _problem(3, 4, 77, f, [77, 30, 0], seed=rf + 3 * rt + f)
    args = _torch(x, hi, lo, valid)
    want = k9.binarize_freqspread_plain(*args, rf, rt)
    assert want.dtype == torch.uint8
    assert torch.equal(k9.binarize_freqspread_bits(*args, rf, rt), want)
    # the plain path of binarize_spread_flat is the same function
    flat = tplanes.binarize_spread_flat(*args[:3], args[3], rt, rf, plain=True)
    assert torch.equal(flat, want.to(torch.bool))


@pytest.mark.parametrize("t,valid", [(33, [33, 1]), (70, [69, 40]), (7, [7, 0])])
def test_bits_match_plain_at_many_words(t, valid):
    """F = 513 (nfft 1024's planes plus one): 17 words a mask; odd T."""
    x, hi, lo, v = _problem(2, 4, t, 513, valid, seed=t)
    args = _torch(x, hi, lo, v)
    for rf, rt in ((1, 1), (2, 0)):
        assert torch.equal(k9.binarize_freqspread_bits(*args, rf, rt),
                           k9.binarize_freqspread_plain(*args, rf, rt))


@pytest.mark.parametrize("f", [63, 65])
@pytest.mark.parametrize("rf,rt", [(0, 0), (1, 1), (2, 1), (1, 2)])
def test_bits_match_reference_pallas(rf, rt, f):
    """The reference's binarize_spread_flat with its Pallas kernel in
    interpret mode (the time dilation and the row mask in XLA after it),
    and at rt = 0 the Pallas kernel's own u8 map."""
    x, hi, lo, valid = _problem(2, 4, 128, f, [128, 77], seed=10 * rf + rt + f)
    want = np.asarray(jplanes.binarize_spread_flat(
        jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), rt, rf,
        use_pallas=True,
    ))
    args = _torch(x, hi, lo, valid)
    got = k9.binarize_freqspread_bits(*args, rf, rt)
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    np.testing.assert_array_equal(k9.binarize_freqspread(*args, rf, rt).numpy().astype(bool),
                                  want)
    if rt == 0:
        u8 = np.asarray(binarize_freqspread_pallas(
            jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), rf,
            interpret=True,
        ))
        np.testing.assert_array_equal(got.numpy(), u8)


@pytest.mark.parametrize("rf,rt", [(1, 1), (2, 2)])
def test_bits_match_reference_xla(rf, rt):
    """T not a multiple of 128 takes the reference's XLA path; valid above
    T counts as T."""
    x, hi, lo, valid = _problem(3, 4, 50, 63, [50, 80, 9], seed=rf + rt)
    want = np.asarray(jplanes.binarize_spread_flat(
        jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), rt, rf,
    ))
    got = k9.binarize_freqspread_bits(*_torch(x, hi, lo, valid), rf, rt)
    np.testing.assert_array_equal(got.numpy().astype(bool), want)


def test_binarize_spread_flat_on_cpu_keeps_its_plain_path():
    """On CPU tensors the layered frontend's call runs the kernel's plain
    version, then the time dilation and the row mask, as before."""
    x, hi, lo, valid = _problem(2, 4, 96, 63, [96, 41], seed=7)
    args = _torch(x, hi, lo, valid)
    got = tplanes.binarize_spread_flat(*args[:3], args[3], 1, 1)
    assert got.dtype == torch.bool
    assert torch.equal(got, k9.binarize_freqspread_plain(*args, 1, 1).to(torch.bool))
    assert not got[1, 41:].any()


def test_word_helpers():
    """The funnel shift reads zeros outside the string; the nibble
    multiply puts bit i into the low bit of byte i."""
    words = torch.tensor([0x80000001, 0x0000FFFF, 0x12345678], dtype=torch.int64)
    bits = sum(int(w) << (32 * i) for i, w in enumerate(words.tolist()))
    for pos in (-40, -33, -32, -31, -1, 0, 1, 16, 31, 32, 47, 63, 64, 80, 95, 96, 100):
        want = (bits >> pos if pos >= 0 else bits << -pos) & 0xFFFFFFFF
        assert int(k9._bits_at(words, pos)) == want, pos
    for x in range(16):
        y = int(k9._spread4(torch.tensor(x)))
        assert y == sum(((x >> i) & 1) << (8 * i) for i in range(4))


def test_tile_rule():
    """Tiles of a multiple of 4 rows (a tile's bits start on a word of its
    utterance's bit string), 64 at the log-mel scan's planes, fewer where
    the planes are wide."""
    assert k9.tile_rows(4, 63, 1) == 64
    assert k9.tile_rows(4, 512, 1) == 4
    for p, f, rt in ((4, 63, 0), (4, 65, 2), (4, 513, 2), (3, 39, 0), (4, 2048, 1)):
        tb = k9.tile_rows(p, f, rt)
        assert tb % 4 == 0 and 4 <= tb <= 64
        assert tb == 4 or k9._smem_bytes(tb, p, f, rt) <= k9.SMEM_TARGET
