"""Kernel 8 of the PyTorch port (the layered radix select) on the CPU.

The kernel (``csrc/radix_select.cu``) runs only on the card; its
schedule, ``radix_select_tiled`` (2048-bin histograms of 11, 11 and 10
bit digits summed over chunks of a row, only the valid cells counted,
level 1 counted once for both ranks, the digit pick that takes the last
digit when no count reaches the rank), is held here bitwise against the
plain version (the reference's 2 + 3 x 10 bit schedule over masked
keys) and against the reference's ``plane_order_statistics`` with its
Pallas counting kernel in interpret mode.  Ragged shapes (F 39, 63, 64
and 511; B 1, 3 and 8; valid 0, 1, T - 1, T and mixes), quantiles 0.0,
0.3, 0.9 and 0.98, heavy ties, signed zeros and all-equal planes; ranks
that share every digit and a rank on the last key of a level-1 bin.
Also the 8 x 4 bit schedule and other chunkings of the same schedule
code, the wrapper's plan, the operands it must refuse, valid frames
above T (counted as T) and utterance-major planes.  Inputs come from
numpy with fixed seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

from template_speech_recognition_tpu.frontend import planes as jplanes
from template_speech_recognition_tpu_torch.frontend import planes as tplanes
from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops import radix_kernel as k8
from template_speech_recognition_tpu_torch.ops.edges import order_keys

QUANTILES = (0.0, 0.3, 0.9, 0.98)
# (B, P, T, F, valid): F 39, 63, 64 and 511; valid T, T - 1, 1, 0, mixes
SHAPES = [
    (1, 4, 40, 39, [40]),
    (3, 4, 33, 63, [32, 1, 0]),
    (8, 4, 17, 64, [17, 16, 1, 0, 9, 3, 12, 5]),
    (3, 2, 9, 511, [9, 8, 0]),
    (1, 3, 50, 63, [49]),
    (8, 2, 12, 39, [0, 1, 0, 1, 11, 12, 2, 0]),
    (3, 4, 21, 511, [1, 20, 21]),
    (1, 1, 130, 64, [129]),
    (3, 4, 256, 63, [256, 100, 0]),
]


def _planes(b, p, t, f, kind, seed):
    """[B, P, T, F] float32: ``random`` (normal, a third rounded to
    quarters, a row of -0.0 and one of +0.0), ``ties`` (eleven values,
    -0.0 and +0.0 among them) or ``equal`` (each plane one value)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.standard_normal((b, p, t, f)).astype(np.float32)
        x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
        x[:, :, min(5, t - 1), :7] = -0.0
        x[:, :, min(6, t - 1), :7] = 0.0
    elif kind == "ties":
        vals = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.25, 0.5, 1.0, 1.5, 3.0, 1e-30],
                        np.float32)
        x = vals[rng.integers(0, len(vals), (b, p, t, f))]
    else:
        x = np.empty((b, p, t, f), np.float32)
        vals = np.array([0.5, -0.0, 0.0, -3.25], np.float32)
        for i in range(p):
            x[:, i] = vals[i % len(vals)]
    return x


def _need(valid, f, q):
    return tplanes._dual_ranks(torch.from_numpy(np.asarray(valid, np.int32)), f, q)


def _pm(x):
    """[B, P, T, F] numpy -> the plane-major storage [P, B, T, F]."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2, 3)))


def _bits(t):
    return np.asarray(t).view(np.uint32)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _select_all(x, valid, q, use_pallas=True, **tiled_kw):
    """(tiled, plain, reference) selects of one input: the reference with
    its Pallas counting kernel in interpret mode, or its XLA path."""
    b, _p, _t, f = x.shape
    vt = torch.from_numpy(np.asarray(valid, np.int32))
    need = _need(valid, f, q)
    tiled = k8.radix_select_tiled(_pm(x), vt, need, **tiled_kw)
    plain = k8.radix_select_plain(_pm(x), vt, need)
    ref = jplanes.plane_order_statistics(jnp.asarray(x), jnp.asarray(valid, jnp.int32), q,
                                         use_pallas=use_pallas)
    return tiled, plain, tuple(np.asarray(r) for r in ref)


# The reference's Pallas kernel compiles for ~35 s at each new key shape
# [B*P, T*F] in interpret mode (eleven static shifts); these three shapes
# take it, and the other tests reuse their key shapes.
PALLAS_SHAPES = [SHAPES[1], SHAPES[3], SHAPES[5]]
PALLAS_IDS = ["F63", "F511", "F39"]


@pytest.mark.parametrize("q", QUANTILES)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"B{s[0]}-P{s[1]}-T{s[2]}-F{s[3]}"
                                                for s in SHAPES])
def test_tiled_matches_plain_and_reference(shape, q):
    """Bitwise against the plain version and the reference's XLA path
    (its 8 x 4 bit schedule over masked keys)."""
    b, p, t, f, valid = shape
    x = _planes(b, p, t, f, "random", seed=t * f + b)
    tiled, plain, ref = _select_all(x, valid, q, use_pallas=False)
    for out in (*tiled, *plain):
        assert out.dtype == torch.float32 and tuple(out.shape) == (b, p)
        assert out.is_contiguous()
    _assert_same(tiled, plain)
    _assert_same(tiled, ref)


@pytest.mark.parametrize("q", QUANTILES)
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=PALLAS_IDS)
def test_tiled_matches_the_pallas_reference(shape, q):
    """Bitwise against the reference with its Pallas counting kernel in
    interpret mode: valid 0, 1, T - 1 and mixes, B 3 and 8."""
    b, p, t, f, valid = shape
    x = _planes(b, p, t, f, "random", seed=t * f + b)
    tiled, plain, ref = _select_all(x, valid, q)
    _assert_same(tiled, plain)
    _assert_same(tiled, ref)


@pytest.mark.parametrize("kind", ["ties", "equal"])
@pytest.mark.parametrize("q", [0.0, 0.98])
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=PALLAS_IDS)
def test_ties_zeros_and_equal_planes(shape, q, kind):
    """Heavy ties with both signed zeros, and planes of one value (both
    ranks then share every digit), bitwise across the three versions."""
    b, p, t, f, valid = shape
    x = _planes(b, p, t, f, kind, seed=11)
    tiled, plain, ref = _select_all(x, valid, q)
    _assert_same(tiled, plain)
    _assert_same(tiled, ref)


def test_ranks_sharing_every_digit():
    """n odd and q = 0.5: k = n - 1 - k, so the two ranks' prefixes are
    equal at every level and the kernel counts each level once."""
    b, p, t, f, _ = SHAPES[1]
    x = _planes(b, p, t, f, "random", seed=3)
    valid = [31, 1, 0]                            # n = 1953, 63 and 0
    need = _need(valid, f, 0.5)
    assert bool((need[:2, 0] == need[:2, 1]).all())
    tiled, plain, ref = _select_all(x, valid, 0.5)
    _assert_same(tiled, plain)
    _assert_same(tiled, ref)
    np.testing.assert_array_equal(_bits(tiled[0][:2]), _bits(tiled[1][:2]))


@pytest.mark.parametrize("q", [0.3, 0.9])
def test_rank_on_the_last_key_of_a_level1_bin(q):
    """Each plane's cells below the rank-k one lie in [1, 1.25) (one
    level-1 bin: sign, exponent and two mantissa bits) and the rest in
    [2, 2.5): the rank-k element is the last key of its bin, and the
    pick must stop at that bin, not pass it."""
    b, p, t, f, _ = SHAPES[1]
    valid = [33, 17, 9]
    need = _need(valid, f, q)
    rng = np.random.default_rng(5)
    x = np.full((b, p, t, f), 7.0, np.float32)          # rows past valid
    for i, v in enumerate(valid):
        n, m = v * f, int(need[i, 0])                      # m = k + 1 cells below 1.25
        for j in range(p):
            low = (1.0 + 0.2499 * rng.random(m)).astype(np.float32)
            high = (2.0 + 0.4999 * rng.random(n - m)).astype(np.float32)
            x[i, j, :v] = rng.permutation(np.concatenate([low, high])).reshape(v, f)
    bins = (order_keys(torch.from_numpy(x)) >> 21).unique()
    assert len(bins) == 3                                  # 1.x, 2.x and the 7.0 fill
    tiled, plain, ref = _select_all(x, valid, q)
    _assert_same(tiled, plain)
    _assert_same(tiled, ref)
    for i in range(b):
        for j in range(p):
            cells = x[i, j, : valid[i]].ravel()
            assert tiled[0][i, j] == cells[cells < 1.5].max()


@pytest.mark.parametrize("shape,widths,chunk", [
    (SHAPES[2], (8, 8, 8, 8), 8192), (SHAPES[6], (8, 8, 8, 8), 8192),
    (SHAPES[2], (11, 11, 10), 1024), (SHAPES[6], (11, 11, 10), 1024),
    (SHAPES[6], (10, 11, 11), 2048), (SHAPES[5], (11, 11, 10), 4),
    (SHAPES[5], (8, 8, 8, 8), 12),
], ids=["F64-8x4", "F511-8x4", "F64-c1024", "F511-c1024", "F511-10.11.11", "F39-c4",
        "F39-8x4-c12"])
def test_schedules_select_the_same_element(shape, widths, chunk):
    """The 8 x 4 bit schedule and other widths and chunkings (a chunk of
    4 cells: one 16-byte load a block) select what 11/11/10 does."""
    b, p, t, f, valid = shape
    x = _planes(b, p, t, f, "random", seed=2)
    vt = torch.from_numpy(np.asarray(valid, np.int32))
    for q in (0.0, 0.98):
        need = _need(valid, f, q)
        want = k8.radix_select_tiled(_pm(x), vt, need)
        _assert_same(k8.radix_select_tiled(_pm(x), vt, need, widths=widths, chunk=chunk),
                     want)
        _assert_same(k8.radix_select_plain(_pm(x), vt, need), want)


def test_plane_order_statistics_is_one_select_call(monkeypatch):
    """``plane_order_statistics`` computes the ranks and makes one call of
    the select on the plane-major storage (the transpose of the [B, P]
    view the layered path hands over), plain or not."""
    x = _planes(3, 4, 33, 63, "random", seed=9)
    pm = _pm(x)
    view = pm.transpose(0, 1)                              # [B, P, T, F]
    valid = torch.tensor([32, 1, 0], dtype=torch.int32)
    calls = []
    for name in ("radix_select", "radix_select_plain"):
        real = getattr(tplanes, name)

        def spy(planes_pm, vf, need, real=real, name=name):
            calls.append((name, planes_pm.is_contiguous(), tuple(need.shape), need.dtype))
            return real(planes_pm, vf, need)

        monkeypatch.setattr(tplanes, name, spy)
    got = tplanes.plane_order_statistics(view, valid, 0.98)
    want = tplanes.plane_order_statistics(view, valid, 0.98, plain=True)
    assert calls == [("radix_select", True, (3, 2), torch.int32),
                     ("radix_select_plain", True, (3, 2), torch.int32)]
    _assert_same(got, want)


@pytest.mark.parametrize("q", [0.0, 0.98])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3], SHAPES[5]], ids=["F63", "F511", "F39"])
def test_valid_frames_above_t_count_as_t(monkeypatch, shape, q):
    """``plane_order_statistics`` clamps valid frames to T before the
    ranks, so the select it calls (the kernel on the card reads at most T
    rows) sees the n its ranks were made from: the same elements as with
    valid T, from the kernel's schedule and the plain version alike."""
    b, p, t, f, valid = shape
    x = _planes(b, p, t, f, "random", seed=13)
    view = _pm(x).transpose(0, 1)
    over = torch.tensor([v + 1 + 3 * i for i, v in enumerate(valid)], dtype=torch.int32)
    over[0] = t + 5
    seen = []
    real = tplanes.radix_select

    def spy(planes_pm, vf, need):
        seen.append(int(vf.max()))
        return real(planes_pm, vf, need)

    monkeypatch.setattr(tplanes, "radix_select", spy)
    got = tplanes.plane_order_statistics(view, over, q)
    clamped = over.clamp(max=t)
    assert seen == [t]
    _assert_same(got, tplanes.plane_order_statistics(view, clamped, q, plain=True))
    _assert_same(got, k8.radix_select_tiled(_pm(x), clamped, _need(clamped.numpy(), f, q)))


def test_plane_order_statistics_takes_utterance_major_planes(monkeypatch):
    """A contiguous [B, P, T, F] tensor (not the view of plane-major
    storage that the layered path hands over) reaches the select as
    contiguous plane-major storage, with the same result."""
    x = _planes(3, 4, 33, 63, "ties", seed=4)
    valid = torch.tensor([32, 1, 0], dtype=torch.int32)
    layouts = []
    real = tplanes.radix_select

    def spy(planes_pm, vf, need):
        layouts.append((planes_pm.is_contiguous(), tuple(planes_pm.shape)))
        return real(planes_pm, vf, need)

    monkeypatch.setattr(tplanes, "radix_select", spy)
    got = tplanes.plane_order_statistics(torch.from_numpy(x), valid, 0.98)
    assert layouts == [(True, (4, 3, 33, 63))]
    _assert_same(got, tplanes.plane_order_statistics(_pm(x).transpose(0, 1), valid, 0.98))


def test_plan_chunk_fills_the_card():
    """The log-mel scan's 32 rows of 3072 x 63 cells: chunks of whole
    16-byte loads for every thread, about three blocks an SM."""
    chunk = k8.plan_chunk(3072 * 63, 32, 132)
    assert chunk % (4 * k8.THREADS) == 0
    blocks = 32 * -(-3072 * 63 // chunk)
    assert 3 * 132 <= blocks <= 3 * 132 + 32
    assert k8.plan_chunk(5, 1, 132) == 4 * k8.THREADS


def _offset_view(shape):
    """A contiguous float32 tensor whose base lies one float past an
    allocation's start (the kernel takes it; 16-byte loads start later)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


@pytest.mark.parametrize(
    "why,args",
    [
        ("float64 planes", lambda: (torch.zeros(4, 2, 8, 63, dtype=torch.float64),
                                    torch.full((2,), 8, dtype=torch.int32),
                                    torch.ones(2, 2, dtype=torch.int32))),
        ("F 0", lambda: (torch.zeros(4, 2, 8, 0), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, 2, dtype=torch.int32))),
        ("T 0", lambda: (torch.zeros(4, 2, 0, 63), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, 2, dtype=torch.int32))),
        ("valid above T", lambda: (torch.zeros(4, 2, 8, 63),
                                   torch.tensor([8, 9], dtype=torch.int32),
                                   torch.ones(2, 2, dtype=torch.int32))),
        ("non-contiguous planes", lambda: (torch.zeros(2, 4, 8, 63).transpose(0, 1),
                                           torch.full((2,), 8, dtype=torch.int32),
                                           torch.ones(2, 2, dtype=torch.int32))),
        ("int64 valid", lambda: (torch.zeros(4, 2, 8, 63), torch.full((2,), 8),
                                 torch.ones(2, 2, dtype=torch.int32))),
        ("need not [B, 2]", lambda: (torch.zeros(4, 2, 8, 63),
                                     torch.full((2,), 8, dtype=torch.int32),
                                     torch.ones(2, 3, dtype=torch.int32))),
        ("3-D planes", lambda: (torch.zeros(4, 16, 63), torch.full((2,), 8, dtype=torch.int32),
                                torch.ones(2, 2, dtype=torch.int32))),
    ],
)
def test_wrapper_raises_on_what_the_kernel_cannot_take(monkeypatch, why, args):
    """The CUDA path of the wrapper (the device checks stubbed so CPU
    tensors reach it) raises ValueError before it loads or launches
    anything; it never falls back to the plain version."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "require", _cuda.require_layout)

    def no_load(_stem):
        raise AssertionError(f"{why}: the kernel was loaded")

    monkeypatch.setattr(_cuda, "load", no_load)
    monkeypatch.setattr(k8, "radix_select_plain", None)
    monkeypatch.setattr(k8, "_sm_count", lambda _dev: k8.H100_SMS)
    with pytest.raises(ValueError):
        k8.radix_select(*args())


def test_wrapper_takes_an_unaligned_base(monkeypatch):
    """A base one float past 16-byte alignment passes every check and
    reaches the kernel's entry with its shapes and planned chunk."""
    seen = {}

    class Lib:
        pass

    def fake_declare(_lib, name, n_ptr, n_int):
        def fn(*a):
            seen["args"] = a[n_ptr:n_ptr + n_int]
            return 0
        return fn

    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "require", _cuda.require_layout)
    monkeypatch.setattr(_cuda, "load", lambda _stem: Lib())
    monkeypatch.setattr(_cuda, "declare", fake_declare)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda _dev: None)
    monkeypatch.setattr(k8, "_sm_count", lambda _dev: k8.H100_SMS)
    planes = _offset_view((4, 2, 8, 63))
    assert planes.data_ptr() % 16 != 0
    before = _cuda.launch_counts().get(k8.NAME, 0)
    hi, lo = k8.radix_select(planes, torch.full((2,), 8, dtype=torch.int32),
                             torch.ones(2, 2, dtype=torch.int32))
    assert _cuda.launch_counts().get(k8.NAME, 0) == before + 1
    assert tuple(hi.shape) == tuple(lo.shape) == (2, 4)
    assert seen["args"] == (4, 2, 8, 63, k8.plan_chunk(8 * 63, 8, k8.H100_SMS))


def test_scratch_holds_the_counts_and_two_buffers_a_row():
    """The log-mel scan's scratch: 64 collected counts and level 1's
    [32, 2048] histogram, then the stage and compact buffers of 193,536
    keys a row (a key matches at most one rank's prefix, so the two slots
    share a row's buffer)."""
    assert k8.scratch_ints(32, 3072 * 63) == 64 + 32 * 2048 + 2 * 32 * 3072 * 63
    assert k8.scratch_ints(5, 7) % 4 == 0
    assert k8.scratch_ints(5, 7) == 12 + 5 * 2048 + 2 * 5 * 8
