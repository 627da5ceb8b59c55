"""Kernel 3 of the PyTorch port (the overlap-save block DFT) on the CPU.

The kernel (``csrc/fft_block_dft.cu``) runs only on the card; its
schedule, ``fft_block_dft_tiled`` (the padded K-major basis with zero
rows, Kp-row windows with zeros past each utterance's T, runs of
windows, the basis split into passes past 256 columns, the partial
last d tile), is held here against the plain version and against the
reference's Pallas kernel in interpret mode, in float32, at ragged
shapes: three utterances whose last window overruns T (T not a multiple
of hop), D 504 and 40, nfft 159, 39, 223 and 319.  Tolerance: 1e-5 x
max|reference| (the same exact products summed in other float32
orders).  Also the wrapper's plan and the shapes it must refuse (the
plans past one pass, at every template length: ``test_torch_shapes.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

from template_speech_recognition_tpu.ops.fft_dft_pallas import fft_block_dft_pallas
from template_speech_recognition_tpu_torch.detect import fft_scorer as tfs
from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3

# (L, bank K) -> nfft 159, 39, 223, 319 (pick_nfft); T overruns the
# last window and is not a multiple of hop
NFFT_CASES = {159: (32, 1024, 300), 39: (8, 128, 250), 223: (32, 4096, 500),
              319: (64, 1024, 700)}
CASES = [(nfft, d) for nfft in NFFT_CASES for d in (504, 40)]


def _shape(nfft):
    length, bank_k, t = NFFT_CASES[nfft]
    assert tfs.pick_nfft(length, bank_k) == nfft
    hop = nfft - length + 1
    nblk = -(-(t - length + 1) // hop)
    return t, hop, nblk


def _g(nfft):
    cm, sm = tfs._dft_mats(nfft, torch.float32)
    return torch.cat([cm, -sm], dim=1).contiguous()


def _x(b, t, d, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((b, t, d)) < 0.3).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module", params=CASES, ids=[f"nfft{n}-d{d}" for n, d in CASES])
def tiled(request):
    nfft, d = request.param
    t, hop, nblk = _shape(nfft)
    x, g = _x(3, t, d, nfft + d), _g(nfft)
    return (nfft, hop, nblk), x, g, k3.fft_block_dft_tiled(x, g, nfft, hop, nblk)


def test_block_dft_tiled_matches_plain(tiled):
    """Every output written (no NaN left), within 1e-5 x max|plain|."""
    (nfft, hop, nblk), x, g, got = tiled
    want = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
    bins = nfft // 2 + 1
    for a, w in zip(got, want):
        assert tuple(a.shape) == (bins, x.shape[0], nblk, x.shape[2])
        assert not torch.isnan(a).any()
        _close(a.numpy(), w.numpy())


def test_block_dft_tiled_matches_pallas(tiled):
    """Against the reference's Pallas kernel in interpret mode (one
    D-chunk of the whole width), within 1e-5 x max|reference|."""
    (nfft, hop, nblk), x, g, got = tiled
    want = fft_block_dft_pallas(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), nfft, hop,
                                nblk, dc=x.shape[2], interpret=True)
    for a, w in zip(got, want):
        _close(a.numpy(), w)


@pytest.mark.parametrize("over", [{"sms": 2}, {"run": 2}, {"wgs": 1}, {"sms": 1, "wgs": 1}],
                         ids=["few-sms", "run2", "wgs1", "one-block-a-tile"])
def test_block_dft_tiled_cut_does_not_change_values(over):
    """Other cuts of the same call (longer runs, 64-d tiles) write the
    same values: each window is one box times the same basis."""
    nfft, d = 159, 504
    t, hop, nblk = _shape(nfft)
    x, g = _x(3, t, d, 5), _g(nfft)
    base = k3.fft_block_dft_tiled(x, g, nfft, hop, nblk)
    for a, w in zip(k3.fft_block_dft_tiled(x, g, nfft, hop, nblk, **over), base):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_ragged_cases_catch_a_read_into_the_next_utterance():
    """Reading the tail windows from [B*T, D] (the next utterance's
    first rows past T) gives other spectra at these shapes, so the
    per-utterance zero fill is tested, not assumed."""
    for nfft in NFFT_CASES:
        t, hop, nblk = _shape(nfft)
        x, g = _x(3, t, 40, nfft), _g(nfft)
        flat = torch.cat([x.reshape(-1, 40), torch.zeros(nfft, 40)])
        rows = torch.arange(nblk)[:, None] * hop + torch.arange(nfft)[None, :]
        wrong = torch.stack([flat[bi * t + rows] for bi in range(3)])      # [B, nblk, nfft, D]
        spill = torch.einsum("tf,bitd->fbid", g, wrong)
        xr, _xi = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
        bins = nfft // 2 + 1
        assert float((spill[:bins, :2] - xr[:, :2]).abs().max()) > 1.0


@pytest.mark.parametrize(
    "b,d,nfft,nblk,want",
    [
        # the default scan: 128 blocks of 128 d x 24 windows
        (8, 2048, 159, 24, dict(kp=160, kb=160, bp=80, n=160, passes=1, wgs=2, stages=2,
                                run=24)),
        # the log-mel scan: 4 d tiles, so runs of 6 windows fill the card
        (8, 504, 159, 24, dict(kp=160, bp=80, n=160, passes=1, wgs=2, run=6)),
        # a bank of >= 4096 templates: N = 224 leaves room for one warpgroup
        (8, 2048, 223, 16, dict(kp=224, kb=224, bp=112, n=224, passes=1, wgs=1, stages=2)),
        # L = 64: 2 x 160 basis columns, two passes, two boxes a window
        (8, 2048, 319, 12, dict(kp=320, kb=160, bp=160, n=160, passes=2, wgs=1, stages=2)),
        # chip_smoke's small check
        (2, 1024, 39, 8, dict(kp=48, kb=48, bp=32, n=64, passes=1, wgs=2, stages=4, run=1)),
        # one 64-column tile
        (3, 40, 39, 8, dict(wgs=1)),
        # past 512 rows: the basis streams in chunks of 128 rows, 8 passes
        (2, 512, 1023, 4, dict(kp=1024, kb=128, kc=128, bp=512, n=128, passes=8, wgs=2)),
        # 257 bins: too many for one resident pass a half; 6 streamed passes
        (2, 512, 512, 4, dict(kp=512, kb=128, kc=128, bp=288, n=96, passes=6, wgs=2)),
    ],
    ids=["scan", "log-mel", "bank4096", "L64", "small", "d40", "nfft1023", "bins257"],
)
def test_plan(b, d, nfft, nblk, want):
    p = k3.plan(b, d, nfft, nblk, nfft // 2 + 1)
    assert {k: getattr(p, k) for k in want} == want
    assert p.smem <= k3.SMEM_LIMIT and 2 <= p.stages <= k3.MAX_STAGES
    assert p.n % 32 == 0 and p.n <= k3.MAX_N and p.kp % 16 == 0 and p.kp >= nfft
    n_tiles = -(-d // (64 * p.wgs))
    assert b * n_tiles * -(-nblk // p.run) * p.passes <= max(k3.H100_SMS, b * n_tiles * p.passes)


@pytest.mark.parametrize("nfft,bins", [(159, 79), (1, 1)])
def test_plan_raises(nfft, bins):
    """Only arguments that are not a block DFT: bins other than nfft //
    2 + 1, nfft < 2."""
    with pytest.raises(ValueError):
        k3.plan(2, 512, nfft, 4, bins)


def test_padded_basis():
    """xr's columns transposed into rows [0, bins), xi's into [bp, bp +
    bins), exact zeros elsewhere."""
    g = _g(39)
    gt = k3.padded_basis(g, 39, 32, 48)
    assert tuple(gt.shape) == (64, 48)
    np.testing.assert_array_equal(gt[:20, :39].numpy(), g[:, :20].t().numpy())
    np.testing.assert_array_equal(gt[32:52, :39].numpy(), g[:, 20:].t().numpy())
    mask = torch.ones_like(gt, dtype=torch.bool)
    mask[:20, :39] = False
    mask[32:52, :39] = False
    assert not bool(gt[mask].any())


def _offset_view(shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1 : 1 + n].view(*shape)


@pytest.mark.parametrize(
    "why,args",
    [
        ("B 0", lambda: (torch.zeros(0, 300, 64, dtype=torch.bfloat16),
                         _g(159).to(torch.bfloat16), 159, 128, 3)),
        ("g not [nfft, 2 bins]", lambda: (torch.zeros(2, 300, 64, dtype=torch.bfloat16),
                                          _g(159)[:158].to(torch.bfloat16), 159, 128, 3)),
    ],
)
def test_wrapper_raises_on_a_shape_the_kernel_cannot_take(monkeypatch, why, args):
    """The CUDA path of the wrapper (device checks and the SM count
    stubbed so CPU tensors reach it) raises ValueError before it loads or launches anything;
    it never falls back to the plain version."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(k3, "_sm_count", lambda _dev: k3.H100_SMS)

    def no_load(_stem):
        raise AssertionError(f"{why}: the kernel was loaded")

    monkeypatch.setattr(_cuda, "load", no_load)
    monkeypatch.setattr(k3, "fft_block_dft_plain", None)
    with pytest.raises(ValueError):
        k3.fft_block_dft(*args())


@pytest.mark.parametrize(
    "why,d,args",
    [
        ("D 500", 500, lambda: (torch.rand(2, 300, 500).lt(0.3).to(torch.bfloat16),
                                _g(159).to(torch.bfloat16), 159, 128, 3)),
        ("misaligned base", 64, lambda: (_offset_view((2, 300, 64)),
                                         _g(159).to(torch.bfloat16), 159, 128, 3)),
    ],
)
def test_wrapper_pads_rows_the_kernel_cannot_take(monkeypatch, why, d, args):
    """The CUDA path of the wrapper (the same stubs as above) takes D %
    8 != 0 and a misaligned base: it loads the kernel (never the plain
    version) and launches it on a fresh, contiguous, 16-byte aligned
    copy of x zero-padded to D8 columns, and returns xr, xi of x's D."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(k3, "_sm_count", lambda _dev: k3.H100_SMS)
    monkeypatch.setattr(_cuda, "ptr", lambda t: t)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda _dev: None)
    monkeypatch.setattr(k3, "fft_block_dft_plain", None)
    calls = []

    def launch(*a):
        calls.append(a)
        return 0

    class Lib:
        tsr_fft_block_dft = staticmethod(launch)

    loaded = []
    monkeypatch.setattr(_cuda, "load", lambda stem: loaded.append(stem) or Lib)
    x, g, nfft, hop, nblk = args()
    xr, xi = k3.fft_block_dft(x, g, nfft, hop, nblk)
    assert loaded == ["fft_block_dft"] and len(calls) == 1
    xp, d_arg = calls[0][0], calls[0][6]
    d8 = -(-d // 8) * 8
    assert d_arg == d8 and tuple(xp.shape) == (2, 300, d8)
    assert xp.is_contiguous() and xp.data_ptr() % 16 == 0 and xp.data_ptr() != x.data_ptr()
    assert torch.equal(xp[..., :d], x) and not bool(xp[..., d:].any())
    bins = g.shape[1] // 2
    assert tuple(xr.shape) == tuple(xi.shape) == (bins, 2, nblk, d)
