"""Kernel 2: exact dual-rank select + binarize + spread.

Replaces ``template_speech_recognition_tpu/ops/selbin_pallas.py``
``select_binspread_pallas`` -- both its variants, the all-planes
``_kernel_allplanes`` (``pallas_call`` at line 312) and the per-plane
``_kernel`` (line 346): they compute one function.

Per (plane p, utterance b): the order keys of the valid cells (rows
< valid) are the monotone uint32 image of the float32 responses; the
selected keys are the ``need[b, 0]``-th and ``need[b, 1]``-th smallest
(1-based ranks; 0 selects key 0, a rank past the valid count selects
the masked key 0xFFFFFFFF, exactly as the TPU kernel's bisection).
Then channel 2p keeps ``key > v_hi`` and channel 2p+1 keeps ``key <
v_lo`` on canonicalized keys (-0.0 maps onto +0.0, so key order is
float order), both are dilated by ``spread_freq`` along frequency and
``spread_time`` along time, and rows >= valid are cleared before and
after.  Output: the flat channel-major map ``[B, T, 2PF]`` u8 and the
selected keys ``[B, P, 2]`` (int64 holding uint32), bitwise equal to
the TPU kernel's.

CUDA design (``csrc/select_binspread.cu``): two variants, chosen by
shape (``route``), both counted as ``select_binspread``.

* ``cluster`` (F <= 1024 and a sixteenth of the plane within a block's
  shared memory: T <= 3264 at F = 256, the scan's T_pad 3072
  included): 16-CTA thread-block clusters, as many as the card runs at
  once, walk the (plane, utterance) pairs; a cluster holds a pair's
  plane in its distributed shared memory, as the TPU kernel holds it in
  VMEM.  Each CTA loads its ceil(T/16) rows once with the TMA's bulk
  copy (the next pair's rows land while this pair's map is written),
  turns them into keys in place and counts their top digits; four 8-bit
  radix levels add the 16 CTAs' counts across the cluster (DSMEM), one
  cluster barrier a level, and every CTA picks the digits itself; the
  keys under either rank's prefix go to per-warp candidate lists, so
  the later levels count only those.  Binarize packs 8 cells a lane
  into bit rows, frequency dilation shifts and ORs the 32-bit words,
  time dilation reads the halo rows from the neighbouring CTAs, and
  each row's two channels leave as 16-byte stores.  The planes cross
  device memory once, the map once.
* ``multipass`` (larger planes): four histogram radix passes over all
  pairs through L2 and global histograms, then an epilogue that reads
  the planes again: five reads of the planes.

Any digit schedule selects the same element as the reference's
32-level bisection, so the keys are bitwise the TPU kernel's.
``select_binspread_emulated`` replays the cluster variant's schedule
(16 row slices, summed slice histograms, 8-bit digits, packed words,
halo rows from the neighbouring slice) in plain PyTorch for the tests.

What bounds it on the H100: bytes.  The valid rows of the planes in
once and the map out once (101 + 50 MB at B=8, T_pad=3072, F=256) take
0.044 ms at 3.35 TB/s.  The cluster variant takes ~0.17-0.19 ms there:
the card runs 7 such clusters, so each selects 4-5 planes in turn, and
a plane's select is integer work at one CTA an SM (PERF.md).
"""

from __future__ import annotations

import ctypes

import torch

from template_speech_recognition_tpu_torch.ops import _cuda
from template_speech_recognition_tpu_torch.ops.edges import (
    MASKED_KEY,
    _dilate_axis,
    order_keys,
)

NAME = "select_binspread"
SOURCE = "template_speech_recognition_tpu_torch/csrc/select_binspread.cu"
REPLACES = "template_speech_recognition_tpu/ops/selbin_pallas.py:312"

_NEG_ZERO_KEY = 0x7FFFFFFF
_POS_ZERO_KEY = 0x80000000

# The cluster variant's layout (``csrc/select_binspread.cu``): CLUSTER
# CTAs a pair, each with R = ceil(T / CLUSTER) rows of F keys, R x 2 x
# ceil(F/32) words of dilated bits and a fixed part (its 512 counts,
# three buffers of the 512 sums it gathers for the cluster, 512 sums,
# 8 mbarriers, the digit state, a candidate count for each of its 32
# warps); during the select the bit rows and the rest of the block's
# shared memory hold the level-1 candidates.
CLUSTER = 16
MAX_SMEM = 232_448                 # dynamic shared memory a block may have
_CLUSTER_FIXED = 512 * 4 + 3 * 512 * 4 + 512 * 4 + 8 * 8 + 8 * 4
MAX_CLUSTER_F = 1024               # a row's words sit one a lane of a warp
DIGIT_BITS = 8                     # four levels of 8-bit digits

route_launches: dict[str, int] = {"cluster": 0, "multipass": 0}


def cluster_need_bytes(t: int, f: int) -> int:
    """Shared memory a CTA of the cluster variant needs at (T, F) before
    its candidate list."""
    r = -(-t // CLUSTER)
    return r * f * 4 + r * 2 * (-(-f // 32)) * 4 + _CLUSTER_FIXED


def route(t: int, f: int) -> str:
    """The variant that takes planes of T rows of F cells: ``cluster``
    while a CTA's rows fit its shared memory (and F <= 1024), else
    ``multipass``.  The rule reads the shape only."""
    fits = f <= MAX_CLUSTER_F and cluster_need_bytes(t, f) <= MAX_SMEM
    return "cluster" if fits else "multipass"


def _canon(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k == _NEG_ZERO_KEY, torch.full_like(k, _POS_ZERO_KEY), k)


def select_binspread_plain(
    planes: torch.Tensor,        # [P, B, T, F] f32
    need: torch.Tensor,          # [B, 2] int: rank+1 for (k, n-1-k)
    valid_frames: torch.Tensor,  # [B] int
    spread_freq: int,
    spread_time: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a sort selects the keys."""
    p, b, t, f = planes.shape
    dev = planes.device
    keys = order_keys(planes)                                   # int64
    rv = torch.arange(t, device=dev)[None, :] < valid_frames.to(dev)[:, None]
    cell_valid = rv[None, :, :, None].expand(p, b, t, f)
    masked = torch.where(cell_valid, keys, torch.full_like(keys, MASKED_KEY))
    srt = torch.sort(masked.reshape(p, b, t * f), dim=-1).values
    need = need.to(device=dev, dtype=torch.int64)               # [B, 2]
    idx = (need - 1).clamp(min=0)[None].expand(p, b, 2)
    sel = torch.gather(srt, -1, idx)
    sel = torch.where(need[None] == 0, torch.zeros_like(sel), sel)  # [P, B, 2]
    ck = _canon(keys)
    v_hi = _canon(sel[..., 0])[..., None, None]
    v_lo = _canon(sel[..., 1])[..., None, None]
    pos = (ck > v_hi) & cell_valid
    neg = (ck < v_lo) & cell_valid
    # [P, 2, B, T, F] -> [B, T, 2P, F]: channel 2i = pos_i, 2i+1 = neg_i
    ch = torch.stack([pos, neg], dim=1).permute(2, 3, 0, 1, 4).reshape(
        b, t, 2 * p, f
    )
    if spread_freq:
        ch = _dilate_axis(ch, spread_freq, 3)
    if spread_time:
        ch = _dilate_axis(ch, spread_time, 1)
    ch = ch & rv[:, :, None, None]
    flat = ch.reshape(b, t, 2 * p * f).to(torch.uint8)
    return flat, sel.permute(1, 0, 2).contiguous()


def _pick_digit(counts: torch.Tensor, need: torch.Tensor):
    """Per row of ``counts`` [Q, 256]: the first digit whose cumulative
    count reaches ``need`` (digit 255 at the latest) and the count below
    it -- the kernel's digit pick."""
    cum = counts.cumsum(-1)
    d = (cum < need[:, None]).sum(-1).clamp(max=255)
    below = cum.gather(-1, d[:, None])[:, 0] - counts.gather(-1, d[:, None])[:, 0]
    return d, below


def _dilate_words(words: torch.Tensor, radius: int) -> torch.Tensor:
    """OR of a row of packed 32-bit words [..., W] (int64 holding
    uint32) shifted by -radius..radius bits, with zeros past either end:
    the kernel's ``shifted_word``."""
    if radius == 0:
        return words
    n = words.shape[-1]
    pad = -(-radius // 32) + 1
    z = torch.zeros(words.shape[:-1] + (pad,), dtype=words.dtype, device=words.device)
    ext = torch.cat([z, words, z], dim=-1)
    out = words
    for s in range(1, radius + 1):
        a, c = s >> 5, s & 31
        for sign in (1, -1):
            lo = ext[..., pad + sign * a: pad + sign * a + n]
            if c == 0:
                out = out | lo
                continue
            hi = ext[..., pad + sign * (a + 1): pad + sign * (a + 1) + n]
            if sign > 0:    # bit f of the result is bit f + s
                out = out | (lo >> c) | ((hi << (32 - c)) & 0xFFFFFFFF)
            else:           # bit f of the result is bit f - s
                out = out | ((lo << c) & 0xFFFFFFFF) | (hi >> (32 - c))
    return out


def select_binspread_emulated(
    planes: torch.Tensor,        # [P, B, T, F] f32
    need: torch.Tensor,          # [B, 2] int
    valid_frames: torch.Tensor,  # [B] int
    spread_freq: int,
    spread_time: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The cluster variant's schedule in plain PyTorch (for the tests):
    each pair's rows cut into CLUSTER slices of R rows, each slice's
    digit histograms counted on its own and summed, four 8-bit levels
    (level 0 one histogram for both ranks; levels 2 and 3 count only the
    level-1 candidates, the keys under either rank's 8-bit prefix),
    binarize into packed 32-bit
    words, frequency dilation by word shifts, time dilation with the
    halo rows read from the slice that owns them.  The same outputs as
    ``select_binspread_plain``."""
    p, b, t, f = planes.shape
    dev = planes.device
    q = p * b
    r = -(-t // CLUSTER)
    w = -(-f // 32)
    vq = valid_frames.to(dev, torch.int64).clamp(0, t).repeat(p)          # [Q]
    needq = need.to(dev, torch.int64).repeat(p, 1)                        # [Q, 2]
    keys = order_keys(planes).reshape(q, t, f)
    keys = torch.cat([keys, keys.new_zeros((q, CLUSTER * r - t, f))], 1)
    keys = keys.reshape(q, CLUSTER, r, f)                                 # the slices
    row = torch.arange(CLUSTER * r, device=dev).reshape(CLUSTER, r)
    rv = row[None] < vq[:, None, None]                                    # [Q, 16, R]
    cell = rv[..., None].expand(q, CLUSTER, r, f)

    def slice_counts(match, digit):     # [Q, 16, 256]: one histogram a slice
        h = torch.zeros((q, CLUSTER, 256), dtype=torch.int64, device=dev)
        return h.scatter_add_(2, digit.reshape(q, CLUSTER, -1),
                              match.reshape(q, CLUSTER, -1).to(torch.int64))

    total = vq * f
    edge = (needq <= 0) | (needq > total[:, None])
    prefix = torch.zeros((q, 2), dtype=torch.int64, device=dev)
    rem = needq.clone()
    cand = cell
    for level in range(32 // DIGIT_BITS):
        shift = 32 - DIGIT_BITS * (level + 1)
        digit = (keys >> shift) & 255
        if level == 0:
            sums = slice_counts(cell, digit).sum(1)
            per_rank = (sums, sums)
        else:
            top = keys >> (shift + 8)
            if level == 1:      # the candidates: keys under either rank's 8-bit prefix
                act = ~edge
                cand = cell & (((top == prefix[:, 0, None, None, None]) & act[:, 0, None, None, None])
                               | ((top == prefix[:, 1, None, None, None])
                                  & act[:, 1, None, None, None]))
            per_rank = tuple(
                slice_counts(cand & (top == prefix[:, i, None, None, None]), digit).sum(1)
                for i in range(2)
            )
        for i in range(2):
            d, below = _pick_digit(per_rank[i], rem[:, i])
            prefix[:, i] = (prefix[:, i] << 8) | d
            rem[:, i] = rem[:, i] - below
    sel = torch.where(edge, torch.where(needq <= 0, 0, MASKED_KEY), prefix)  # [Q, 2]

    ck = _canon(keys)
    fpad = w * 32 - f
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    words = []
    for i, cmp in ((0, torch.gt), (1, torch.lt)):
        bits = cmp(ck, _canon(sel[:, i])[:, None, None, None]) & cell
        bits = torch.nn.functional.pad(bits, (0, fpad)).reshape(q, CLUSTER, r, w, 32)
        words.append(_dilate_words((bits.to(torch.int64) * weights).sum(-1), spread_freq))
    dil = torch.stack(words, 3)                                 # [Q, 16, R, 2, W]

    out = torch.zeros_like(dil)
    tg = row[None]                                              # [1, 16, R] global rows
    for dt in range(-spread_time, spread_time + 1):
        u = tg + dt
        ok = (u >= 0) & (u < vq[:, None, None]) & (tg < vq[:, None, None])
        uc = u.clamp(0, CLUSTER * r - 1)
        owner, local = uc // r, uc % r                          # the slice that owns row u
        src = dil[torch.arange(q, device=dev)[:, None, None], owner, local]
        out = out | torch.where(ok[..., None, None], src, torch.zeros_like(src))
    bitpos = torch.arange(32, device=dev)
    cells = ((out[..., None] >> bitpos) & 1).reshape(q, CLUSTER * r, 2, w * 32)
    cells = cells[:, :t, :, :f].to(torch.uint8)                 # [Q, T, 2, F]
    flat = cells.reshape(p, b, t, 2, f).permute(1, 2, 0, 3, 4).reshape(b, t, 2 * p * f)
    return flat.contiguous(), sel.reshape(p, b, 2).permute(1, 0, 2).contiguous()


def max_active_clusters() -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster variant: how
    many 16-CTA clusters the card runs at once (every CTA takes the
    block's whole shared memory, whatever the shape)."""
    lib = _cuda.load("select_binspread")
    fn = lib.tsr_selbin_max_clusters
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    _cuda.check(lib, fn(ctypes.byref(out)), NAME)
    return out.value


def cluster_fits_on_card(t: int, f: int) -> bool:
    """The kernel's own shape rule (``tsr_selbin_cluster_fits``), to hold
    ``route`` against it on the card."""
    lib = _cuda.load("select_binspread")
    lib.tsr_selbin_cluster_fits.argtypes = [ctypes.c_int] * 2
    lib.tsr_selbin_cluster_fits.restype = ctypes.c_int
    return bool(lib.tsr_selbin_cluster_fits(t, f))


def select_binspread(
    planes: torch.Tensor,
    need: torch.Tensor,
    valid_frames: torch.Tensor,
    spread_freq: int,
    spread_time: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[P, B, T, F] f32 planes -> (flat [B, T, 2PF] u8, keys [B, P, 2]
    int64).  CPU tensors take the plain version; CUDA tensors launch
    the variant that ``route`` picks for the shape."""
    if _cuda.on_cpu(planes, need, valid_frames):
        return select_binspread_plain(
            planes, need, valid_frames, spread_freq, spread_time
        )
    _cuda.require(planes, "planes", torch.float32, 4)
    _cuda.require(need, "need", torch.int32, 2)
    _cuda.require(valid_frames, "valid_frames", torch.int32, 1)
    p, b, t, f = planes.shape
    if f % 4:
        raise ValueError(f"F={f} must be a multiple of 4")
    if tuple(need.shape) != (b, 2) or tuple(valid_frames.shape) != (b,):
        raise ValueError("need must be [B, 2] and valid_frames [B]")
    if planes.data_ptr() % 16:
        raise ValueError("planes must be 16-byte aligned")
    dev = planes.device
    flat = torch.empty((b, t, 2 * p * f), dtype=torch.uint8, device=dev)
    keys = torch.empty((b, p, 2), dtype=torch.int64, device=dev)
    lib = _cuda.load("select_binspread")
    variant = route(t, f)
    ptrs = [_cuda.ptr(planes), _cuda.ptr(need), _cuda.ptr(valid_frames),
            _cuda.ptr(flat), _cuda.ptr(keys)]
    if variant == "cluster":
        fn = _cuda.declare(lib, "tsr_selbin_cluster", 5, 6)
    else:
        scratch = torch.empty((4 * p * b * 512 + p * b * 6,), dtype=torch.int32, device=dev)
        ptrs.append(_cuda.ptr(scratch))
        fn = _cuda.declare(lib, "tsr_selbin_multipass", 6, 6)
    err = fn(*ptrs, p, b, t, f, spread_freq, spread_time, _cuda.stream_ptr(dev))
    _cuda.check(lib, err, f"{NAME} ({variant})")
    _cuda.count_launch(NAME)
    route_launches[variant] += 1
    return flat, keys
