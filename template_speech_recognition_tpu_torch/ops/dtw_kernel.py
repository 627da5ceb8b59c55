"""Banded DTW, from the LLR tile to the score, batched over (segment,
template) pairs.

Replaces ``template_speech_recognition_tpu/ops/dtw_pallas.py``
``_banded_dtw_packed`` (``_kernel_packed``; its ``pallas_call`` at line
688, the default for L <= 64) and ``banded_dtw_pallas``'s ``"full"`` /
``"band"`` layouts (``_kernel_full``, ``_kernel_band``; ``pallas_call``
at line 474, L > 64), with the reference's elementwise work around them
(``align/dtw.py``: the cost ``-(llr + c)`` and the score): one
recurrence, one kernel.

    cost[n, i, j] = -(llr[n, i, j] + c_tab[cid(n), i])
    D[i, j] = cost[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])
    score[n] = -D[L-1, seg_len-1] / (L + seg_len)   (-inf where D > 1e37)

over the band ``|j*lm1 - i*mm1| <= band*lm1`` (``lm1 = max(L-1, 1)``,
``mm1 = max(seg_len-1, 1)``, integers), cells with ``j >= seg_len``
out, ``D[0, 0] = cost[0, 0]``; out-of-band and unreachable cells hold
3e38, a finite stand-in for +inf, as the TPU kernel's do.

Two entries, one kernel (``csrc/banded_dtw.cu``):

* ``banded_dtw_scores(llr, seg_lens, c_tab, band, cid=None)``: the
  routes' entry.  ``llr`` is ``[N, L, M]``, or ``[B, Q, L, M]`` with
  pair n = b*Q + q sharing ``seg_lens[b]``; any strides (the exhaustive
  route passes a permuted view of its GEMM output).  ``cid(n)`` is
  ``cid[n]``, or ``n % G`` for ``c_tab`` of G rows.
* ``banded_dtw(cost, seg_lens, band)``: raw mode, a cost tile in and
  terminal costs ``D[L-1, seg_len-1]`` out.

CUDA design: the band on the lanes (a pair takes the power of two >=
W + 1 lanes, W = min(2*band+1, L) and a spare position, at most 32, so
two pairs share a warp at band 6; past 32 positions R registers a
lane), ``ilo`` stepped by the reference's rule, two shuffles a diagonal
with no mask, each diagonal's loads issued a step ahead of the chain.
Staging: where a pair's tile is one contiguous aligned block that fits
(``whole_tile``: the map and gathered routes at the scan's shapes), the
whole tile by one bulk asynchronous copy; else its in-band cells by
4-byte ``cp.async`` in band-skewed chunks of 32/R diagonals through a
ring of 3 chunks a warp.  The fused mode's c words by ``cp.async``: the
pair's whole c row with its tile or its first chunk where L <=
``C_ROW_LENGTH``; past it, through the ring, a span of WP + CK c rows a
chunk (from the first in-band row of its first diagonal, which holds
every row its in-band cells read), so shared memory does not grow with
L.  Those routes take up to ``MAX_WINDOW`` in-band rows a diagonal,
min(2*band+1, L) (R <= 16 registers a lane).  Past it (or where the
band expressions leave int32) the wide route: one pair a block, the
window's positions over up to 1024 threads, each diagonal's D and
min(D, up) exchanged through shared memory (or, for a window past
12,288 positions, a scratch buffer the wrapper allocates) under one
block barrier a diagonal, the cells and c words read in place
(``wide_schedule``).  So any L >= 1 and band >= 0.
``banded_dtw_emulated`` repeats those schedules in PyTorch (lanes,
registers, shuffles, ring slots, whole tiles; the wide route's
positions and buffers) for the CPU tests.  Terminals and scores are
bitwise those of the plain versions.

What bounds it on the H100: the chain of L + seg_len - 1 dependent
diagonals a pair (69 at the scan's shapes), not bytes (1.4 MB of
in-band cells, 0.0004 ms at 3.35 TB/s) or operations; on the wide
route, a block barrier and a cached read a diagonal.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda

NAME = "banded_dtw"
SOURCE = "template_speech_recognition_tpu_torch/csrc/banded_dtw.cu"
REPLACES = "template_speech_recognition_tpu/ops/dtw_pallas.py:688"
UNREACHABLE = 3.0e38
MAX_WINDOW = 511
# csrc/banded_dtw.cu's constants
WARPS, STAGES, STAGE_WORDS, TILE_WORDS = 4, 3, 1024, 6144
C_ROW_LENGTH, C_STAGE_WORDS = 256, 544
WIDE_MAX_THREADS, WIDE_SMEM_WORDS = 1024, 4 * (12288 + 2)


def banded_dtw_plain(cost: torch.Tensor, seg_lens: torch.Tensor,
                     band: int) -> torch.Tensor:
    """Plain PyTorch version: a loop over the L + M - 1 diagonals,
    vectorised over pairs and template rows."""
    n, length, m = cost.shape
    dev = cost.device
    cost = cost.to(torch.float32)
    lens = seg_lens.to(device=dev, dtype=torch.int64)[:, None]          # [N, 1]
    i = torch.arange(length, device=dev)[None, :]                       # [1, L]
    lm1 = max(length - 1, 1)
    mm1 = torch.clamp(lens - 1, min=1)
    jlim = torch.clamp(lens, max=m)
    final_k = length - 1 + lens[:, 0] - 1                               # [N]
    unreachable = torch.full((n, 1), UNREACHABLE, device=dev)
    prev = torch.full((n, length), UNREACHABLE, device=dev)
    prev2 = prev.clone()
    out = torch.full((n,), UNREACHABLE, device=dev)
    for k in range(length + m - 1):
        j = k - i                                                       # [1, L]
        valid = (j >= 0) & (j < jlim) & ((j * lm1 - i * mm1).abs() <= band * lm1)
        idx = j.clamp(0, m - 1).expand(n, length)[:, :, None]
        cost_d = torch.gather(cost, 2, idx)[:, :, 0]                    # [N, L]
        up = torch.cat([unreachable, prev[:, :-1]], dim=1)              # D[i-1, j]
        up2 = torch.cat([unreachable, prev2[:, :-1]], dim=1)            # D[i-1, j-1]
        best = torch.minimum(torch.minimum(up, prev), up2)
        best = torch.where((i == 0) & (j == 0), 0.0, best)
        diag = torch.minimum(
            torch.where(valid, cost_d + best, UNREACHABLE), unreachable
        )
        out = torch.where(final_k == k, diag[:, -1], out)
        prev2, prev = prev, diag
    return out


def _as_pairs(llr: torch.Tensor) -> torch.Tensor:
    """[N, L, M] -> [N, 1, L, M]; [B, Q, L, M] as it is (a view)."""
    if llr.dim() == 3:
        return llr[:, None]
    if llr.dim() != 4:
        raise ValueError(f"llr must be [N, L, M] or [B, Q, L, M], got {tuple(llr.shape)}")
    return llr


def scores_from_terminals(total: torch.Tensor, seg_lens: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """-D / (L + seg_len), -inf where the terminal is unreachable."""
    scores = -total / (num_rows + seg_lens).to(torch.float32)
    return torch.where(total > 1e37, float("-inf"), scores)


def banded_dtw_scores_plain(llr: torch.Tensor, seg_lens: torch.Tensor,
                            c_tab: torch.Tensor, band: int,
                            cid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``banded_dtw_scores``: the cost prologue,
    ``banded_dtw_plain`` and the score, as the routes composed them."""
    llr4 = _as_pairs(llr)
    nb, inner, length, m = llr4.shape
    n = nb * inner
    dev = llr4.device
    rows = (torch.arange(n, device=dev) % c_tab.shape[0]) if cid is None else cid.long()
    c = c_tab.to(torch.float32)[rows].reshape(nb, inner, length, 1)
    cost = -(llr4.to(torch.float32) + c)
    lens = seg_lens.to(device=dev, dtype=torch.int64)
    lens = lens.repeat_interleave(inner) if inner > 1 else lens
    total = banded_dtw_plain(cost.reshape(n, length, m), lens, band)
    return scores_from_terminals(total, lens, length).reshape(llr.shape[:-2])


def _launch(llr4, seg_lens, c_tab, cid, band, fused, lib=None):
    """One launch of the kernel (``lib``: a build of ``csrc/banded_dtw.cu``
    other than the package's, for the probe)."""
    nb, inner, length, m = llr4.shape
    n = nb * inner
    out = torch.empty((n,), dtype=torch.float32, device=llr4.device)
    if n == 0:
        return out
    # |j*lm1 - i*mm1| never exceeds (L + M) * lm1: a wider band is the
    # same band, and the clamp keeps the kernel's integer products in int32
    band = min(band, length + m)
    # the wide route's state, where it does not fit shared memory
    words = wide_schedule(length, m, band)["scratch_words"] if is_wide(length, m, band) else 0
    scratch = torch.empty((n * words,), dtype=torch.float32, device=llr4.device) if words else None
    lib = lib or _cuda.load("banded_dtw")
    fn = _cuda.declare(lib, "tsr_banded_dtw", 6, 6, 4)
    s_b, s_q, s_i, s_j = llr4.stride()
    err = fn(
        _cuda.ptr(llr4), _cuda.ptr(c_tab if fused else None), _cuda.ptr(cid),
        _cuda.ptr(seg_lens), _cuda.ptr(out), _cuda.ptr(scratch), s_b, s_q, s_i, s_j,
        n, inner, length, m, c_tab.shape[0] if fused else 0, band,
        _cuda.stream_ptr(llr4.device),
    )
    _cuda.check(lib, err, NAME)
    _cuda.count_launch(NAME)
    return out


def _check_length(length: int, band: int) -> None:
    if length < 1:
        raise ValueError(f"L={length}: the kernel takes L >= 1")
    if band < 0:
        raise ValueError(f"band must be >= 0, got {band}")


def is_wide(length: int, m: int, band: int) -> bool:
    """Whether ``tsr_banded_dtw`` takes the wide route (band clamped to
    L + M): more than ``MAX_WINDOW`` in-band rows a diagonal,
    min(2*band+1, L), or band expressions past int32."""
    band = min(band, length + m)
    return (min(2 * band + 1, length) > MAX_WINDOW
            or (length + m + band) * max(length - 1, 1) >= 2**31)


def wide_schedule(length: int, m: int, band: int) -> dict:
    """The wide route's layout (as ``launch_wide`` sets it): WP window
    positions (min(2*band+1, L, M) and a spare one), T threads a pair
    (position w in thread w % T), and the scratch words a pair where its
    state, 4 * (WP + 2) words, does not fit ``WIDE_SMEM_WORDS`` (else
    0: the state in shared memory)."""
    band = min(band, length + m)
    wp = min(2 * band + 1, length, m) + 1
    state = 4 * (wp + 2)
    return {"WP": wp, "T": min(WIDE_MAX_THREADS, -(-wp // 32) * 32),
            "scratch_words": state if state > WIDE_SMEM_WORDS else 0}


def banded_dtw_scores(llr: torch.Tensor, seg_lens: torch.Tensor, c_tab: torch.Tensor,
                      band: int, cid: torch.Tensor | None = None) -> torch.Tensor:
    """llr [N, L, M] or [B, Q, L, M] f32 (any strides), seg_lens [N] or
    [B] int32 (1 <= seg_len <= M), c_tab [G, L] f32, cid [N] / [B*Q]
    int32 in [0, G) or None (pair n takes row n % G) -> scores [N] or
    [B, Q] f32 (-inf where unreachable).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (any L >= 1 and band >= 0),
    one launch."""
    tensors = [llr, seg_lens, c_tab] + ([] if cid is None else [cid])
    if _cuda.on_cpu(*tensors):
        return banded_dtw_scores_plain(llr, seg_lens, c_tab, band, cid)
    llr4 = _as_pairs(llr)
    if llr4.dtype != torch.float32:
        raise ValueError(f"llr: expected torch.float32, got {llr4.dtype}")
    nb, inner, length, _m = llr4.shape
    _check_length(length, band)
    _cuda.require(seg_lens, "seg_lens", torch.int32, 1)
    _cuda.require(c_tab, "c_tab", torch.float32, 2)
    if tuple(seg_lens.shape) != (nb,):
        raise ValueError(f"seg_lens must be [{nb}], got {tuple(seg_lens.shape)}")
    if c_tab.shape[1] != length or c_tab.shape[0] < 1:
        raise ValueError(f"c_tab must be [G >= 1, {length}], got {tuple(c_tab.shape)}")
    if cid is not None:
        _cuda.require(cid, "cid", torch.int32, 1)
        if cid.numel() != nb * inner:
            raise ValueError(f"cid must be [{nb * inner}], got {tuple(cid.shape)}")
    out = _launch(llr4, seg_lens, c_tab, cid, band, fused=True)
    return out.reshape(llr.shape[:-2])


def banded_dtw(cost: torch.Tensor, seg_lens: torch.Tensor, band: int) -> torch.Tensor:
    """cost [N, L, M] f32 + seg_lens [N] int32 (1 <= seg_len <= M) ->
    terminal costs [N] f32 (3e38 where unreachable): the kernel's raw
    mode.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (any L >= 1 and band >= 0)."""
    if _cuda.on_cpu(cost, seg_lens):
        return banded_dtw_plain(cost, seg_lens, band)
    _cuda.require(cost, "cost", torch.float32, 3)
    _cuda.require(seg_lens, "seg_lens", torch.int32, 1)
    n, length, _m = cost.shape
    _check_length(length, band)
    if tuple(seg_lens.shape) != (n,):
        raise ValueError(f"seg_lens must be [{n}], got {tuple(seg_lens.shape)}")
    return _launch(cost[:, None], seg_lens, None, None, band, fused=False)


def schedule(length: int, band: int) -> dict:
    """The kernel's layout for L rows and a (clamped) band: R registers
    a lane, G lanes a pair, CK diagonals a chunk, WP window positions a
    pair (W = min(2*band+1, L) and a spare one), PPW pairs a warp."""
    w = min(2 * band + 1, length) + 1
    if w <= 32:
        r, g = 1, 1
        while g < w:
            g *= 2
    else:
        r, g = 1, 32
        while 32 * r < w:
            r *= 2
    return {"R": r, "G": g, "CK": 32 // r, "WP": g if r == 1 else 32 * r,
            "NL": g if r == 1 else 32, "PPW": 32 // g if r == 1 else 1}


def whole_tile(llr4: torch.Tensor, band: int) -> bool:
    """The kernel's whole-tile mode (as ``tsr_banded_dtw`` decides it):
    one register a lane, each pair's [L, M] tile one contiguous, 16-byte
    aligned block, a warp's tiles within ``TILE_WORDS``."""
    nb, inner, length, m = llr4.shape
    s_b, s_q, s_i, s_j = llr4.stride()
    sc = schedule(length, min(band, length + m))
    words = length * m
    return (sc["R"] == 1 and s_j == 1 and s_i == m and (inner == 1 or s_q == words)
            and s_b == inner * words and words % 4 == 0 and llr4.data_ptr() % 16 == 0
            and sc["PPW"] * words <= TILE_WORDS)


def band_rows(k, jl, length: int, band: int):
    """[lo, hi] of the in-band rows of diagonal ``k`` (int64 tensors; the
    closed form of the reference's ``band_ilo``, as the kernel stages)."""
    lm1 = max(length - 1, 1)
    den = lm1 + torch.clamp(jl - 1, min=1)
    num = (k - band) * lm1
    lo = torch.where(num > 0, (num + den - 1) // den, torch.zeros_like(num))
    lo = torch.maximum(lo, k - (jl - 1))
    hi = torch.minimum(torch.clamp(k, max=length - 1), (k + band) * lm1 // den)
    return lo, hi


def banded_dtw_emulated(llr: torch.Tensor, seg_lens: torch.Tensor, band: int,
                        c_tab: torch.Tensor | None = None,
                        cid: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel's schedule in PyTorch, for the CPU tests: warps of
    ``PPW`` pairs, lanes and registers, the incremental ``ilo``, the two
    shuffles a diagonal (and the register wrap past 32 positions) with no
    mask at the window's ends, +inf for out-of-band cells, D[0, 0]
    through position 0's seeded Q (no test of the cell), each lane's
    share of the staging into a ring of ``STAGES`` band-skewed chunks per
    warp (filled with NaN first, never cleared) or, where ``whole_tile``
    holds, the tile read in place; in the fused mode the pair's whole c
    row, or through the ring past L = ``C_ROW_LENGTH`` each chunk's span
    of WP + CK c rows in a ring of its own (also NaN first); the warp's
    loop to its last pair's terminal diagonal.  Raw mode (``c_tab`` None): terminals;
    else scores, as ``banded_dtw_scores``."""
    fused = c_tab is not None
    llr4 = _as_pairs(llr)
    nb, inner, length, m = llr4.shape
    n = nb * inner
    if n == 0:
        return torch.zeros(llr.shape[:-2] if fused else (0,), dtype=torch.float32)
    band = min(band, length + m)
    if is_wide(length, m, band):
        return _wide_emulated(llr, seg_lens, band, c_tab, cid)
    sc = schedule(length, band)
    r_, g_, ck, wp, nl, ppw = (sc[k] for k in ("R", "G", "CK", "WP", "NL", "PPW"))
    lm1 = max(length - 1, 1)
    n_warps = -(-n // ppw)
    lane = torch.arange(32)
    slot, t = lane // nl, lane % nl
    pair = torch.arange(n_warps)[:, None] * ppw + slot[None, :]          # [W, 32]
    active = pair < n
    pc = pair.clamp(max=n - 1)
    lens = seg_lens.to(torch.int64)
    mlen = torch.where(active, lens[pc // inner], torch.zeros_like(pc))
    kmax = torch.where(active & (mlen >= 1) & (mlen <= m), length + mlen - 2, -1)
    jl = torch.where(kmax >= 0, mlen, torch.zeros_like(mlen))
    mm1 = torch.clamp(mlen - 1, min=1)
    bw = band * lm1
    kend = kmax.amax(dim=1)                                              # [W]
    nch = torch.where(kend >= 0, kend // ck + 1, torch.zeros_like(kend))
    # the kernel's addressing: the storage read through the strides
    s_b, s_q, s_i, s_j = llr4.stride()
    span = 1 + sum((size - 1) * st for size, st in zip(llr4.shape, llr4.stride()))
    flat = torch.as_strided(llr4, (span,), (1,))
    origin = (pc // inner) * s_b + (pc % inner) * s_q                    # [W, 32]
    if fused:
        rows = (pc % c_tab.shape[0]) if cid is None else cid.long()[pc]
        crow = c_tab.to(torch.float32)[rows]                             # [W, 32, L]
    ring = torch.full((n_warps, STAGES * STAGE_WORDS), float("nan"))
    tile = whole_tile(llr4, band)
    cchunk = fused and not tile and length > C_ROW_LENGTH
    cspan = wp + ck
    cring = torch.full((n_warps, STAGES * C_STAGE_WORDS), float("nan"))

    def stage(ch):
        """Each lane's copies for chunk ``ch`` into ring slot ch % STAGES
        (whole-tile mode: none; the chain reads the tile)."""
        if tile:
            return
        if cchunk:
            # the chunk's c rows [lo, lo + cspan) from its first
            # diagonal's first in-band row, rows past L not read
            lo, _hi = band_rows(torch.full_like(pc, ch * ck), jl, length, band)
            run_c = (ch < nch)[:, None] & (ch * ck <= kmax) & (t == 0)[None, :]
            cbase = (ch % STAGES) * C_STAGE_WORDS + slot * cspan              # [32]
            for u in range(cspan):
                take = run_c & (lo + u < length)
                if bool(take.any()):
                    wi, li = torch.nonzero(take, as_tuple=True)
                    cring[wi, cbase[li] + u] = crow[wi, li, (lo + u)[wi, li]]
        base = (ch % STAGES) * STAGE_WORDS + slot * wp                   # [32]
        if r_ == 1:
            per_lane = [(kk, 0, 1) for kk in range(ck)]                  # lane kk % nl
            owners = [kk % nl for kk in range(ck)]
        else:
            per_lane = [(tt // r_, tt % r_, r_) for tt in range(32)]
            owners = list(range(32))
        for (kk, w0, ws), owner in zip(per_lane, owners):
            lanes = t == owner                                           # [32]
            run = (ch < nch)[:, None] & lanes[None, :]                   # [W, 32]
            k = ch * ck + kk
            kk_t = torch.full_like(pc, k)
            lo, hi = band_rows(kk_t, jl, length, band)
            # as the kernel: positions while the row is in band, unbounded
            # by the window (a window too narrow would spill into the next
            # pair's slot, or past the ring)
            top = int(torch.where(run & (k <= kmax), hi - lo + 1, 0).max())
            for w in range(w0, top, ws):
                i = lo + w
                take = run & (k <= kmax) & (i <= hi)
                if not bool(take.any()):
                    continue
                src = origin + i.clamp(0, length - 1) * s_i + (k - i).clamp(0, m - 1) * s_j
                dst = base + kk * 32 * r_ + w                            # [32]
                wi, li = torch.nonzero(take, as_tuple=True)
                ring[wi, dst[li]] = flat[src[wi, li]]

    for s in range(STAGES - 1):
        stage(s)
    p_reg = torch.full((n_warps, r_, 32), UNREACHABLE)
    q_reg = p_reg.clone()
    q_reg[:, 0, t == 0] = 0.0           # D[0, 0] reads min(D[-1, 0], 0) = 0
    # the window's state (ilo, j0 = k - ilo, e = j0*lm1 - ilo*mm1, a =
    # ilo*M + j0), stepped as the kernel steps it
    ilo = torch.zeros_like(pc)
    j0, e, a = ilo.clone(), ilo.clone(), ilo.clone()
    d = torch.zeros_like(pc)
    den = lm1 + mm1
    term = torch.full((n_warps, 32), UNREACHABLE)
    regs = torch.arange(r_)[:, None]
    pos = (t[None, :] if r_ == 1 else 32 * regs + lane[None, :])          # [R, 32]
    unreach = torch.tensor(UNREACHABLE)
    for ch in range(int(nch.max()) if n_warps else 0):
        stage(ch + STAGES - 1)
        k0 = ch * ck
        clo = ilo.clone()          # the chunk's c rows start at its first ilo
        for kk in range(ck):
            k = k0 + kk
            run = (ch < nch) & (k <= kend)                               # [W]
            if not bool(run.any()):
                break
            # the two shuffles wrap around the window with no mask (its
            # spare top position is never in band)
            if r_ == 1:
                grp = (slot * g_)[None, :]
                up = torch.gather(p_reg[:, 0], 1, grp + ((t[None, :] + d - 1) & (g_ - 1)))
                lq = torch.gather(q_reg[:, 0], 1, grp + ((t[None, :] + d) & (g_ - 1)))
                up, lq = up[:, None], lq[:, None]
            else:
                dw = d[:, :1, None].bool()                               # warp-uniform
                nxt, prv = (regs[:, 0] + 1) % r_, (regs[:, 0] + r_ - 1) % r_
                send_q = torch.where(lane == 0, q_reg[:, nxt], q_reg)
                send_p = torch.where(lane == 31, p_reg[:, prv], p_reg)
                up = torch.where(dw, p_reg, send_p[:, :, (lane + 31) & 31])
                lq = torch.where(dw, send_q[:, :, (lane + 1) & 31], q_reg)
            # the cells: the integer test through the window's state
            i = ilo[:, None, :] + pos[None]                              # [W, R, 32]
            jj = j0[:, None, :] - pos[None]
            band_x = e[:, None, :] - pos[None] * den[:, None, :] + bw
            valid = ((i < length) & (jj >= 0) & (jj < jl[:, None, :])
                     & (band_x >= 0) & (band_x <= 2 * bw))
            best = torch.minimum(up, lq)
            if tile:       # the cell read in place, where it is in band
                cell = origin[:, None, :] + a[:, None, :] + pos[None] * (m - 1)
                x = torch.where(valid, flat[cell.clamp(0, span - 1)], 0.0)
            else:
                slot_base = (ch % STAGES) * STAGE_WORDS + kk * 32 * r_
                x = ring[:, slot_base + (lane[None, :] if r_ == 1 else 32 * regs + lane[None, :])]
            if fused and not cchunk:
                c = torch.gather(crow, 2, torch.where(valid, i, 0).permute(0, 2, 1))
                x = -(x + c.permute(0, 2, 1))
            elif fused:    # the chunk's c rows, from its first row clo
                cidx = torch.where(valid, i - clo[:, None, :], 0)
                cidx = (ch % STAGES) * C_STAGE_WORDS + slot[None, None, :] * cspan + cidx
                x = -(x + torch.gather(cring, 1, cidx.reshape(n_warps, -1)).reshape(x.shape))
            # an out-of-band cell adds +inf: min(inf + best, 3e38) = 3e38
            x = torch.where(valid, x, float("inf"))
            v = torch.minimum(x + best, unreach)
            q_new, p_new = torch.minimum(v, up), v
            keep = run[:, None, None]
            q_reg = torch.where(keep, q_new, q_reg)
            p_reg = torch.where(keep, p_new, p_reg)
            # the terminal: position 0 on its diagonal (a row past L-1
            # there is out of band, so unreachable)
            term = torch.where(run[:, None] & (k == kmax), p_new[:, 0], term)
            # the window steps to diagonal k+1 by the reference's rule
            step = ((j0 + 1 >= jl) | (e + lm1 > bw)).long()
            keep2 = run[:, None]
            d = torch.where(keep2, step, d)
            ilo = torch.where(keep2, ilo + step, ilo)
            j0 = torch.where(keep2, j0 + 1 - step, j0)
            e = torch.where(keep2, e + lm1 - step * den, e)
            a = torch.where(keep2, a + 1 + step * (m - 1), a)
    # lane t == 0 of each pair holds its terminal (position 0)
    first = active & (t[None, :] == 0)
    total = term[first]
    if not fused:
        return total
    lens_n = lens.repeat_interleave(inner) if inner > 1 else lens
    return scores_from_terminals(total, lens_n, length).reshape(llr.shape[:-2])


def _wide_emulated(llr, seg_lens, band, c_tab=None, cid=None):
    """The wide route's schedule in PyTorch (``banded_dtw_emulated``
    past ``MAX_WINDOW``): one pair a block, window positions [0, WP) of
    ``wide_schedule``, each diagonal's D and Q = min(D, up) in a buffer
    of WP + 2 words (positions -1 and WP unreachable, never written),
    two buffers by the diagonal's parity (diagonal -1's Q 0 at position
    0), up = D[w + d - 1] and lq = Q[w + d] of the diagonal before, the
    cell read through the strides where it is in band (+inf elsewhere),
    the window stepped by the reference's rule with the band expression
    exact; each pair's loop to its own terminal diagonal."""
    fused = c_tab is not None
    llr4 = _as_pairs(llr)
    nb, inner, length, m = llr4.shape
    n = nb * inner
    band = min(band, length + m)
    wp = wide_schedule(length, m, band)["WP"]
    pair = torch.arange(n)
    lens = seg_lens.to(torch.int64)
    mlen = lens[pair // inner]
    kmax = torch.where((mlen >= 1) & (mlen <= m), length + mlen - 2, -1)
    lm1 = max(length - 1, 1)
    den = lm1 + torch.clamp(mlen - 1, min=1)
    bw = band * lm1
    s_b, s_q, s_i, s_j = llr4.stride()
    span = 1 + sum((size - 1) * st for size, st in zip(llr4.shape, llr4.stride()))
    flat = torch.as_strided(llr4, (span,), (1,))
    origin = (pair // inner) * s_b + (pair % inner) * s_q                   # [N]
    if fused:
        rows = (pair % c_tab.shape[0]) if cid is None else cid.long()
        crow = c_tab.to(torch.float32)[rows]                                # [N, L]
    # st[parity, 0 / 1 (P / Q), pair, word]: word w + 1 holds position w
    st = torch.full((2, 2, n, wp + 2), UNREACHABLE)
    st[1, 1, :, 1] = 0.0
    w = torch.arange(wp)[None, :]
    ilo = torch.zeros(n, dtype=torch.int64)
    j0, e, d = ilo.clone(), ilo.clone(), ilo.clone()
    term = torch.full((n,), UNREACHABLE)
    unreach = torch.tensor(UNREACHABLE)
    for k in range(int(kmax.max()) + 1 if n else 0):
        run = k <= kmax                                                     # [N]
        prev, cur = st[(k + 1) % 2], st[k % 2]
        up = torch.gather(prev[0], 1, w + d[:, None])
        lq = torch.gather(prev[1], 1, w + d[:, None] + 1)
        i = ilo[:, None] + w
        j = j0[:, None] - w
        xb = e[:, None] - w * den[:, None] + bw
        ok = (i < length) & (j >= 0) & (j < mlen[:, None]) & (xb >= 0) & (xb <= 2 * bw)
        cell = origin[:, None] + i.clamp(0, length - 1) * s_i + j.clamp(0, m - 1) * s_j
        x = flat[cell.clamp(0, span - 1)]
        if fused:
            x = -(x + torch.gather(crow, 1, i.clamp(0, length - 1)))
        c = torch.where(ok, x, float("inf"))
        v = torch.minimum(c + torch.minimum(up, lq), unreach)
        keep = run[:, None]
        cur[0, :, 1 : wp + 1] = torch.where(keep, v, cur[0, :, 1 : wp + 1])
        cur[1, :, 1 : wp + 1] = torch.where(keep, torch.minimum(v, up), cur[1, :, 1 : wp + 1])
        term = torch.where(run & (k == kmax), v[:, 0], term)
        step = ((j0 >= mlen - 1) | (e > bw - lm1)).long()
        d = torch.where(run, step, d)
        ilo = torch.where(run, ilo + step, ilo)
        j0 = torch.where(run, j0 + 1 - step, j0)
        e = torch.where(run, e + lm1 - step * den, e)
    if not fused:
        return term
    lens_n = lens.repeat_interleave(inner) if inner > 1 else lens
    return scores_from_terminals(term, lens_n, length).reshape(llr.shape[:-2])
