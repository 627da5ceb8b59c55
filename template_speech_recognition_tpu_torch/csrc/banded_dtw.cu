// Banded DTW, from the LLR tile to the score, one launch for every route
// of the DTW rescore.
//
// Replaces template_speech_recognition_tpu/ops/dtw_pallas.py
//   _banded_dtw_packed (_kernel_packed; pallas_call at line 688), the
//   default for L <= 64, and banded_dtw_pallas's "full"/"band" layouts
//   (_kernel_full, _kernel_band; pallas_call at line 474) for L > 64,
// together with the elementwise work around them in the reference's
// align/dtw.py (the cost prologue -(llr + c) and the score epilogue).
//
//   cost[n, i, j] = -(llr[n, i, j] + c_tab[cid(n), i])   (fused mode)
//                 =   llr[n, i, j]                        (raw mode)
//   D[i, j] = cost[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])
//   in band:  |j*lm1 - i*mm1| <= band*lm1,  lm1 = max(L-1, 1),
//             mm1 = max(seg_len-1, 1);  cells with j >= seg_len are out;
//   D[0, 0] = cost[0, 0];  out-of-band / unreachable cells = 3e38.
//   raw mode:   out[n] = D[L-1, seg_len-1]
//   fused mode: out[n] = -D[L-1, seg_len-1] / (L + seg_len), -inf where
//               D > 1e37
//
// Pair n = b*inner + q reads cell (i, j) at llr + b*s_b + q*s_q + i*s_i
// + j*s_j: the map and gathered routes pass their [N, L, m] tiles, the
// exhaustive route the GEMM's [nb, M, K, L] output as it lies (a strided
// view, no copy).  seg_lens is indexed by b (a segment's pairs share
// it); cid(n) = cid[n], or n % n_rows when no index is given.
//
// Layout: the band on the lanes, as the reference's band layout lays it
// out (dtw_pallas.py band_ilo / band_skew_cost / _kernel_band).  On
// anti-diagonal k the in-band rows are one interval [ilo(k), ihi(k)] of
// at most W = min(2*band+1, L) rows; position w of a pair's window holds
// row ilo(k)+w, and the window has one spare position above W.  A pair
// takes G lanes (the power of two >= W+1, at most 32), so several pairs
// share a warp (two at the scan's band 6, up to band 7); past 32
// positions a pair takes the warp and R registers a lane (position
// 32r+lane).  ilo steps by d in {0, 1} a diagonal, by the reference's
// rule, with the band expression j*lm1 - i*mm1 of position 0 carried
// along, so each cell's band test stays the exact integer test at a few
// operations a step.  D[i-1, j] is then position w+d-1 of diagonal k-1,
// D[i, j-1] position w+d, and D[i-1, j-1] the D[i-1, .] that position
// w+d read a step before: each lane publishes its D and min(D, its up),
// and a step is two shuffles, three fminf and an add.  The spare position
// is never in band, so a shuffle that wraps around the window reads an
// unreachable value (or feeds only the spare position) and needs no
// mask; an out-of-band cell adds +inf, so no select sits on the chain.
// The loop issues a diagonal's shuffles first and, while they fly, the
// next diagonal's ilo step, band test and shared-memory loads, which it
// uses a step later.
//
// Staging, two ways, chosen from the layout:
// - whole tile: a pair whose [L, M] tile is one contiguous, 16-byte
//   aligned block, with at most TILE_WORDS a warp (the map and gathered
//   routes at the scan's shapes), takes it by one bulk asynchronous copy
//   (the TMA engine, no tensor map) on the warp's mbarrier; the chain
//   reads it in place (lanes 4*(M-1) bytes apart: no bank conflict).
// - a ring of chunks (long segments, L > 32 at band 6, the exhaustive
//   GEMM view): 32/R diagonals a chunk in band-skewed form
//   (stage[kk][pair slot][w]) by 4-byte cp.async, a ring of 3 chunks a
//   warp, so a pair's first three chunks are in flight at once and a
//   chunk's copies fly while the chain runs two chunks behind; shared
//   memory does not grow with the segment length.  A lane stages whole
//   diagonals (their [ilo, ihi] from the closed form of band_ilo, two
//   integer divisions each); out-of-band and past-seg_len cells read
//   nothing.  The band-skewed layout gives the chain one conflict-free
//   word a lane a step, and makes every copy 4 bytes (a 16-byte run of a
//   row spans four diagonals): one request a cell, which is why the
//   whole tile goes by one copy where it can.
// The fused mode's c words: where L <= C_ROW_LENGTH (and always with a
// whole tile), the pair's c row lands by cp.async with the first chunk
// or the tile; past it (the ring's CCHUNK mode), each chunk stages
// beside its cells the pair's c rows [lo, lo + WP + CK) (lo the chunk's
// first diagonal's first in-band row: every in-band row of the chunk's
// CK diagonals lies in that span), so shared memory does not grow with
// L.  Either way a step reads shared memory only.
//
// Arithmetic: one __fadd_rn for the prologue, an exact negation, exact
// fminf, one __fadd_rn and an IEEE division for the score, in the plain
// version's order, so finite terminals and scores are bitwise those of
// ops/dtw_kernel.py's plain versions on the same llr (fminf is exact
// in any order here: no D is NaN or -0.0).
//
// Windows past 32 x 16 positions (min(2*band+1, L) > 511) take the wide
// route below (banded_dtw_wide_kernel): one pair a block, the band over
// the block's threads, one block barrier a diagonal.
//
// What bounds it on the H100: neither bytes nor operations.  At the
// scan's shape (984 pairs, L 32, m 40, band 6) the in-band cells are
// 1.4 MB (0.0004 ms at 3.35 TB/s); the limit is the chain of
// L + seg_len - 1 dependent diagonals a pair (69), each two shuffles and
// four dependent float operations, behind the launch, each pair's setup
// and its first copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float UNREACHABLE = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
// probe switches (probe_banded_dtw.py): -DDTW_STAGES=N rings of N chunks;
// -DDTW_NO_TILE every pair through the ring; -DDTW_STAGE_ONLY the staging
// alone (each chunk or tile waited for and one word read, no chain);
// -DDTW_NO_COPY the ring issues no copy (wrong values: the chain without
// copies in flight); -DDTW_PROLOGUE_ONLY stops after each pair's setup;
// -DDTW_UNROLL=N unrolls the chain's loop N times (4); -DDTW_NO_C reads
// no c word (wrong values: the fused mode's cost of its c reads)
#ifndef DTW_STAGES
#define DTW_STAGES 3
#endif
#ifndef DTW_UNROLL
#define DTW_UNROLL 4
#endif

constexpr int WARPS = 4;             // warps a block; each warp runs on its own
constexpr int STAGES = DTW_STAGES;   // chunks in flight a warp
constexpr int UNROLL = DTW_UNROLL;   // the chain's loop, unrolled
constexpr int STAGE_WORDS = 1024;    // (32/R) diagonals x 32R positions
constexpr int TILE_WORDS = 6144;     // whole-tile mode: the warp's tiles, at most
// the ring's whole c rows: up to L = 256, 32 rows of 256 words a warp
// at most; past it, c rows a chunk: PPW pairs x (WP + CK) words, at
// most 16 x (2 + 32) (G 2) or 512 + 2 (R 16)
constexpr int C_ROW_LENGTH = 256;
constexpr int C_STAGE_WORDS = 544;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// one bulk copy (the TMA engine, no tensor map): bytes a multiple of 16,
// both ends 16-byte aligned; completes on the mbarrier
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct Pair {
  const float* src;    // the pair's llr origin
  int kmax;            // terminal diagonal, -1: no terminal cell
  int jl;              // seg_len, 0 for a pair with no terminal cell
  int mm1, den, bw;    // max(seg_len-1, 1), lm1 + mm1, band*lm1
};

// lo(k): the first in-band row of diagonal k (the closed form of the
// reference's band_ilo), for stage_diagonal and the ring's c rows
__device__ __forceinline__ int first_row(const Pair& p, int k, int band, int lm1) {
  const int num = (k - band) * lm1;
  const int lo = num > 0 ? (num + p.den - 1) / p.den : 0;
  return max(lo, k - (p.jl - 1));
}

// Stage diagonal k's in-band cells, positions w0, w0+ws, ..., into
// dst[w] (the closed form of the reference's band_ilo; [lo, hi] is
// exactly the set of rows that pass the integer band and range tests).
// Returns lo (-1 past the pair's terminal diagonal).
__device__ __forceinline__ int stage_diagonal(const Pair& p, float* dst, int k, int w0, int ws,
                                              int L, int lm1, int band, long long s_i,
                                              long long s_j) {
  if (k > p.kmax) return -1;
  const int lo = first_row(p, k, band, lm1);
  const int hi = min(min(L - 1, k), (k + band) * lm1 / p.den);
  for (int w = w0; lo + w <= hi; w += ws) {
    const int i = lo + w;
#ifdef DTW_NO_COPY
    asm volatile("" ::"l"(p.src + i * s_i + (long long)(k - i) * s_j), "l"(dst + w));
#else
    cp_async4(dst + w, p.src + i * s_i + (long long)(k - i) * s_j);
#endif
  }
  return lo;
}

// The window's state on diagonal k, the same in every lane of a pair:
// ilo = ilo(k), j0 = k - ilo (position 0's column), e = j0*lm1 - ilo*mm1
// (position 0's band expression; position w's is e - w*(lm1+mm1)), and
// a = ilo*M + j0 (position 0's word in a whole tile).
struct Win {
  int ilo, j0, e, a;
};

// A lane's constants for the chain's loop, worked out once: for each of
// its R positions w, band*lm1 - w*(lm1+mm1) (the band test is then
// (unsigned)(e + that) <= 2*band*lm1), L - w (i < L is ilo < L - w) and
// w*(M-1) (its word in a tile past position 0's); the ilo rule's
// thresholds; the shuffle sources for each step d.
template <int R>
struct Lanes {
  int band_off[R], l_lim[R], tile_off[R], pos[R];
  int bw2, jl1, bwl, e_up, a_up, up0, up1, lq0, lq1;
};

template <int R>
__device__ __forceinline__ Lanes<R> lanes_of(const Pair& p, int t, int lane, int G, int L,
                                             int lm1, int M) {
  Lanes<R> c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c.pos[r] = R == 1 ? t : 32 * r + lane;
    c.band_off[r] = p.bw - c.pos[r] * p.den;
    c.l_lim[r] = L - c.pos[r];
    c.tile_off[r] = c.pos[r] * (M - 1);
  }
  c.bw2 = 2 * p.bw;
  c.jl1 = p.jl - 1;
  c.bwl = p.bw - lm1;
  c.e_up = lm1 - p.den;
  c.a_up = M;
  c.up0 = (t - 1) & (G - 1);
  c.up1 = t;
  c.lq0 = t;
  c.lq1 = (t + 1) & (G - 1);
  return c;
}

// Step the window to diagonal k+1 by the reference's rule (ilo moves up
// when row ilo falls out of the band or past seg_len there); returns the
// step d in {0, 1}.
template <int R>
__device__ __forceinline__ int advance(Win& w, const Lanes<R>& c, int lm1) {
  const int d = (w.j0 >= c.jl1) || (w.e > c.bwl);
  w.ilo += d;
  w.j0 += 1 - d;
  w.e += d ? c.e_up : lm1;
  w.a += d ? c.a_up : 1;
  return d;
}

// Load the operands of the lane's R window positions on the window's
// diagonal: the LLR (or cost) word from the ring slot's row kk, or (TILE)
// from the pair's whole tile [L, M] in shared memory, the c row's word
// (fused mode), and whether the cell is in band: i < L, 0 <= j < seg_len
// and |j*lm1 - i*mm1| <= band*lm1, the integer test, with i = ilo + w,
// j = j0 - w and j*lm1 - i*mm1 = e - w*(lm1+mm1).  Indices are clamped
// rather than the loads predicated.
template <int R, bool FUSED, bool TILE>
__device__ __forceinline__ void load_at(float (&x)[R], float (&cr)[R], bool (&ok)[R],
                                        const Win& w, const Pair& p, const Lanes<R>& c,
                                        const float* sb, const float* crow, int kk, int lane,
                                        int clo) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ok[r] = w.ilo < c.l_lim[r] && (unsigned)(w.j0 - c.pos[r]) < (unsigned)p.jl &&
            (unsigned)(w.e + c.band_off[r]) <= (unsigned)c.bw2;
    // a ring row holds every pair slot of the warp: lane, not pos, for R = 1
    x[r] = sb[TILE ? (ok[r] ? w.a + c.tile_off[r] : 0)
                   : kk * 32 * R + (R == 1 ? lane : c.pos[r])];
#ifdef DTW_NO_C
    if (FUSED) cr[r] = 0.f;
#else
    // crow holds rows [clo, ...): the chunk's span (ring) or the whole
    // row (tile, clo 0)
    if (FUSED) cr[r] = crow[ok[r] ? w.ilo + c.pos[r] - clo : 0];
#endif
  }
}

// The cost of a loaded cell: -(llr + c) (fused mode) or the cost word,
// +inf where out of band (it then adds min(inf + best, 3e38) = 3e38).
template <int R, bool FUSED>
__device__ __forceinline__ void cost_of(float (&c)[R], const float (&x)[R], const float (&cr)[R],
                                        const bool (&ok)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    c[r] = ok[r] ? (FUSED ? -__fadd_rn(x[r], cr[r]) : x[r]) : __int_as_float(0x7f800000);
}

// Shared memory a warp, in words, 16-byte aligned: the ring of chunks or
// (whole-tile mode) its pairs' tiles, then (fused mode) their c rows, or
// (CCHUNK) the ring's c rows a chunk.
__host__ __device__ __forceinline__ int warp_words(bool tile, bool fused, bool cchunk, int ppw,
                                                   int L, int M) {
  const int data = tile ? ppw * L * M : STAGES * STAGE_WORDS;
  if (cchunk) return data + STAGES * C_STAGE_WORDS;
  return data + (fused ? (ppw * L + 3) / 4 * 4 : 0);
}

// The two shuffles of a diagonal: up = D[i-1, j] and lq = min(D[i, j-1],
// D[i-1, j-1]) from the diagonal before, whose P holds D and Q min(D,
// the D[i-1, .] it read); d = ilo(k) - ilo(k-1).  The window has a spare
// top position (never in band, so always unreachable): a shuffle that
// wraps past either end of the window reads an unreachable value or
// feeds only that position, and needs no mask.
template <int R>
__device__ __forceinline__ void shuffles(float (&up)[R], float (&lq)[R], const float (&P)[R],
                                         const float (&Q)[R], int d, const Lanes<R>& c,
                                         int lane, int G) {
  if (R == 1) {
    up[0] = __shfl_sync(FULL, P[0], d ? c.up1 : c.up0, G);
    lq[0] = __shfl_sync(FULL, Q[0], d ? c.lq1 : c.lq0, G);
  } else if (d) {   // one pair a warp: d is warp-uniform
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // position 32r+lane+1: lane+1's register r; lane 31 reads lane 0's
      // register r+1
      const float send = lane == 0 ? Q[(r + 1) % R] : Q[r];
      lq[r] = __shfl_sync(FULL, send, (lane + 1) & 31);
      up[r] = P[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // position 32r+lane-1: lane-1's register r; lane 0 reads lane 31's
      // register r-1 (for r = 0: the spare top position)
      const float send = lane == 31 ? P[(r + R - 1) % R] : P[r];
      up[r] = __shfl_sync(FULL, send, (lane + 31) & 31);
      lq[r] = Q[r];
    }
  }
}

template <int R, bool FUSED, bool TILE, bool CCHUNK>
__global__ void __launch_bounds__(WARPS * 32)
banded_dtw_kernel(const float* __restrict__ llr, const float* __restrict__ c_tab,
                  const int* __restrict__ cid, const int* __restrict__ seg_lens,
                  float* __restrict__ out, long long s_b, long long s_q, long long s_i,
                  long long s_j, int n_pairs, int inner, int L, int M, int n_rows, int band,
                  int G) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[WARPS];
  constexpr int CK = 32 / R;                 // diagonals a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nl = R == 1 ? G : 32;            // lanes a pair
  const int wp = R == 1 ? G : 32 * R;        // window positions a pair
  const int ppw = 32 / nl;                   // pairs a warp
  const int slot = lane / nl, t = lane - slot * nl;
  const int n = (blockIdx.x * WARPS + warp) * ppw + slot;
  const bool active = n < n_pairs;
  const int lm1 = max(L - 1, 1);
  const int words = warp_words(TILE, FUSED, CCHUNK, ppw, L, M);
  float* ring = smem + warp * words;          // the ring, or the warp's tiles
  // the c rows: the pair's whole row after the ring or the tiles, or
  // (CCHUNK) the ring's c stages (C_STAGE_WORDS each: a span of cspan
  // rows a pair slot)
  const int cspan = wp + CK;
  float* crow = ring + (TILE ? ppw * L * M : STAGES * STAGE_WORDS) + slot * L;
  float* cring = ring + STAGES * STAGE_WORDS + slot * cspan;
  float* tile = ring + slot * L * M;

  Pair p;
  p.src = llr;
  int mlen = 0, row = 0;
  if (active) {
    const int b = inner == 1 ? n : n / inner, q = n - b * inner;
    p.src = llr + b * s_b + q * s_q;
    mlen = seg_lens[b];
    if (FUSED) row = cid ? cid[n] : n % n_rows;
  }
  // a segment longer than the M llr columns has no terminal cell
  // (unreachable, as in the plain version)
  p.kmax = (active && mlen >= 1 && mlen <= M) ? L - 1 + mlen - 1 : -1;
  p.jl = p.kmax >= 0 ? mlen : 0;
  p.mm1 = max(mlen - 1, 1);
  p.den = lm1 + p.mm1;
  p.bw = band * lm1;
  const int kend = __reduce_max_sync(FULL, p.kmax);

  float term = UNREACHABLE;
#ifndef DTW_PROLOGUE_ONLY
  if (kend >= 0) {
    const int nch = kend / CK + 1;
    auto stage = [&](int ch) {   // the ring: chunk ch's copies, one commit group
      if (ch < nch) {
        float* base = ring + (ch % STAGES) * STAGE_WORDS + slot * wp;
        int lo = -1;              // lane t = 0: the chunk's first diagonal's
        if (R == 1) {
          for (int kk = t; kk < CK; kk += nl) {
            const int l = stage_diagonal(p, base + kk * 32 * R, ch * CK + kk, 0, 1, L, lm1,
                                         band, s_i, s_j);
            if (CCHUNK && kk == t) lo = l;
          }
        } else {
          const int kk = t / R;
          lo = stage_diagonal(p, base + kk * 32 * R, ch * CK + kk, t % R, R, L, lm1, band,
                              s_i, s_j);
        }
        if (CCHUNK) {
          // the c rows this chunk's in-band cells read, from the first
          // in-band row of its first diagonal (-1: the pair is done)
          lo = __shfl_sync(FULL, lo, 0, nl);
          float* cb = cring + (ch % STAGES) * C_STAGE_WORDS;
          for (int u = t; lo >= 0 && u < cspan && lo + u < L; u += nl)
            cp_async4(cb + u, c_tab + (long long)row * L + lo + u);
        }
      }
      cp_async_commit();
    };
    // the pair's c row lands with its first chunk (or its tile)
    if (FUSED && !CCHUNK && p.kmax >= 0)
      for (int i = t; i < L; i += nl) cp_async4(crow + i, c_tab + (long long)row * L + i);
    if (TILE) {
      // the pairs' whole tiles, one bulk copy each, on the warp's mbarrier
      const uint32_t bar = smem_addr(&bars[warp]);
      const uint32_t bytes = p.kmax >= 0 ? (uint32_t)(L * M * sizeof(float)) : 0u;
      const uint32_t total = __reduce_add_sync(FULL, t == 0 ? bytes : 0u);
      if (lane == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"(total) : "memory");
      }
      __syncwarp();
      if (t == 0 && bytes) bulk_copy(tile, p.src, bytes, bar);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(bar, 0);
      __syncwarp();
    } else {
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) stage(s);
    }

    // D[0, 0] = cost[0, 0]: position 0's Q starts at 0, so diagonal 0
    // reads min(D[-1, 0], 0) = 0 there; every other operand starts
    // unreachable
    float P[R], Q[R], x[R], cr[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) P[r] = Q[r] = cr[r] = UNREACHABLE;
    if (t == 0) Q[0] = 0.f;
    Win win = {0, 0, 0, 0};   // diagonal 0: ilo 0, and D[0, 0] on position 0
    int d = 0;                // ilo(k) - ilo(k-1)
    const Lanes<R> lc = lanes_of<R>(p, t, lane, G, L, lm1, M);
    for (int ch = 0; ch < nch; ++ch) {
      if (!TILE) {
        stage(ch + STAGES - 1);
        cp_async_wait<STAGES - 1>();
        __syncwarp();
      }
      const float* sb = TILE ? tile : ring + (ch % STAGES) * STAGE_WORDS;
      const float* cb = CCHUNK ? cring + (ch % STAGES) * C_STAGE_WORDS : crow;
      // CCHUNK: the chunk's c rows start at its first row, ilo there (the
      // closed form the staging used, as the window steps it)
      const int clo = CCHUNK ? win.ilo : 0;
#ifdef DTW_STAGE_ONLY
      term = fminf(term, sb[lane]);
      __syncwarp();
      continue;
#endif
      const int k0 = ch * CK, kn = min(CK, kend - k0 + 1);
      load_at<R, FUSED, TILE>(x, cr, ok, win, p, lc, sb, cb, 0, lane, clo);
#pragma unroll UNROLL
      for (int kk = 0; kk < kn; ++kk) {
        // the chain: the shuffles go first, then the work of the next
        // diagonal while they fly, then three fminf and an add
        float up[R], lq[R], c[R];
        shuffles<R>(up, lq, P, Q, d, lc, lane, G);
        cost_of<R, FUSED>(c, x, cr, ok);
        // the next diagonal's window and loads, used a step later (a
        // chunk's last step loads a row it does not use)
        d = advance<R>(win, lc, lm1);
        load_at<R, FUSED, TILE>(x, cr, ok, win, p, lc, sb, cb, min(kk + 1, CK - 1), lane, clo);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = fminf(__fadd_rn(c[r], fminf(up[r], lq[r])), UNREACHABLE);
          Q[r] = fminf(v, up[r]);
          P[r] = v;
        }
        // the terminal cell (L-1, seg_len-1) is position 0 of its
        // diagonal when it is in band (ilo there is at least L-1; past
        // it, position 0's row is past L-1 and unreachable)
        if (k0 + kk == p.kmax) term = P[0];
      }
      __syncwarp();
    }
  }
#endif
  if (active && t == 0) {
    if (FUSED)
      out[n] = term > 1e37f ? -__int_as_float(0x7f800000) : -term / (float)(L + mlen);
    else
      out[n] = term;
  }
}

// The wide route: a window past 32 x 16 positions (min(2*band+1, L) >
// 511), or band expressions past int32.  One pair a block, the window's
// positions [0, WP) spread over the block's threads (position w in
// thread w % T), WP >= min(2*band+1, L, M) + 1: no diagonal has more
// in-band rows than that, nor (positions past seg_len - 1 hold j < 0)
// more than M, and the top position is spare, never in band.  A
// diagonal's D and Q = min(D, up) go to shared memory (or, past
// WIDE_SMEM_WORDS, to the pair's slice of a scratch buffer the wrapper
// allocates), double-buffered by diagonal, with an unreachable word at
// positions -1 and WP; one __syncthreads a diagonal.  A position reads
// up = D[w + d - 1] and lq = Q[w + d] of the diagonal before, the same
// operands the shuffles give the narrow route, and its cell straight
// from the tile (any strides) and its c word from c_tab, both through
// the read-only cache.  The window's state (ilo, j0, e) steps by the
// same rule, the band expression in 64 bits.  The same roundings in the
// same order as the narrow route: terminals bitwise the plain version's.
// Correctness first: the chain pays a block barrier and a cache read a
// diagonal.
constexpr int WIDE_MIN_WINDOW = 512;       // min(2*band+1, L) from which pairs go wide
constexpr int WIDE_MAX_THREADS = 1024;
constexpr int WIDE_SMEM_WORDS = 4 * (12288 + 2);   // state of WP <= 12,288 in shared memory

template <bool FUSED>
__global__ void __launch_bounds__(WIDE_MAX_THREADS)
banded_dtw_wide_kernel(const float* __restrict__ llr, const float* __restrict__ c_tab,
                       const int* __restrict__ cid, const int* __restrict__ seg_lens,
                       float* __restrict__ out, float* __restrict__ scratch, long long s_b,
                       long long s_q, long long s_i, long long s_j, int inner, int L, int M,
                       int n_rows, int band, int WP) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int stride = WP + 2;
  // [P, Q] of even diagonals, then of odd ones; word w + 1 holds
  // position w, words 0 and WP + 1 stay unreachable
  float* st = scratch ? scratch + (size_t)n * 4 * stride : smem;
  for (int u = tid; u < 4 * stride; u += T) st[u] = UNREACHABLE;
  __syncthreads();
  // D[0, 0] = cost[0, 0]: diagonal 0 reads Q of diagonal -1 (the odd
  // buffer) at position 0 as 0
  if (tid == 0) st[3 * stride + 1] = 0.f;

  const int b = inner == 1 ? n : n / inner, q = n - b * inner;
  const float* src = llr + b * s_b + q * s_q;
  const int mlen = seg_lens[b];
  const float* crow = FUSED ? c_tab + (long long)(cid ? cid[n] : n % n_rows) * L : nullptr;
  const int kmax = (mlen >= 1 && mlen <= M) ? L - 1 + mlen - 1 : -1;
  const long long lm1 = max(L - 1, 1), mm1 = max(mlen - 1, 1), den = lm1 + mm1;
  const long long bw = (long long)band * lm1;
  int ilo = 0, j0 = 0, d = 0;
  long long e = 0;
  float term = UNREACHABLE;
  __syncthreads();
  for (int k = 0; k <= kmax; ++k) {
    const float* pp = st + ((k + 1) & 1) * 2 * stride;
    const float* qp = pp + stride;
    float* pc = st + (k & 1) * 2 * stride;
    float* qc = pc + stride;
    for (int w = tid; w < WP; w += T) {
      const float up = pp[w + d];           // position w + d - 1
      const float lq = qp[w + d + 1];       // position w + d
      const int i = ilo + w, j = j0 - w;
      const long long x_band = e - w * den + bw;
      float c = __int_as_float(0x7f800000);  // out of band: +inf
      if (i < L && (unsigned)j < (unsigned)mlen && x_band >= 0 && x_band <= 2 * bw) {
        const float x = __ldg(src + i * s_i + (long long)j * s_j);
        c = FUSED ? -__fadd_rn(x, __ldg(crow + i)) : x;
      }
      const float v = fminf(__fadd_rn(c, fminf(up, lq)), UNREACHABLE);
      pc[w + 1] = v;
      qc[w + 1] = fminf(v, up);
      if (w == 0 && k == kmax) term = v;
    }
    // the window steps to diagonal k+1 by the reference's rule
    d = (j0 >= mlen - 1) || (e > bw - lm1);
    ilo += d;
    j0 += 1 - d;
    e += d ? lm1 - den : lm1;
    __syncthreads();
  }
  if (tid == 0) {
    if (FUSED)
      out[n] = term > 1e37f ? -__int_as_float(0x7f800000) : -term / (float)(L + mlen);
    else
      out[n] = term;
  }
}

int launch_wide(bool fused, const float* llr, const float* c_tab, const int* cid,
                const int* lens, float* out, float* scratch, long long s_b, long long s_q,
                long long s_i, long long s_j, int n_pairs, int inner, int L, int M, int n_rows,
                int band, int WP, cudaStream_t stream) {
  const int threads = min(WIDE_MAX_THREADS, (WP + 31) / 32 * 32);
  const size_t bytes = scratch ? 0 : sizeof(float) * 4 * (size_t)(WP + 2);
  auto kernel = fused ? banded_dtw_wide_kernel<true> : banded_dtw_wide_kernel<false>;
  static const cudaError_t opt_in[2] = {
      cudaFuncSetAttribute(banded_dtw_wide_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(sizeof(float) * WIDE_SMEM_WORDS)),
      cudaFuncSetAttribute(banded_dtw_wide_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(sizeof(float) * WIDE_SMEM_WORDS))};
  if (opt_in[fused] != cudaSuccess) return opt_in[fused];
  if (!scratch && 4 * (WP + 2) > WIDE_SMEM_WORDS) return cudaErrorInvalidValue;
  kernel<<<n_pairs, threads, bytes, stream>>>(llr, c_tab, cid, lens, out, scratch, s_b, s_q,
                                              s_i, s_j, inner, L, M, n_rows, band, WP);
  return cudaGetLastError();
}

template <int R, bool FUSED, bool TILE, bool CCHUNK>
int launch_one(const float* llr, const float* c_tab, const int* cid, const int* lens, float* out,
               long long s_b, long long s_q, long long s_i, long long s_j, int n_pairs,
               int inner, int L, int M, int n_rows, int band, int G, cudaStream_t stream) {
  const int ppw = R == 1 ? 32 / G : 1;
  const int blocks = (n_pairs + WARPS * ppw - 1) / (WARPS * ppw);
  const size_t bytes = sizeof(float) * WARPS * warp_words(TILE, FUSED, CCHUNK, ppw, L, M);
  auto kernel = banded_dtw_kernel<R, FUSED, TILE, CCHUNK>;
  // the most any launch of this kernel takes: TILE_WORDS of tiles or the
  // ring, and 32 c rows of 256 a warp (a warp's tiles hold fewer) or
  // (CCHUNK) the ring's c stages
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * WARPS *
            ((TILE ? TILE_WORDS : STAGES * STAGE_WORDS) +
             (CCHUNK ? STAGES * C_STAGE_WORDS : FUSED ? 32 * C_ROW_LENGTH : 0))));
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<blocks, WARPS * 32, bytes, stream>>>(llr, c_tab, cid, lens, out, s_b, s_q, s_i, s_j,
                                                n_pairs, inner, L, M, n_rows, band, G);
  return cudaGetLastError();
}

template <int R>
int launch(bool fused, bool tile, const float* llr, const float* c_tab, const int* cid,
           const int* lens, float* out, long long s_b, long long s_q, long long s_i,
           long long s_j, int n_pairs, int inner, int L, int M, int n_rows, int band, int G,
           cudaStream_t stream) {
#define DTW_LAUNCH(F, T, C)                                                                  \
  return launch_one<R, F, T, C>(llr, c_tab, cid, lens, out, s_b, s_q, s_i, s_j, n_pairs,     \
                                inner, L, M, n_rows, band, G, stream)
  if (R == 1 && tile) {
    if (fused) DTW_LAUNCH(true, R == 1, false);
    DTW_LAUNCH(false, R == 1, false);
  }
  if (fused && L > C_ROW_LENGTH) DTW_LAUNCH(true, false, true);
  if (fused) DTW_LAUNCH(true, false, false);
  DTW_LAUNCH(false, false, false);
#undef DTW_LAUNCH
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr: pair n = b*inner + q, cell (i, j) at b*s_b + q*s_q + i*s_i + j*s_j
// (f32, strides in elements); seg_lens [n_pairs / inner] int32 (by b);
// c_tab [n_rows, L] f32 or NULL (raw mode: llr is the cost, out the
// terminals); cid [n_pairs] int32 in [0, n_rows), or NULL for n % n_rows;
// out [n_pairs] f32.  L >= 1, band >= 0 (clamped to L + M: a wider band
// is the same band).  The narrow routes take min(2*band+1, L) <= 511 (R
// <= 16 registers a lane) with (L + M + band) * max(L-1, 1) below 2^31;
// every other pair goes the wide route (wide_window), whose state takes
// scratch, 4 * (WP + 2) floats a pair, where it does not fit shared
// memory (scratch NULL otherwise).
extern "C" int tsr_banded_dtw(const void* llr, const void* c_tab, const void* cid,
                              const void* seg_lens, void* out, void* scratch, long long s_b,
                              long long s_q, long long s_i, long long s_j, int n_pairs,
                              int inner, int L, int M, int n_rows, int band, void* stream) {
  if (L < 1 || M < 1 || band < 0 || inner < 1 || (c_tab && n_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  band = min(band, L + M);
  const long long lm1 = max(L - 1, 1);
  if (min(2 * band + 1, L) >= WIDE_MIN_WINDOW || ((long long)L + M + band) * lm1 >= (1ll << 31))
    return launch_wide(c_tab != nullptr, static_cast<const float*>(llr),
                       static_cast<const float*>(c_tab), static_cast<const int*>(cid),
                       static_cast<const int*>(seg_lens), static_cast<float*>(out),
                       static_cast<float*>(scratch), s_b, s_q, s_i, s_j, n_pairs, inner, L, M,
                       n_rows, band, min(min(2 * band + 1, L), M) + 1,
                       static_cast<cudaStream_t>(stream));
  // the window: W = min(2*band+1, L) rows and a spare position; G lanes a
  // pair (a power of two), past 32 positions R registers a lane
  const int w = min(2 * band + 1, L) + 1;
  int G = 1, R = 1;
  if (w <= 32) {
    while (G < w) G *= 2;
  } else {
    G = 32;
    while (32 * R < w) R *= 2;
  }
  const bool fused = c_tab != nullptr;
  // whole-tile mode: each pair's [L, M] tile one contiguous, 16-byte
  // aligned block, and a warp's tiles within TILE_WORDS
  const long long tile_words = (long long)L * M;
  bool tile = R == 1 && s_j == 1 && s_i == M && (inner == 1 || s_q == tile_words) &&
              (inner == 1 ? s_b == tile_words : s_b == inner * tile_words) &&
              tile_words % 4 == 0 && reinterpret_cast<uintptr_t>(llr) % 16 == 0 &&
              (32 / G) * tile_words <= TILE_WORDS;
#ifdef DTW_NO_TILE
  tile = false;
#endif
  const float* l = static_cast<const float*>(llr);
  const float* c = static_cast<const float*>(c_tab);
  const int* id = static_cast<const int*>(cid);
  const int* s = static_cast<const int*>(seg_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<1>(fused, tile, l, c, id, s, o, s_b, s_q, s_i, s_j, n_pairs, inner, L, M, n_rows, band, G, st);
    case 2: return launch<2>(fused, tile, l, c, id, s, o, s_b, s_q, s_i, s_j, n_pairs, inner, L, M, n_rows, band, G, st);
    case 4: return launch<4>(fused, tile, l, c, id, s, o, s_b, s_q, s_i, s_j, n_pairs, inner, L, M, n_rows, band, G, st);
    case 8: return launch<8>(fused, tile, l, c, id, s, o, s_b, s_q, s_i, s_j, n_pairs, inner, L, M, n_rows, band, G, st);
    default: return launch<16>(fused, tile, l, c, id, s, o, s_b, s_q, s_i, s_j, n_pairs, inner, L, M, n_rows, band, G, st);
  }
}
