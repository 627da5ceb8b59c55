// Kernel 8, redesigned for Hopper: the whole dual-rank order statistic
// of every plane, as a shared-memory histogram select.
//
// Replaces template_speech_recognition_tpu/ops/radix_pallas.py
// radix_level_counts_pallas (_count_kernel; pallas_call at line 85) and
// the level loop around it (frontend/planes.py plane_order_statistics).
//
// For plane row r = p*B + b of the plane-major float32 planes [P, B, T,
// F] (T, F contiguous), its n = valid[b] * F valid cells (rows t <
// valid[b], one contiguous run at the start of the row; the rest are not
// read) and the 1-based ranks need[b][0..1] (k + 1 and n - k): the
// elements of those ranks, written to os_hi[b][p] and os_lo[b][p].
//
// The TPU kernel counts keys against 16 candidate prefixes from
// registers, eleven launches of 2 + 3 x 10 bits, because the VPU has no
// scatter.  Here each level builds a histogram of one digit of the
// monotone uint32 key (bits ^ ((bits >> 31) | 0x80000000), made from the
// float as it is read) in shared memory, with digits of 11, 11 and 10
// bits, in four launches:
//
// 1. a small kernel zeroes level 1's histogram and the collected counts;
// 2. level 1, grid (chunks of a row, rows): each block counts its chunk
//    (16-byte loads; a chunk's ragged head and tail, and an unaligned
//    row, key by key) into shared memory, one private histogram a warp
//    (the top 11 bits, sign, exponent and two mantissa bits, fall into a
//    few hot bins), and adds the nonzero bins into the global
//    [R, 2048] int32 histogram with atomics.  Integer sums are the same
//    in any order, so the select is bitwise that of the plain version;
// 3. level 2, the same grid: each block first picks its row's level-1
//    digit of both ranks itself, a block prefix sum over the histogram
//    (the first digit whose cumulative count reaches the rank's
//    remainder; when none does, and only an utterance with no valid cell
//    has that, for its rank n - k = 1, the last digit: the reference
//    counts its masked 0xFFFFFFFF cells toward the all-ones candidate, so
//    it descends there).  Its first loads are already out.  It then reads
//    the planes again and collects the keys in either rank's level-1 bin
//    (1.6% of the cells at the log-mel scan's shape): each thread marks a
//    step's matches in a bit mask, a warp scan places them in the block's
//    own chunk of a stage buffer, and the block moves them to its row's
//    compact buffer with one global atomic a slot;
// 4. the last levels, one block a row: the collected keys go to shared
//    memory (beside the level-1 pick), each level is counted and picked
//    there, then the two floats are written.  Where the two ranks'
//    prefixes are equal a key is counted once, for both.
//
// Scratch: two collected counts a row and level 1's histogram [R, 2048]
// (both zeroed by the first launch), then the stage and compact
// buffers, [R, T*F rounded up to 4] keys each: a key
// matches at most one rank's prefix, so the two slots share a row's
// buffer, slot 0 from the front and slot 1 from the back (never zeroed;
// only counted keys are read).
//
// Probe switches (probe_radix_select.py builds them; the port builds
// none): -DRADIX_L0_MATCH (level 1 into one histogram a block with
// warp-aggregated increments, __match_any_sync, not one a warp),
// -DRADIX_LEVEL1_ONLY (launch level 1 alone), -DRADIX_SKIP_LEVEL1 (the
// later launches alone, on empty level-1 counts: level 2 then streams the
// planes and collects no key).
//
// What bounds it on the H100: bytes.  At the log-mel scan's shape (32
// rows of 2997 x 63 valid cells) one read of the valid planes is 24.2 MB,
// 0.0072 ms at 3.35 TB/s.  Levels 1 and 2 each read them (level 2 at
// 3.2 TB/s when it collects nothing: at this size they do not stay in L2
// between launches); the per-launch fixed costs (a launch, a pick from
// L2, the last launch's few blocks) make up the rest (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W1 = 11, W2 = 11, W3 = 10;      // the digits, top first
constexpr int MAX_BINS = 1 << W1;
constexpr int UNROLL = 4;                     // 16-byte loads in flight a thread
constexpr int FINISH_KEYS = 32768;            // collected keys the last launch holds
constexpr unsigned FULL = 0xffffffffu;
#ifdef RADIX_L0_MATCH
constexpr int L0_COPIES = 1;
#else
constexpr int L0_COPIES = WARPS;
#endif

struct Args {
  const float* planes;
  const int* valid;
  const int* need;
  float* os_hi;
  float* os_lo;
  int* hist;          // [R, MAX_BINS]: level 1's counts, for both ranks
  int* counts;        // [R, 2]: keys collected a (row, slot)
  uint32_t* stage;    // [R, cap]: each level-2 block's keys, in its own chunk
  uint32_t* compact;  // [R, cap]: a row's collected keys, slot 0 from the
                      // front, slot 1 from the back
  int P, B, T, F;
  int chunk;          // cells a block at levels 1 and 2
  int cap;            // T * F rounded up to 4
};

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ int valid_cells(const Args& a, int b) {
  return min(max(a.valid[b], 0), a.T) * a.F;
}

__device__ __forceinline__ int active_chunks(const Args& a, int n) {
  return max(1, (n + a.chunk - 1) / a.chunk);
}


struct Pick {        // shared: both ranks' prefix and remaining rank
  uint32_t pre[2];
  int rem[2];
  int warp_sum[2][WARPS];
};

// Both ranks' digit of W bits from their histograms h0, h1: the first
// digit whose cumulative count reaches the rank's remainder, or the last
// digit when none does; the prefix grows by it and the remainder drops
// by the counts below it.  Each thread loads its PER bins with one or
// two vector loads (from L2, or shared memory at the last levels), so a
// pick costs about one round trip.  All threads call it.
template <int W>
__device__ __forceinline__ void pick_level(const int* h0, const int* h1, Pick& s) {
  constexpr int PER = (1 << W) / THREADS;
  static_assert(PER % 4 == 0, "a pick loads whole int4s");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[2][PER], own[2] = {0, 0}, inc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int* h = (r ? h1 : h0) + tid * PER;
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(h)[q];
      v[r][4 * q] = x.x;
      v[r][4 * q + 1] = x.y;
      v[r][4 * q + 2] = x.z;
      v[r][4 * q + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) own[r] += v[r][i];
    inc[r] = own[r];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int x = __shfl_up_sync(FULL, inc[r], o);
      if (lane >= o) inc[r] += x;
    }
  }
  if (lane == 31) {
    s.warp_sum[0][warp] = inc[0];
    s.warp_sum[1][warp] = inc[1];
  }
  __syncthreads();
  int rem[2], below[2] = {0, 0}, tot[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rem[r] = s.rem[r];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int x = s.warp_sum[r][k];
      if (k < warp) below[r] += x;
      tot[r] += x;
    }
  }
  __syncthreads();   // every thread has read s before one writes it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int incl = inc[r] + below[r], excl = incl - own[r];
    if (tot[r] < rem[r]) {
      if (tid == THREADS - 1) {
        s.pre[r] = (s.pre[r] << W) | (uint32_t)((1 << W) - 1);
        s.rem[r] = rem[r] - (tot[r] - v[r][PER - 1]);
      }
    } else if (incl >= rem[r] && (tid == 0 || excl < rem[r])) {
      int c = excl, digit = -1, left = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (digit < 0) {
          c += v[r][i];
          if (c >= rem[r]) {
            digit = tid * PER + i;
            left = rem[r] - (c - v[r][i]);
          }
        }
      }
      s.pre[r] = (s.pre[r] << W) | (uint32_t)digit;
      s.rem[r] = left;
    }
  }
  __syncthreads();
}

// Both ranks' prefix and remaining rank of `row` after level 1, picked
// from its global histogram (one for both ranks: their prefixes are
// empty at level 1).
__device__ __forceinline__ void pick_first(const Args& a, int row, Pick& s) {
  const int b = row % a.B;
  if (threadIdx.x < 2) {
    s.pre[threadIdx.x] = 0u;
    s.rem[threadIdx.x] = a.need[2 * b + threadIdx.x];
  }
  __syncthreads();
  const int* h = a.hist + (size_t)row * MAX_BINS;
  pick_level<W1>(h, h, s);
}

__device__ __forceinline__ void write_out(const Args& a, int row, const Pick& s) {
  if (threadIdx.x == 0) {
    const int p = row / a.B, b = row % a.B;
    a.os_hi[(size_t)b * a.P + p] = key_to_float(s.pre[0]);
    a.os_lo[(size_t)b * a.P + p] = key_to_float(s.pre[1]);
  }
}

// MODE: which level a block runs.  FIRST (level 1) reads the planes and
// counts every key; COLLECT (level 2) reads the planes, counts the keys
// that match a rank's prefix and collects them; FINISH (the later
// levels) reads the collected keys.
enum Mode { FIRST = 0, COLLECT = 1, FINISH = 2 };

struct Level {
  int shift, sh_pre;
  uint32_t mask, pre0, pre1;
  bool same;
  int* h0;            // shared histograms (level 1: one copy a warp)
  int* h1;
  int* scnt;          // shared: the block's collected counts a slot
  uint32_t* stage;    // the block's chunk of the stage buffer
  int span;           // its length
};

// One key of a level; every lane of the warp calls it (``valid`` says
// whether this lane's key is real), so COLLECT can ballot.
template <int MODE>
__device__ __forceinline__ void count_key(bool valid, uint32_t key, const Level& c) {
  const uint32_t d = (key >> c.shift) & c.mask;
  if (MODE == FIRST) {
#ifdef RADIX_L0_MATCH
    const unsigned act = __ballot_sync(FULL, valid);
    if (valid) {
      const unsigned peers = __match_any_sync(act, d);
      if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(c.h0 + d, __popc(peers));
    }
#else
    if (valid) atomicAdd(c.h0 + (L0_COPIES > 1 ? (threadIdx.x >> 5) * MAX_BINS : 0) + d, 1);
#endif
    return;
  }
  const uint32_t top = key >> c.sh_pre;
  const bool m0 = valid && top == c.pre0;
  const bool m1 = valid && !c.same && top == c.pre1;
  if (MODE == FINISH) {
    if (m0) {
      atomicAdd(c.h0 + d, 1);
    } else if (m1) {
      atomicAdd(c.h1 + d, 1);
    }
  } else {
    // into the block's own chunk of the stage buffer, slot 0 from its
    // front and slot 1 from its back: one shared atomic a warp and slot
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool m = r ? m1 : m0;
      const unsigned bal = __ballot_sync(FULL, m);
      if (bal) {
        const int leader = __ffs(bal) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(c.scnt + r, __popc(bal));
        base = __shfl_sync(FULL, base, leader);
        const int at = base + __popc(bal & ((1u << lane) - 1u));
        if (m) c.stage[r ? c.span - 1 - at : at] = key;
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ uint32_t key_of(uint32_t bits) {
  return MODE == FINISH ? bits : order_key(__uint_as_float(bits));
}

// Level 2's keys of one step (UNROLL 16-byte loads a thread): each
// thread marks its matches a slot in a bit mask, a warp scan of the
// packed counts places them, one shared atomic a warp and slot reserves
// the room, and only the marked keys are made again and stored.
__device__ __forceinline__ void collect_step(const uint4 (&x)[UNROLL], int i0, int nvec,
                                             const Level& c) {
  constexpr int KEYS = 4 * UNROLL;
  const int lane = threadIdx.x & 31;
  unsigned mask0 = 0u, mask1 = 0u;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (i0 + u * THREADS < nvec) {
      const uint32_t k[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t top = order_key(__uint_as_float(k[q])) >> c.sh_pre;
        mask0 |= (unsigned)(top == c.pre0) << (4 * u + q);
        mask1 |= (unsigned)(top == c.pre1 && !c.same) << (4 * u + q);
      }
    }
  }
  const int packed = __popc(mask0) | (__popc(mask1) << 16);
  if (!__any_sync(FULL, packed)) return;
  int inc = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += v;
  }
  const int total = __shfl_sync(FULL, inc, 31);
  int b0 = 0, b1 = 0;                 // a step's total is at most 32 x KEYS a slot
  if (lane == 0) {
    b0 = atomicAdd(c.scnt, total & 0xffff);
    b1 = atomicAdd(c.scnt + 1, total >> 16);
  }
  int at0 = __shfl_sync(FULL, b0, 0) + ((inc - packed) & 0xffff);
  int at1 = __shfl_sync(FULL, b1, 0) + ((inc - packed) >> 16);
  if (!packed) return;
#pragma unroll
  for (int j = 0; j < KEYS; ++j) {
    if ((mask0 | mask1) >> j & 1u) {
      const uint4& v = x[j / 4];
      const uint32_t bits = j % 4 == 0 ? v.x : j % 4 == 1 ? v.y : j % 4 == 2 ? v.z : v.w;
      const uint32_t key = order_key(__uint_as_float(bits));
      if (mask0 >> j & 1u) {
        c.stage[at0++] = key;
      } else {
        c.stage[c.span - 1 - at1++] = key;
      }
    }
  }
}

// Count cells [start, end) of a contiguous run of float32 planes (or of
// collected keys for FINISH): 16-byte loads from the first aligned cell
// on, UNROLL in flight a thread while the previous UNROLL are counted,
// the first ones sent before ``ready`` (the digit pick, which they do
// not depend on); the ragged head and tail (at most 3 cells each) by
// warps 0 and 1, key by key.  Every thread runs the same iterations.
template <int MODE, typename Ready>
__device__ __forceinline__ void count_run(const uint32_t* src, int start, int end,
                                          Ready ready) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mis = (int)((reinterpret_cast<uintptr_t>(src + start) >> 2) & 3);
  const int vstart = min(start + ((4 - mis) & 3), end);
  const int nvec = max(end - vstart, 0) >> 2;
  const int vend = vstart + 4 * nvec;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + vstart);
  constexpr int STEP = THREADS * UNROLL;
  const int iters = (nvec + STEP - 1) / STEP;
  uint4 x[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (tid + u * THREADS < nvec) x[u] = __ldg(vsrc + tid + u * THREADS);
  }
  const Level& lv = ready();
  for (int it = 0; it < iters; ++it) {
    const int i0 = it * STEP + tid;
    uint4 y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + STEP + u * THREADS < nvec) y[u] = __ldg(vsrc + i0 + STEP + u * THREADS);
    }
    if (MODE == COLLECT) {
      collect_step(x, i0, nvec, lv);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) x[u] = y[u];
      continue;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool ok = i0 + u * THREADS < nvec;
      count_key<MODE>(ok, key_of<MODE>(x[u].x), lv);
      count_key<MODE>(ok, key_of<MODE>(x[u].y), lv);
      count_key<MODE>(ok, key_of<MODE>(x[u].z), lv);
      count_key<MODE>(ok, key_of<MODE>(x[u].w), lv);
      x[u] = y[u];
    }
  }
  if (warp < 2) {
    const int i = (warp == 0 ? start : vend) + lane;
    const bool ok = lane < 3 && i < (warp == 0 ? vstart : end);
    count_key<MODE>(ok, key_of<MODE>(ok ? src[i] : 0u), lv);
  }
}

// The level's constants, in shared memory (thread 0 writes; the caller
// synchronises).
__device__ __forceinline__ void set_level(Level& c, int bits_before, int w, bool first,
                                          const Pick& s, int* smem) {
  c.shift = 32 - bits_before - w;
  c.mask = (1u << w) - 1u;
  c.sh_pre = first ? 0 : 32 - bits_before;
  c.pre0 = first ? 0u : s.pre[0];
  c.pre1 = first ? 0u : s.pre[1];
  c.same = first || s.pre[0] == s.pre[1];
  c.h0 = smem;
  c.h1 = smem + MAX_BINS;
}

// Levels 1 and 2: grid (chunks, rows), one chunk of a row's valid cells
// a block.  Level 1 counts every key into the global histogram; level 2
// picks the row's level-1 digits, stages the keys that match a rank's
// prefix in the block's own chunk of the stage buffer, then moves them
// to the row's compact buffer with one global atomic a slot.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
radix_hist_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ Pick s;
  __shared__ Level lv_s;
  __shared__ int scnt[2], gbase[2];
  const int row = blockIdx.y, b = row % a.B, tid = threadIdx.x;
  const int n = valid_cells(a, b);
  if ((int)blockIdx.x >= active_chunks(a, n)) return;
  const int start = blockIdx.x * a.chunk, end = min(start + a.chunk, n);

  auto ready = [&]() -> const Level& {
    if (MODE == FIRST) {
      for (int i = tid; i < L0_COPIES * MAX_BINS / 4; i += THREADS) {
        reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
      }
    } else {
      pick_first(a, row, s);
      if (tid < 2) scnt[tid] = 0;
    }
    __syncthreads();
    if (tid == 0) {
      // level 2 matches the level-1 prefix; its own digit waits for the
      // last launch
      set_level(lv_s, MODE == FIRST ? 0 : W1, MODE == FIRST ? W1 : W2, MODE == FIRST, s, smem);
      lv_s.scnt = scnt;
      lv_s.stage = a.stage + (size_t)row * a.cap + start;
      lv_s.span = end - start;
    }
    __syncthreads();
    return lv_s;
  };
  count_run<MODE>(reinterpret_cast<const uint32_t*>(a.planes + (size_t)row * a.T * a.F),
                  start, end, ready);
  __syncthreads();

  if (MODE == FIRST) {
    int* g0 = a.hist + (size_t)row * MAX_BINS;
    for (int i = tid; i < MAX_BINS; i += THREADS) {
      int v = 0;
#pragma unroll
      for (int k = 0; k < L0_COPIES; ++k) v += smem[k * MAX_BINS + i];
      if (v) atomicAdd(g0 + i, v);
    }
  } else {
    if (tid < 2 && scnt[tid]) gbase[tid] = atomicAdd(a.counts + 2 * row + tid, scnt[tid]);
    __syncthreads();
    const Level& c = lv_s;
    uint32_t* dst = a.compact + (size_t)row * a.cap;
    for (int i = tid; i < scnt[0]; i += THREADS) dst[gbase[0] + i] = c.stage[i];
    for (int i = tid; i < scnt[1]; i += THREADS) {
      dst[a.cap - 1 - (gbase[1] + i)] = c.stage[c.span - 1 - i];
    }
  }
}

// Levels 2 and 3: one block a row over its collected keys (the ranks'
// level-1 bins).  Up to FINISH_KEYS of them are first copied to shared
// memory (both runs at once); each level's histogram and digit pick are
// in shared memory, then the floats.
__global__ void __launch_bounds__(THREADS) radix_finish_kernel(Args a) {
  extern __shared__ int smem[];       // 2 histograms, then the keys
  __shared__ Pick s;
  __shared__ Level lv_s;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int n0 = a.counts[2 * row], n1 = a.counts[2 * row + 1], total = n0 + n1;
  const uint32_t* keys = a.compact + (size_t)row * a.cap;
  uint32_t* skeys = reinterpret_cast<uint32_t*>(smem + 2 * MAX_BINS);
  const bool resident = total <= FINISH_KEYS;
  // slot 0's [0, n0), then slot 1's [cap - n1, cap), 8 loads in flight a
  // thread; the first ones wait in registers while the block picks
  // level 1's digits
  for (int i0 = tid, first = 1; resident && (i0 < total || first); i0 += 8 * THREADS) {
    uint32_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS;
      if (i < total) v[u] = keys[i < n0 ? i : a.cap - total + i];
    }
    if (first) {
      pick_first(a, row, s);
      first = 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u * THREADS < total) skeys[i0 + u * THREADS] = v[u];
    }
  }
  if (!resident) pick_first(a, row, s);
  for (int level = 2; level <= 3; ++level) {
    const int w = level == 2 ? W2 : W3, bits_before = level == 2 ? W1 : W1 + W2;
    for (int i = tid; i < 2 * MAX_BINS / 4; i += THREADS) {
      reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
    }
    if (tid == 0) set_level(lv_s, bits_before, w, false, s, smem);
    __syncthreads();
    if (resident) {
      for (int i = tid; i < total; i += THREADS) count_key<FINISH>(true, skeys[i], lv_s);
    } else {
      auto ready = [&]() -> const Level& { return lv_s; };
      count_run<FINISH>(keys, 0, n0, ready);
      count_run<FINISH>(keys, a.cap - n1, a.cap, ready);
    }
    __syncthreads();
    const int* h1 = lv_s.same ? smem : smem + MAX_BINS;
    if (level == 2) {
      pick_level<W2>(smem, h1, s);
    } else {
      pick_level<W3>(smem, h1, s);
    }
  }
  write_out(a, row, s);
}

// Zeroes ``n4`` int4 of the scratch: a kernel, so that level 1 follows
// it as closely as one kernel follows another.
__global__ void __launch_bounds__(THREADS) radix_zero_kernel(int4* p, int n4) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n4; i += gridDim.x * THREADS) {
    p[i] = make_int4(0, 0, 0, 0);
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes [P, B, T, F] f32 contiguous (T * F < 2^31), valid [B] int32,
// need [B, 2] int32 (1-based ranks) -> os_hi, os_lo [B, P] f32.
// scratch, int32: 2R collected counts padded to 4, then level 1's R *
// 2048 histogram counts (both zeroed here), then the stage and the
// compact buffers, R * cap keys each (cap = T * F rounded up to 4; R =
// P * B).  chunk: cells a block at levels 1 and 2 (a multiple of 4).
extern "C" int tsr_radix_select(const void* planes, const void* valid, const void* need,
                                void* os_hi, void* os_lo, void* scratch, int P, int B, int T,
                                int F, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = P * B;
  if (R == 0) return cudaSuccess;
  Args a;
  a.planes = static_cast<const float*>(planes);
  a.valid = static_cast<const int*>(valid);
  a.need = static_cast<const int*>(need);
  a.os_hi = static_cast<float*>(os_hi);
  a.os_lo = static_cast<float*>(os_lo);
  // scratch: the collected counts (padded to 4) and level 1's
  // histogram, which the first launch zeroes; the stage and compact
  // buffers
  const size_t counts4 = (2 * (size_t)R + 3) / 4 * 4;
  a.counts = static_cast<int*>(scratch);
  a.hist = a.counts + counts4;
  a.P = P;
  a.B = B;
  a.T = T;
  a.F = F;
  a.chunk = chunk;
  a.cap = (T * F + 3) / 4 * 4;
  a.stage = reinterpret_cast<uint32_t*>(a.hist + (size_t)R * MAX_BINS);
  a.compact = a.stage + (size_t)R * a.cap;
  const size_t l0_smem = sizeof(int) * L0_COPIES * MAX_BINS;
  const size_t finish_smem = sizeof(int) * 2 * MAX_BINS + sizeof(uint32_t) * FINISH_KEYS;
  cudaError_t err = cudaSuccess;
  static bool attr_set = false;
  if (!attr_set) {
    // one shared-memory carveout for every launch, so that none waits for
    // the SMs to change it
    const void* fns[] = {(const void*)radix_zero_kernel, (const void*)radix_hist_kernel<FIRST>,
                         (const void*)radix_hist_kernel<COLLECT>,
                         (const void*)radix_finish_kernel};
    for (const void* fn : fns) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute((const void*)radix_hist_kernel<FIRST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l0_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute((const void*)radix_finish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)finish_smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int z4 = (int)((counts4 + (size_t)R * MAX_BINS) / 4);
  radix_zero_kernel<<<(z4 + THREADS * 4 - 1) / (THREADS * 4), THREADS, 0, st>>>(
      reinterpret_cast<int4*>(scratch), z4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(((long long)T * F + chunk - 1) / chunk), (unsigned)R);
#ifndef RADIX_SKIP_LEVEL1
  radix_hist_kernel<FIRST><<<grid, THREADS, l0_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#endif
#ifdef RADIX_LEVEL1_ONLY
  return cudaSuccess;
#endif
  radix_hist_kernel<COLLECT><<<grid, THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_finish_kernel<<<R, THREADS, finish_smem, st>>>(a);
  return cudaGetLastError();
}
