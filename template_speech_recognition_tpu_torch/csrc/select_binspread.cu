// Kernel 2: exact dual-rank order-statistic select + binarize + spread.
//
// Replaces template_speech_recognition_tpu/ops/selbin_pallas.py
// select_binspread_pallas (_kernel_allplanes and the per-plane _kernel).
// See ops/selbin_kernel.py for the function computed.
//
// What bounds it on the H100: bytes.  The valid rows of the planes in
// once and the map out once (101 + 50 MB at P 4, B 8, T 3072, F 256)
// take 0.044 ms at 3.35 TB/s; the select itself is a few integer
// operations a cell.
//
// The TPU kernel keeps a whole [T, F] plane (3 MB at the bench shape)
// resident in VMEM and bisects it there.  An SM has 227 KB of shared
// memory; a cluster of 16 CTAs has 16 x 227 KB of distributed shared
// memory, which holds the plane.  So there are two variants, chosen by
// shape in the wrapper (ops/selbin_kernel.py, ``route``):
//
// selbin_cluster: 16-CTA clusters, one (plane, utterance) pair at a
//   time, the plane read from device memory once; 1,024 threads a CTA.
//   The grid holds as many clusters as the card runs at once (7 on an
//   H100 SXM: cudaOccupancyMaxActiveClusters), and each walks the pairs
//   q = blockIdx.y, blockIdx.y + gridDim.y, ...  CTA r owns rows
//   [r*R, (r+1)*R), R = ceil(T/16).  Each CTA takes all 232,448 bytes
//   of shared memory: R*F keys, a fixed part (its 512 digit counts,
//   three buffers of the 512 sums it gathers for the cluster, the level-0
//   sums, mbarriers, the digit state), then R x 2 x ceil(F/32) words of
//   dilated bits, which during the select, with the rest of the block,
//   hold the candidate lists.  It takes F <= 1024 and R*(4F +
//   8*ceil(F/32)) + fixed <= 232,448 (T <= 3264 at F = 256;
//   ``cluster_fits``).
//   1. One thread loads the CTA's valid rows of a pair, one contiguous
//      run, with the TMA's 1-D bulk copy in 32 KB pieces, each on its
//      own mbarrier.  The next pair's load starts as soon as the keys
//      are binarized, so it lands while this pair's map is written.  A
//      CTA whose rows all lie at or past valid loads nothing.
//   2. The floats become order keys in place as the pieces land; the
//      same pass counts the top 8-bit digits (level 0, one histogram
//      for both ranks).
//   3. Each of the four 8-bit levels is one cluster round: every CTA
//      adds its nonzero counts into the CTA that gathers the bin (bin j:
//      CTA j / 32) with red.shared::cluster, barrier.cluster, then warp
//      w fetches bins [32w, 32w+32) with ld.shared::cluster, scans them,
//      and the bin whose cumulative count reaches a rank's need gives its
//      digit (identical integers in every CTA: no broadcast, no second
//      launch).  Three buffers of sums let one barrier a round suffice.
//      Level 1 packs each warp's keys under either rank's 8-bit prefix
//      into its own segment of the candidate list (per-lane masks and a
//      warp scan, no atomics) and later levels count from the segment;
//      when the level-0 counts say the lists would overflow, level 1
//      counts every key and level 2 extracts under the 16-bit prefix,
//      and a warp whose segment overflows counts every key and extracts
//      again.  Any digit schedule selects the same element as the
//      reference's bisection, so the keys are bitwise the TPU kernel's.
//   4. A warp takes a row: each lane compares 8 consecutive raw keys
//      against the canonical selected keys (a +0.0 threshold lowered to
//      the -0.0 key for the neg channel, which makes the raw compares
//      exact) into a byte of the pos and the neg bit row; lane w then
//      dilates word w along frequency with its neighbours' words
//      (__shfl_sync), in place.
//   5. barrier.cluster; a warp takes an output row and ORs its 2rt+1
//      dilated rows, reading the halo rows from the neighbouring CTAs'
//      shared memory (ld.shared::cluster), clears rows >= valid, and
//      writes its two F-byte channels, 16 bytes a lane (4 when
//      F % 16 != 0).  The next pair's first barrier, or a last one,
//      keeps every CTA's bit rows alive until its peers have read them.
//
//   At the bench shape on an H100 80GB HBM3 at 700 W
//   (probe_select_binspread.py) the 32 pairs take about 4.6 pairs a
//   cluster, and each pair's select is integer work at one CTA an SM:
//   the cluster rounds, the level-1 pass, binarize and time dilation
//   each cost more than its share of the 0.044 ms bound; PERF.md has
//   the breakdown.
//
// selbin_multipass: planes larger than a cluster holds stream through
//   L2 in four histogram radix passes of 8-bit digits over all pairs
//   at once (radix_hist: many blocks a pair, warp-aggregated shared
//   atomics, one global histogram per pair and rank; radix_digit: one
//   thread per (pair, rank) picks the digit), then an epilogue kernel
//   (binspread) reads the planes once more and writes the map.  Five
//   reads of the planes; used only where the cluster variant cannot
//   hold a plane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t SIGN = 0x80000000u;
constexpr uint32_t FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;

// ---- cluster variant ----------------------------------------------------
constexpr int CLUSTER = 16;
constexpr int NT = 1024;                       // threads a CTA
constexpr int NWARPS = NT / 32;
constexpr int COPY_CHUNK = 32768;              // bytes a bulk copy (and an mbarrier)
constexpr int MAX_CHUNKS = 8;                  // 8 x 32 KB > 232,448
// hist [512], acc [3][512], sums [512], MAX_CHUNKS mbarriers, state [8]
constexpr int CLUSTER_FIXED = 512 * 4 + 3 * 512 * 4 + 512 * 4 + MAX_CHUNKS * 8 + 8 * 4;

// ---- multipass variant --------------------------------------------------
constexpr int HIST_THREADS = 256;
constexpr int CHUNK = 16384;      // keys per radix_hist block
constexpr int TT = 32;            // rows per binspread block

__host__ __device__ inline int words_of(int F) { return (F + 31) / 32; }

// keys + the fixed part + dilated bits
__host__ __device__ inline long long cluster_need(int R, int F) {
  return (long long)R * F * 4 + (long long)R * 2 * words_of(F) * 4 + CLUSTER_FIXED;
}

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & SIGN) ? ~b : (b | SIGN);
}

__device__ __forceinline__ uint32_t canon(uint32_t k) {
  return k == 0x7FFFFFFFu ? SIGN : k;   // -0.0 key -> +0.0 key
}

// Warp-aggregated shared-memory histogram add; bin < 0 adds nothing.
// Every lane of the warp must call it together.
__device__ __forceinline__ void hist_add(int* h, int bin) {
  if (__ballot_sync(FULL, bin >= 0) == 0) return;
  const unsigned peers = __match_any_sync(FULL, bin);
  const int leader = __ffs(peers) - 1;
  if (bin >= 0 && (int)(threadIdx.x & 31) == leader) atomicAdd(&h[bin], __popc(peers));
}

// bytes 0/1 of the four bits of a nibble: the shifted copies of n do not
// overlap, so bit 8i of the product is bit i of n
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

// the address of p's counterpart in the shared memory of cluster CTA rank
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void peer_add(uint32_t addr, int v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t peer_load(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// lane src's x, or 0 for a lane outside [0, W); all lanes call it
__device__ __forceinline__ uint32_t lane_word(uint32_t x, int src, int W) {
  const uint32_t v = __shfl_sync(FULL, x, src & 31);
  return (src >= 0 && src < W) ? v : 0u;
}

// Lane w holds word w of a packed bit row of W words: the OR of the row
// shifted by -rf..rf bits (zeros past either end), word w of it.
__device__ __forceinline__ uint32_t dilate_row(uint32_t x, int lane, int W, int rf) {
  uint32_t o = x;
  for (int s = 1; s <= rf; ++s) {
    const int a = s >> 5, c = s & 31;
    // bit f of the result is bit f + s: words w + a and w + a + 1
    const uint32_t r0 = lane_word(x, lane + a, W), r1 = lane_word(x, lane + a + 1, W);
    // bit f of the result is bit f - s: words w - a and w - a - 1
    const uint32_t l0 = lane_word(x, lane - a, W), l1 = lane_word(x, lane - a - 1, W);
    o |= (r0 >> c) | (l0 << c);
    if (c) o |= (r1 << (32 - c)) | (l1 >> (32 - c));
  }
  return o;
}

// Counts k into rank r's half of h if it matches the rank's prefix at
// ``shift``; true if it matched either.
__device__ __forceinline__ bool count_key(int* h, uint32_t k, int shift, bool act0, uint32_t pre0,
                                          bool act1, uint32_t pre1) {
  const uint32_t top = k >> (shift + 8);
  const int d = (int)((k >> shift) & 255u);
  const bool m0 = act0 && top == pre0, m1 = act1 && top == pre1;
  if (m0) atomicAdd(&h[d], 1);
  if (m1) atomicAdd(&h[256 + d], 1);
  return m0 || m1;
}

// grid (CLUSTER, P*B), clusters of CLUSTER CTAs along x; see the header.
__global__ void __launch_bounds__(NT, 1)
selbin_cluster(const float* __restrict__ planes, const int* __restrict__ need_in,
               const int* __restrict__ valid, uint8_t* __restrict__ flat,
               unsigned long long* __restrict__ keys_out,
               int P, int B, int T, int F, int R, int rf, int rt) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t sm[];
  const int W = words_of(F);
  uint32_t* skeys = reinterpret_cast<uint32_t*>(sm);
  int* hist = reinterpret_cast<int*>(sm + (size_t)R * F * 4);    // [2 ranks][256] this CTA's
  int* acc = hist + 512;                 // [3 buffers][512]: bins this CTA sums for the cluster
  int* sums = acc + 3 * 512;                                      // [2 ranks][256] the cluster's
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + 512);       // [MAX_CHUNKS]
  uint32_t* st = reinterpret_cast<uint32_t*>(bars + MAX_CHUNKS);  // per rank: key, need, done
  // the rest: the dilated bit rows [R][2][W]; during the select, the
  // level-1 candidates, one segment of seg keys a warp
  uint32_t* bits = reinterpret_cast<uint32_t*>(st + 8);
  uint32_t* cand = bits;
  const int seg = (int)((MAX_SMEM - (long long)R * F * 4 - CLUSTER_FIXED) / 4 / NWARPS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * R;
  const int nrows = max(0, min(R, T - r0));
  const int Q = P * B;

  // this CTA's rows of pair q below valid, as bytes
  auto valid_bytes = [&](int q) {
    const int vq = min(max(valid[q % B], 0), T);
    return max(0, min(nrows, vq - r0)) * F * 4;
  };
  // 1. pair q's rows of this CTA, one contiguous run, by the TMA in
  //    32 KB pieces, piece c on mbarrier c (thread 0 only)
  auto load = [&](int q) {
    const int nbytes = valid_bytes(q);
    const char* src = reinterpret_cast<const char*>(planes + ((size_t)q * T + r0) * F);
    const uint32_t dst = smem_u32(skeys);
    for (int off = 0, c = 0; off < nbytes; off += COPY_CHUNK, ++c) {
      const uint32_t n = (uint32_t)min(COPY_CHUNK, nbytes - off);
      const uint32_t bar = smem_u32(bars + c);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(n) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(dst + off), "l"(src + off), "r"(n), "r"(bar) : "memory");
    }
  };

  for (int j = tid; j < 4 * 512; j += NT) hist[j] = 0;    // hist and acc
  if (tid == 0) {
    for (int c = 0; c < MAX_CHUNKS; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bars + c)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && (int)blockIdx.y < Q) load(blockIdx.y);
  // every CTA of the cluster runs and has zeroed its sums before any
  // CTA adds into them
  cluster.sync();

  // Persistent: the cluster walks the pairs q = blockIdx.y + k * gridDim.y
  uint32_t phase = 0u;   // bit c: the parity mbarrier c completes next
  int round = 0;         // cluster rounds so far; round r's sums sit in buffer r % 3
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const int p = q / B, b = q - p * B;
    const int vq = min(max(valid[b], 0), T);
    const int ncell = valid_bytes(q) / 4;
    const int rows_here = ncell / F;
    const int nchunks = (ncell * 4 + COPY_CHUNK - 1) / COPY_CHUNK;
    if (tid < 2) {
      // the bisection's edge cases: rank 0 selects key 0; a rank past
      // the valid cells selects the masked key 0xFFFFFFFF
      const int need = need_in[b * 2 + tid];
      const bool edge = need <= 0 || need > vq * F;
      st[tid * 3 + 0] = edge && need > 0 ? 0xFFFFFFFFu : 0u;
      st[tid * 3 + 1] = (uint32_t)need;
      st[tid * 3 + 2] = edge ? 1u : 0u;
    }

    // 2. keys in place + level 0 counts (top digit, one histogram), piece
    //    by piece as the pieces land
    {
      uint4* k4 = reinterpret_cast<uint4*>(skeys);
      const int n4 = ncell >> 2;
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(smem_u32(bars + c), (phase >> c) & 1u);
        phase ^= 1u << c;
        const int end = min(n4, (c + 1) * (COPY_CHUNK / 16));
        for (int i = c * (COPY_CHUNK / 16) + tid; i < end; i += NT) {
          const uint4 v = k4[i];
          const uint32_t k[4] = {order_key(__uint_as_float(v.x)), order_key(__uint_as_float(v.y)),
                                 order_key(__uint_as_float(v.z)), order_key(__uint_as_float(v.w))};
          k4[i] = make_uint4(k[0], k[1], k[2], k[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(&hist[k[j] >> 24], 1);
        }
      }
    }

    // 3. four 8-bit levels: count, add each bin into the CTA that sums it
    //    (bin j: CTA j / 32), barrier.cluster, fetch the sums, pick digits
    // warp w's keys: uint4 i = base + 32w + lane and i + NT, base a
    // multiple of 2 NT.  An extraction pass packs those under either
    // rank's prefix at this level into the warp's segment of the
    // candidate list (per-lane masks and a warp scan, no atomics); later
    // levels count from the segment.  Level 1 extracts unless the
    // cluster's level-0 counts say the lists would overflow (``wide``:
    // then it counts every key, and level 2 extracts under the 16-bit
    // prefix); a warp whose segment overflows counts every key and
    // extracts again at the next level.
    const uint4* k4 = reinterpret_cast<const uint4*>(skeys);
    const int n4 = ncell >> 2;
    uint32_t* mine = cand + warp * seg;
    int got = 0;
    bool listed = false, wide = false;
    for (int level = 0; level < 4; ++level) {
      if (level > 0) {
        const int shift = 24 - 8 * level;
        const bool act0 = st[2] == 0u, act1 = st[5] == 0u;
        const uint32_t pre0 = st[0], pre1 = st[3];
        if (!listed || got > seg) {
          listed = false;
          if (level >= 2 || !wide) {
            got = 0;
            for (int base = warp * 32; base < n4; base += 2 * NT) {   // uniform in the warp
              const int i = base + lane;
              const uint4 v0 = i < n4 ? k4[i] : make_uint4(0u, 0u, 0u, 0u);
              const uint4 v1 = i + NT < n4 ? k4[i + NT] : make_uint4(0u, 0u, 0u, 0u);
              const uint32_t k[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
              uint32_t mask = 0u;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const uint32_t top = k[j] >> (shift + 8);
                const bool m = (j < 4 ? i : i + NT) < n4 &&
                               ((act0 && top == pre0) || (act1 && top == pre1));
                mask |= (uint32_t)m << j;
              }
              const int n = __popc(mask);
              int incl = n;
#pragma unroll
              for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += y;
              }
              int slot = got + incl - n;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                if ((mask >> j) & 1u) {
                  if (slot < seg) mine[slot] = k[j];
                  ++slot;
                }
              }
              got += __shfl_sync(FULL, incl, 31);
            }
            __syncwarp();
            listed = true;
          }
        }
        if (listed && got <= seg) {
          for (int i = lane; i < got; i += 32) count_key(hist, mine[i], shift, act0, pre0, act1, pre1);
        } else {
          for (int i = warp * 32 + lane; i < n4; i += 2 * NT) {
            const uint4 v0 = k4[i];
            const uint4 v1 = i + NT < n4 ? k4[i + NT] : make_uint4(0u, 0u, 0u, 0u);
            const uint32_t k[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < 4 || i + NT < n4) count_key(hist, k[j], shift, act0, pre0, act1, pre1);
          }
        }
      }
      // One cluster round.  Round r adds into sums buffer r % 3 and zeroes
      // buffer (r + 1) % 3 before its barrier: that buffer was last read
      // in round r - 2, before barrier r - 1, and takes adds only after
      // barrier r.
      const int nb = level == 0 ? 256 : 512;
      int* a = acc + (round % 3) * 512;
      int* an = acc + ((round + 1) % 3) * 512;
      __syncthreads();
      for (int j = tid; j < 512; j += NT) {
        an[j] = 0;
        const int v = hist[j];
        hist[j] = 0;
        if (v) peer_add(peer_addr(a + j, j >> 5), v);
      }
      cluster.sync();
      const uint32_t pre[2] = {st[0], st[3]}, need[2] = {st[1], st[4]};
      const bool done[2] = {st[2] != 0u, st[5] != 0u};
      // warp w fetches bins [32w, 32w + 32) (rank w / 8 past level 0) and
      // scans them; then the one bin whose cumulative count first reaches
      // a rank's need holds its digit
      int* wtot = sums + 480;                          // the 16 warps' totals
      int v = 0, incl = 0;
      if (tid < nb) {
        v = (int)peer_load(peer_addr(a + tid, tid >> 5));
        if (level == 0) sums[tid] = v;
        incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) wtot[warp] = incl;
      }
      __syncthreads();
      if (tid < nb) {
        for (int r = 0; r < 2; ++r) {
          if ((level > 0 && r != warp / 8) || done[r]) continue;   // uniform in the warp
          const int first = level == 0 ? 0 : r * 8;
          int before = lane < warp - first ? wtot[first + lane] : 0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(FULL, before, o);
          const int below = before + incl - v;
          if (below < (int)need[r] && (int)need[r] <= below + v) {
            st[r * 3 + 0] = (pre[r] << 8) | (uint32_t)(tid & 255);
            st[r * 3 + 1] = need[r] - (uint32_t)below;
          }
        }
      }
      __syncthreads();
      if (level == 0) {
        // the keys under either rank's 8-bit prefix, a warp on average
        const bool same = !st[2] && !st[5] && st[3] == st[0];
        const int under = (st[2] ? 0 : sums[st[0]]) + (st[5] || same ? 0 : sums[st[3]]);
        wide = under > CLUSTER * NWARPS * (seg / 2);
      }
      ++round;
      if (st[2] && st[5]) break;        // the same in every CTA of the cluster
    }
    const uint32_t v_hi = st[0], v_lo = st[3];
    if (rank == 0 && tid == 0) {
      keys_out[((size_t)b * P + p) * 2 + 0] = v_hi;
      keys_out[((size_t)b * P + p) * 2 + 1] = v_lo;
    }

    // 4. binarize: a lane packs 8 consecutive keys of a row into a byte of
    //    each channel's bit row; then lane w dilates word w along
    //    frequency with its neighbours' words
    // raw keys against canonical thresholds: key > canon(v_hi) is exact
    // as it is (the threshold is never the -0.0 key), and key < canon(v_lo)
    // once a +0.0 threshold is lowered to the -0.0 key
    const uint32_t c_hi = canon(v_hi);
    const uint32_t c_lo = canon(v_lo) == SIGN ? 0x7FFFFFFFu : canon(v_lo);
    for (int row = warp; row < nrows; row += NWARPS) {
      uint8_t* rb = reinterpret_cast<uint8_t*>(bits + row * 2 * W);
      const uint32_t* kr = skeys + (size_t)row * F;
      for (int j = lane; j < 4 * W; j += 32) {
        uint32_t pb = 0u, nb = 0u;
        if (row < rows_here && 8 * j < F) {
          const uint4 a = *reinterpret_cast<const uint4*>(kr + 8 * j);
          const uint4 z = make_uint4(0u, 0u, 0u, 0u);
          const uint4 c = 8 * j + 4 < F ? *reinterpret_cast<const uint4*>(kr + 8 * j + 4) : z;
          const uint32_t k[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool in = i < 4 || 8 * j + 4 < F;
            pb |= (uint32_t)(k[i] > c_hi) << i;           // padding keys are 0
            nb |= (uint32_t)(in && k[i] < c_lo) << i;
          }
        }
        rb[j] = (uint8_t)pb;
        rb[4 * W + j] = (uint8_t)nb;
      }
      __syncwarp();
      if (rf > 0) {
        const uint32_t pw = lane < W ? bits[(row * 2 + 0) * W + lane] : 0u;
        const uint32_t nw = lane < W ? bits[(row * 2 + 1) * W + lane] : 0u;
        const uint32_t pd = dilate_row(pw, lane, W, rf), nd = dilate_row(nw, lane, W, rf);
        if (lane < W) {
          bits[(row * 2 + 0) * W + lane] = pd;
          bits[(row * 2 + 1) * W + lane] = nd;
        }
      }
    }

    // 5. time dilation across the cluster, row mask, the map out: a row a
    //    warp, a 16-byte (4-byte when F % 16 != 0) piece of a channel a lane
    cluster.sync();
    // the keys are dead: the next pair's rows land while this map leaves
    if (tid == 0 && q + (int)gridDim.y < Q) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(q + gridDim.y);
    }
    const size_t row_len = (size_t)2 * P * F;
    const bool vec16 = (F & 15) == 0;
    const int per_ch = vec16 ? F / 16 : F / 4;
    for (int row = warp; row < nrows; row += NWARPS) {
      const int t = r0 + row;
      uint8_t* dst_row = flat + ((size_t)b * T + t) * row_len + (size_t)(2 * p) * F;
      const int lo = max(0, t - rt), hi = t < vq ? min(vq - 1, t + rt) : t - rt - 1;
      for (int c2 = lane; c2 < 2 * per_ch; c2 += 32) {
        const int ch = c2 >= per_ch, c = c2 - ch * per_ch;
        const int wo = ch * W + (vec16 ? c >> 1 : c >> 3);
        uint32_t word = 0u;
        for (int u = lo; u <= hi; ++u) {
          const int lu = u - r0;
          if (lu >= 0 && lu < R) {
            word |= bits[lu * 2 * W + wo];
          } else {                       // a halo row of another CTA
            const int owner = u / R;
            word |= peer_load(peer_addr(bits + (u - owner * R) * 2 * W + wo, owner));
          }
        }
        uint8_t* dst = dst_row + (size_t)ch * F;
        if (vec16) {
          const uint32_t x = word >> ((c & 1) * 16);
          reinterpret_cast<uint4*>(dst)[c] =
              make_uint4(nibble_bytes(x & 15u), nibble_bytes((x >> 4) & 15u),
                         nibble_bytes((x >> 8) & 15u), nibble_bytes((x >> 12) & 15u));
        } else {
          reinterpret_cast<uint32_t*>(dst)[c] = nibble_bytes((word >> ((c & 7) * 4)) & 15u);
        }
      }
    }
    // the next pair's level-0 barrier keeps these bit rows alive until
    // the peers have read their halo rows
  }
  // no CTA leaves while its peers may still read its bit rows
  cluster.sync();
}

// ---- multipass variant ----------------------------------------------------
// state[q * 6 + r * 3 + {0, 1, 2}] = {prefix, remaining rank, done}
// for pair q = p * B + b and rank r (0: k, 1: n-1-k).

__global__ void __launch_bounds__(HIST_THREADS)
radix_hist(const float* __restrict__ planes, const int* __restrict__ valid,
           const uint32_t* __restrict__ state, int* __restrict__ hist,
           int B, int F, size_t TF, int level) {
  __shared__ int sh[512];
  for (int j = threadIdx.x; j < 512; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  const int q = blockIdx.y;
  const int vq = valid[q % B];
  const size_t nv = vq > 0 ? (size_t)vq * F : 0;
  const size_t n = nv < TF ? nv : TF;            // valid cells: a prefix
  const size_t start = (size_t)blockIdx.x * CHUNK;
  const size_t end = start + CHUNK < n ? start + CHUNK : n;
  const int shift = 24 - 8 * level;
  bool act_hi = true, act_lo = false;            // level 0: one shared histogram
  uint32_t pre_hi = 0, pre_lo = 0;
  if (level > 0) {
    pre_hi = state[q * 6 + 0];
    act_hi = state[q * 6 + 2] == 0;
    pre_lo = state[q * 6 + 3];
    act_lo = state[q * 6 + 5] == 0;
  }
  const float* src = planes + (size_t)q * TF;
  // the trip count is uniform across the block, so every lane reaches
  // hist_add together
  for (size_t base = start; base < end; base += (size_t)HIST_THREADS * 4) {
    const size_t i = base + threadIdx.x * 4;
    float v[4];
    if (i + 3 < end) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i + j < end ? src[i + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < end;
      const uint32_t key = order_key(v[j]);
      const int digit = (int)((key >> shift) & 255u);
      const uint32_t top = level > 0 ? key >> (shift + 8) : 0u;
      hist_add(sh, (in && act_hi && top == pre_hi) ? digit : -1);
      if (level > 0)
        hist_add(sh + 256, (in && act_lo && top == pre_lo) ? digit : -1);
    }
  }
  __syncthreads();
  int* g = hist + (size_t)q * 512;
  for (int j = threadIdx.x; j < 512; j += blockDim.x)
    if (sh[j]) atomicAdd(&g[j], sh[j]);
}

__global__ void radix_digit(const int* __restrict__ hist,
                            const int* __restrict__ need_in,
                            uint32_t* __restrict__ state, int Q, int B,
                            int level) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * Q) return;
  const int q = idx >> 1, r = idx & 1;
  uint32_t* st = state + q * 6 + r * 3;
  // level 0 counted every valid key once, into the first histogram
  const int* h = hist + (size_t)q * 512 + (level == 0 ? 0 : r * 256);
  uint32_t prefix;
  int need;
  if (level == 0) {
    prefix = 0;
    need = need_in[(q % B) * 2 + r];
    int total = 0;
    for (int d = 0; d < 256; ++d) total += h[d];
    // the bisection's edge cases: rank 0 selects key 0; a rank past
    // the valid cells selects the masked key 0xFFFFFFFF
    if (need <= 0 || need > total) {
      st[0] = need <= 0 ? 0u : 0xFFFFFFFFu;
      st[1] = 0;
      st[2] = 1;
      return;
    }
  } else {
    if (st[2]) return;
    prefix = st[0];
    need = (int)st[1];
  }
  int cum = 0, d = 0;
  for (; d < 255; ++d) {
    if (cum + h[d] >= need) break;
    cum += h[d];
  }
  st[0] = (prefix << 8) | (uint32_t)d;
  st[1] = (uint32_t)(need - cum);
  st[2] = 0;
}

__global__ void binspread(const float* __restrict__ planes,
                          const int* __restrict__ valid,
                          const uint32_t* __restrict__ state,
                          uint8_t* __restrict__ flat,
                          unsigned long long* __restrict__ keys,
                          int P, int B, int T, int F, int rf, int rt) {
  extern __shared__ uint8_t smb[];
  const int p = blockIdx.y, b = blockIdx.z, q = p * B + b;
  const int rows = TT + 2 * rt;
  uint8_t* s_pos = smb;
  uint8_t* s_neg = smb + rows * F;
  const uint32_t v_hi = state[q * 6 + 0], v_lo = state[q * 6 + 3];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    keys[(b * P + p) * 2 + 0] = v_hi;
    keys[(b * P + p) * 2 + 1] = v_lo;
  }
  const uint32_t c_hi = canon(v_hi), c_lo = canon(v_lo);
  const int vb = valid[b];
  const int t0 = blockIdx.x * TT;
  const float* src = planes + (size_t)q * T * F;
  for (int idx = threadIdx.x; idx < rows * F; idx += blockDim.x) {
    const int rr = idx / F, f = idx - rr * F;
    const int t = t0 - rt + rr;
    uint8_t pos = 0, neg = 0;
    if (t >= 0 && t < T && t < vb) {
      const uint32_t k = canon(order_key(src[(size_t)t * F + f]));
      pos = k > c_hi;
      neg = k < c_lo;
    }
    s_pos[idx] = pos;
    s_neg[idx] = neg;
  }
  __syncthreads();
  const size_t row_len = (size_t)2 * P * F;
  for (int idx = threadIdx.x; idx < TT * F; idx += blockDim.x) {
    const int r = idx / F, f = idx - r * F;
    const int t = t0 + r;
    if (t >= T) continue;
    uint8_t op = 0, on = 0;
    if (t < vb) {
      for (int dt = 0; dt <= 2 * rt; ++dt) {
        const int base = (r + dt) * F;
        for (int df = -rf; df <= rf; ++df) {
          const int ff = f + df;
          if (ff < 0 || ff >= F) continue;
          op |= s_pos[base + ff];
          on |= s_neg[base + ff];
        }
      }
    }
    uint8_t* dst = flat + (size_t)(b * T + t) * row_len + (size_t)(2 * p) * F + f;
    dst[0] = op;
    dst[F] = on;
  }
}

cudaError_t cluster_attributes() {
  static cudaError_t done = cudaErrorNotReady;   // set once per process
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(selbin_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MAX_SMEM);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(selbin_cluster,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return done;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int clusters,
                    cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER, (unsigned)clusters, 1);
  cfg->blockDim = dim3(NT, 1, 1);
  cfg->dynamicSmemBytes = MAX_SMEM;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool cluster_fits(int T, int F) {
  return F <= 1024 && cluster_need((T + CLUSTER - 1) / CLUSTER, F) <= MAX_SMEM;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 if the cluster variant takes planes of T x F (the wrapper's
// ``route`` is the same rule), else 0.
extern "C" int tsr_selbin_cluster_fits(int T, int F) { return cluster_fits(T, F) ? 1 : 0; }

// cudaOccupancyMaxActiveClusters of the cluster variant (its shared
// memory does not depend on the shape).
extern "C" int tsr_selbin_max_clusters(int* out) {
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, 1, 0);
  return cudaOccupancyMaxActiveClusters(out, selbin_cluster, &cfg);
}

namespace {
// The clusters the card runs at once, asked once per process; none is
// an error (the launch would never run).
cudaError_t resident_clusters(int* out) {
  static int clusters = -1;
  if (clusters < 0) {
    cudaError_t err = static_cast<cudaError_t>(tsr_selbin_max_clusters(&clusters));
    if (err != cudaSuccess) {
      clusters = -1;
      return err;
    }
  }
  *out = clusters;
  return clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}
}  // namespace

// planes [P, B, T, F] f32 (16-byte aligned, F % 4 == 0), need [B, 2]
// i32, valid [B] i32 -> flat [B, T, 2PF] u8, keys [B, P, 2] u64.
// A failed launch (no co-schedulable cluster, a shape it does not take)
// returns its error; nothing falls back.
extern "C" int tsr_selbin_cluster(const float* planes, const int* need, const int* valid,
                                  uint8_t* flat, unsigned long long* keys, int P, int B,
                                  int T, int F, int rf, int rt, void* stream) {
  if (!cluster_fits(T, F)) return cudaErrorInvalidValue;
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = resident_clusters(&clusters);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, min(P * B, clusters), static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, selbin_cluster, planes, need, valid, flat, keys, P, B, T, F,
                           (T + CLUSTER - 1) / CLUSTER, rf, rt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The same contract for any plane size.
// Scratch: hist [4, P*B, 2, 256] i32, then state [P*B, 6] u32.
extern "C" int tsr_selbin_multipass(const float* planes, const int* need, const int* valid,
                                    uint8_t* flat, unsigned long long* keys, int* scratch,
                                    int P, int B, int T, int F, int rf, int rt,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Q = P * B;
  const size_t TF = (size_t)T * F;
  const size_t per_level = (size_t)Q * 512;
  int* hist = scratch;
  uint32_t* state = reinterpret_cast<uint32_t*>(scratch + 4 * per_level);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * 4 * per_level, s);
  if (err != cudaSuccess) return err;
  const dim3 hgrid((unsigned)((TF + CHUNK - 1) / CHUNK), (unsigned)Q);
  for (int level = 0; level < 4; ++level) {
    radix_hist<<<hgrid, HIST_THREADS, 0, s>>>(planes, valid, state,
                                              hist + level * per_level, B, F,
                                              TF, level);
    radix_digit<<<(2 * Q + 63) / 64, 64, 0, s>>>(hist + level * per_level,
                                                 need, state, Q, B, level);
  }
  const size_t smem = (size_t)2 * (TT + 2 * rt) * F;
  static size_t smem_set = 48 * 1024;   // raised only when a shape needs more
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(binspread, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  binspread<<<dim3((T + TT - 1) / TT, P, B), 256, smem, s>>>(
      planes, valid, state, flat, keys, P, B, T, F, rf, rt);
  return cudaGetLastError();
}
