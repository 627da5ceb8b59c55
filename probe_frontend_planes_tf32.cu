// A tensor-core redesign of kernel 1 (windowed frames -> four oriented
// difference planes), for Hopper: the DFT as a 3-pass TF32 split, TMA
// loads into a shared-memory ring, wgmma with A from registers, one
// producer warp and two consumer warpgroups.
//
// The port does not launch it: probe_frontend_planes.py builds it and
// holds it, beside the port's kernel (template_speech_recognition_tpu_
// torch/csrc/frontend_planes.cu, fp32 SIMT), against the plain version
// and against float64.  It computes the same function as that kernel,
// both modes (log-magnitude and log-mel), written plane-major [4, N, F];
// see ops/frontend_kernel.py for the function.
//
// What bounds it on the H100.  The DFT is 4 N FL (W + 1) flops (10.1
// GFLOP at N = 24,576, FL = 400, W = 256): 0.15 ms at the 67 TFLOP/s of
// fp32 SIMT, of which the port's SIMT kernel reaches a fifth.  The
// tensor cores take TF32 at 495 TFLOP/s; three
// passes keep fp32's precision class (below): 0.061 ms.  The bytes,
// frames in and planes out (39 + 101 MB), take 0.042 ms.  Every block
// reads its column tile's split basis (0.8 MB) from L2, 0.64 GB for the
// grid: 0.09-0.13 ms at 5-7 TB/s, so L2, not the math, is the likely
// limiter.
//
// The split.  x = hi + lo + r with hi = rna_tf32(x), lo = rna_tf32(x -
// hi), |r| <= 2^-22 |x|; each product is hi.hi + hi.lo + lo.hi (the
// dropped lo.lo is under 2^-22 of it): a term is off by about 3 x 2^-22
// of itself, an eighth of the fp32 summation bound 400 x 2^-24 that the
// planes are held to (ops/frontend_kernel.py::planes64).  The basis is
// split once on the host (split_tf32) and stored K-major [6, bins, FL]:
// cos-hi, cos-lo, sin-hi, sin-lo, cos, sin.  Frames are split in
// registers with cvt.rna.tf32.f32, so A comes from registers (TF32
// wgmma takes only K-major operands, and this way the frames are read
// from shared memory once for the three passes).
//
// The sums.  wgmma's f32 accumulation is not round-to-nearest: each
// instruction's result is cut, not rounded.  150 of them (three passes
// of 50 k8 steps) into one accumulator drifted away from the plain
// version, past its 1e-5 scaled check near the floor (1.87e-5 at the
// bench shape on an H100).  So each k8 step's three wgmmas start a fresh
// tensor-core sum (scale-d = 0 on the first), the two small products
// first, so that only the last cut is at the scale of the products; the
// step's sum is added to the running one with a round-to-nearest f32
// add, 50 adds at FL = 400.  That takes a second accumulator set, so a
// warpgroup owns 64 columns, not 128.
//
// Design.  A work item is BM = 64 frame rows (one wgmma M) of one
// column tile; planes are written for its first 63 rows: row tiles
// overlap by one row (r0 = 63 i), so every row's "next" row is in its
// own tile; row N - 1's next is itself (the clamp of the plain
// version).  A column tile is BN = 128 DFT columns: consumer warpgroup
// 0 owns the first 64, warpgroup 1 the next 64, each with its cos and
// its sin accumulator (running and step: four m64n64 f32 tiles, 128
// registers a thread), so the power forms in registers.  The one column
// past the tile that the frequency differences read (the next tile's
// first, or the Nyquist bin) is a SIMT dot with the unsplit basis on
// the A fragments already in registers: warpgroup 0 sums its cos part,
// warpgroup 1 its sin part.  Stages hold BK = 16 k: the frames tile (64
// x 16, no swizzle: threads read it) and the four basis tiles (128 x 16
// each, 64-byte swizzle) that wgmma reads, 36 KB; five stages, four
// when the mel sums need the room.  Each k8 step waits for its wgmmas
// (wgmma.wait_group 0) before it adds their sums and reuses its A
// registers; the other warpgroup's wgmmas fill the gap.  The grid is
// persistent, one block an SM walking the work items with row tiles
// fastest, so the blocks in flight share a column tile's basis in L2,
// and the producer fills the ring for the next item while the
// consumers run the epilogue.
//
// Epilogue, in a region of its own: log-magnitude mode builds the [64,
// 129] log-spectrum tile and stores the four differences for 63 rows.
// Log-mel mode builds the power tile, adds each filter's nonzero bins,
// in increasing order, into a [64, n_mels] accumulator (fp32 SIMT fmaf,
// the sequence of the plain version's sum), walking a row tile's column
// tiles in order; after the last, the log and the differences.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                       // frame rows a block computes
constexpr int TM = BM - 1;                   // rows it writes planes for
constexpr int BN = 128;                      // DFT columns a tile
constexpr int WN = 64;                       // columns a consumer warpgroup
constexpr int BK = 16;                       // k a stage: 64 bytes of f32
constexpr int THREADS = 384;                 // producer warpgroup + two consumers
constexpr int A_BYTES = BM * BK * 4;         // 4 KB frames tile
constexpr int B_BYTES = BN * BK * 4;         // 8 KB a basis operand
constexpr int STAGE_BYTES = A_BYTES + 4 * B_BYTES;
constexpr int LD = BN + 1;                   // spectrum tile row stride (floats)
constexpr int MAX_SMEM = 232448;
constexpr float LOG_EPS = 1e-6f;

// basis operands in a stage, and planes of the basis tensor
constexpr int COS_HI = 0, COS_LO = 1, SIN_HI = 2, SIN_LO = 3, COS = 4;

// the ring, the spectrum tile, the column past it, the mel sums, the
// ring's barriers; 1 KB to align the ring
size_t smem_bytes(int stages, int nm) {
  return 1024 + (size_t)stages * STAGE_BYTES + (size_t)BM * LD * 4 + (size_t)BM * 2 * 4 +
         (size_t)BM * nm * 4 + (size_t)2 * stages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a K-major operand with a 64-byte
// swizzle: rows of 64 bytes, 8-row groups 512 bytes apart (SBO, in
// 16-byte units); LBO is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// consumer warpgroups only (threads 128..383)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, f32) = A (64 x 8, tf32, registers) . B (8 x 64, K-major
// tf32) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ float power_of(float re, float im) {
  // no FMA contraction: the same roundings as the plain version's
  // re*re + im*im
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__global__ void __launch_bounds__(THREADS, 1)
planes_kernel(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ basis,    // [6, W + 1, FL]
              const float* __restrict__ fbt,      // [NM, W + 1]
              const int* __restrict__ mrange,     // [NM, 2]
              float* __restrict__ out,            // [4, N, F]
              int N, int FL, int W, int NM, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const tile = reinterpret_cast<float*>(base_ptr + (size_t)stages * STAGE_BYTES);
  float* const ex = tile + BM * LD;                                        // [BM][2]
  float* const mel = ex + BM * 2;                                          // [BM][NM]
  const uint32_t bars = smem_u32(mel + BM * NM);
  auto a_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_s = [&](int s, int j) { return base + s * STAGE_BYTES + A_BYTES + j * B_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int bins = W + 1;
  const int nt = (W + BN - 1) / BN;                 // column tiles
  const int n_rt = (N + TM - 1) / TM;               // row tiles
  // work items: (row tile, column tile), row tiles fastest; in mel mode
  // a row tile, whose column tiles are walked in order
  const int n_work = NM ? n_rt : n_rt * nt;
  const int tiles = NM ? nt : 1;
  const int nk = (FL + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const int r0 = (w % n_rt) * TM, t0 = NM ? 0 : w / n_rt;
        for (int t = t0; t < t0 + tiles; ++t) {
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % stages;
            mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
            mbar_expect_tx(full(s), STAGE_BYTES);
            tma_load_2d(a_s(s), &map_x, full(s), kt * BK, r0);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load_3d(b_s(s, j), &map_b, full(s), kt * BK, t * BN, j);
          }
        }
      }
    }
  } else {
    // ---- consumers: WG1 -> columns [c0, c0 + 64), WG2 -> the next 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int part = wg - 1;
    const int ct = threadIdx.x - 128;              // 0..255
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int ra = 16 * warp + g;                  // A fragment rows ra, ra + 8
    int it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int r0 = (w % n_rt) * TM, t0 = NM ? 0 : w / n_rt;
      for (int t = t0; t < t0 + tiles; ++t) {
        const int c0 = t * BN;
        const int cx = min(c0 + BN, W);            // the column past the tile
        const float* bx = basis + ((size_t)(COS + part) * bins + cx) * FL;
        // re, im: the running sums, to which each k8 step's tensor-core
        // sums sre, sim are added with a round-to-nearest f32 add
        float re[32], im[32], sre[32], sim[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) { re[i] = 0.f; im[i] = 0.f; }
        float e0 = 0.f, e1 = 0.f;                  // column cx, rows ra and ra + 8
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % stages;
          mbar_wait(full(s), (it / stages) & 1);
          const float* as = reinterpret_cast<const float*>(base_ptr + (size_t)s * STAGE_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            // A fragment (as mma.m16n8k8.tf32): a0 (ra, k), a1 (ra + 8, k),
            // a2 (ra, k + 4), a3 (ra + 8, k + 4)
            const int k = 8 * kk + tq;
            const float x0 = as[ra * BK + k], x1 = as[(ra + 8) * BK + k];
            const float x2 = as[ra * BK + k + 4], x3 = as[(ra + 8) * BK + k + 4];
            const int kg = kt * BK + k;
            const float b0 = kg < FL ? __ldg(bx + kg) : 0.f;
            const float b1 = kg + 4 < FL ? __ldg(bx + kg + 4) : 0.f;
            e0 = fmaf(x2, b1, fmaf(x0, b0, e0));
            e1 = fmaf(x3, b1, fmaf(x1, b0, e1));
            uint32_t hi[4], lo[4];
            hi[0] = rna_tf32(x0); lo[0] = rna_tf32(x0 - __uint_as_float(hi[0]));
            hi[1] = rna_tf32(x1); lo[1] = rna_tf32(x1 - __uint_as_float(hi[1]));
            hi[2] = rna_tf32(x2); lo[2] = rna_tf32(x2 - __uint_as_float(hi[2]));
            hi[3] = rna_tf32(x3); lo[3] = rna_tf32(x3 - __uint_as_float(hi[3]));
            const uint32_t off = part * (WN * BK * 4) + kk * 32;
            fence_acc(sre);
            fence_acc(sim);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            // the two small products first (the first starts a fresh
            // sum), then hi . hi: only the last cut is at the scale of
            // the products
            wgmma_64(sre, hi, desc_sw64(b_s(s, COS_LO) + off), 0);
            wgmma_64(sim, hi, desc_sw64(b_s(s, SIN_LO) + off), 0);
            wgmma_64(sre, lo, desc_sw64(b_s(s, COS_HI) + off), 1);
            wgmma_64(sim, lo, desc_sw64(b_s(s, SIN_HI) + off), 1);
            wgmma_64(sre, hi, desc_sw64(b_s(s, COS_HI) + off), 1);
            wgmma_64(sim, hi, desc_sw64(b_s(s, SIN_HI) + off), 1);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_acc(sre);
            fence_acc(sim);
            if (kk == BK / 8 - 1) mbar_arrive(empty(s));
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              re[i] = __fadd_rn(re[i], sre[i]);
              im[i] = __fadd_rn(im[i], sim[i]);
            }
          }
        }

        // ---- epilogue of the tile (the ring is already refilling) ------
        e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
        e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
        consumers_sync();                          // the last tile's readers are done
        if (tq == 0) {
          ex[ra * 2 + part] = e0;
          ex[(ra + 8) * 2 + part] = e1;
        }
        // accumulator layout (per warp, as mma.sync m16n8): register 4j + e
        // holds row 16 warp + lane/4 + 8 (e/2), column 8j + 2 (lane%4) + e%2
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = ra + 8 * ((i >> 1) & 1);
          const int col = part * WN + 8 * (i >> 2) + 2 * tq + (i & 1);
          const float p = power_of(re[i], im[i]);
          tile[row * LD + col] = NM ? p : 0.5f * logf(__fadd_rn(p, LOG_EPS));
        }
        consumers_sync();
        if (ct < BM) {
          const float p = power_of(ex[2 * ct], ex[2 * ct + 1]);
          tile[ct * LD + BN] = NM ? p : 0.5f * logf(__fadd_rn(p, LOG_EPS));
        }
        consumers_sync();
        if (NM) {
          // this tile's bins of each filter's nonzero range [lo, hi), in
          // increasing order, onto the running sums
          const int cend = t == nt - 1 ? bins : c0 + BN;
          for (int idx = ct; idx < BM * NM; idx += 256) {
            const int r = idx / NM, m = idx - r * NM;
            const int lo = max(mrange[2 * m], c0), hi = min(mrange[2 * m + 1], cend);
            const float* pr = tile + r * LD - c0;
            const float* fr = fbt + (size_t)m * bins;
            float acc = t == 0 ? 0.f : mel[idx];
            for (int b = lo; b < hi; ++b) acc = fmaf(pr[b], __ldg(fr + b), acc);
            mel[idx] = t == nt - 1 ? logf(__fadd_rn(acc, LOG_EPS)) : acc;
          }
          consumers_sync();
          if (t < nt - 1) continue;
        }

        // ---- the four differences against row r + 1 -------------------
        const float* spec = NM ? mel : tile;
        const int ld = NM ? NM : LD;
        const int F = NM ? NM - 1 : W;
        const int f0 = NM ? 0 : c0;
        const int fn = min(NM ? F : BN, F - f0);
        const size_t plane = (size_t)N * F;
        for (int idx = ct; idx < TM * fn; idx += 256) {
          const int r = idx / fn, j = idx - r * fn;
          const int row = r0 + r;
          if (row >= N) continue;
          const float* cur = spec + r * ld;
          const float* nxt = row + 1 < N ? cur + ld : cur;
          const size_t o = (size_t)row * F + f0 + j;
          out[o] = nxt[j] - cur[j];                   // d_time
          out[plane + o] = cur[j + 1] - cur[j];       // d_freq
          out[2 * plane + o] = nxt[j + 1] - cur[j];   // d_diag
          out[3 * plane + o] = nxt[j] - cur[j + 1];   // d_anti
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime,
// so the library links against nothing but cudart.
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// An f32 map of `rank` dims {d0 (contiguous), d1[, d2]} with a box of
// {BK, box1, 1}, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int rank, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {BK, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the deepest ring, up to 5 stages, that leaves room for the mel sums
int stages_for(int NM) {
  int stages = 5;
  while (stages > 2 && smem_bytes(stages, NM) > (size_t)MAX_SMEM) --stages;
  return stages;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dynamic shared memory a launch with NM mel filters asks for.
extern "C" int tsr_frontend_planes_tf32_smem(int NM) {
  return (int)smem_bytes(stages_for(NM), NM);
}

// frames [N, FL] f32 (FL % 4 == 0, 16-byte aligned), basis [6, W + 1,
// FL] f32 (cos-hi, cos-lo, sin-hi, sin-lo, cos, sin; -sin, in fact) ->
// out [4, N, F] f32.  Log-magnitude mode (NM == 0): F = W; fbt and
// mrange are unused.  Log-mel mode (NM >= 2): fbt [NM, W + 1] f32 is the
// transposed mel filterbank, mrange [NM, 2] int32 each filter's nonzero
// bins [lo, hi), and F = NM - 1.
extern "C" int tsr_frontend_planes_tf32(const float* frames, const float* basis,
                                        const float* fbt, const int* mrange, float* out, int N,
                                        int FL, int W, int NM, void* stream) {
  const int bins = W + 1;
  CUtensorMap map_x, map_b;
  if (!make_map(&map_x, frames, 2, FL, N, 1, BM, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_b, basis, 3, FL, bins, 6, BN, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int stages = stages_for(NM);
  const size_t smem = smem_bytes(stages, NM);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return cudaGetLastError();
  const int n_rt = (N + TM - 1) / TM;
  const int n_work = NM ? n_rt : n_rt * ((W + BN - 1) / BN);
  planes_kernel<<<min(n_work, sms), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_b, basis, fbt, mrange, out, N, FL, W, NM, stages);
  return cudaGetLastError();
}
