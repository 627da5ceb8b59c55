// Kernel 10: the direct sliding-window LLR correlation, for Hopper: TMA
// loads into shared memory, wgmma from shared memory, one producer warp
// and two consumer warpgroups; a block keeps each 64-column slice of its
// frames resident and takes the sliding window as a row offset.
//
// Replaces template_speech_recognition_tpu/ops/correlation_pallas.py
//   correlation_scores_pallas (pallas_call at line 102).
//
//   out[b, k, t] = c[k] + sum_{tau < L} sum_{d < D} F[b, t + tau, d] * W[k, tau, d]
//
// for t < T'' = T - L + 1: bf16 operands, fp32 accumulation, fp32 out
// [B, K, T''].
//
// What bounds it on the H100: bf16 operations.  At the reference's bench
// shape (B = 8, T = 3000, K = 1024, L = 32, D = 2048) 3.19 TFLOP take
// 3.22 ms at 989 TFLOP/s; the least bytes (W 134 MB, the maps 98 MB, the
// scores 97 MB) take 0.1 ms.  At one utterance (B = 1) 0.40 ms.
//
// Design.  One GEMM a tile whose contraction index is split as (d-chunk,
// tau).  A tile is BM = 128 templates (the wgmma M side, A operand:
// consumer warpgroup 0 the first 64, warpgroup 1 the next 64) by BN
// window starts t0 .. t0+BN-1 of one utterance b (the N side, B
// operand).  Step (dc, tau) multiplies
//   A = W[k0 : k0+128, tau, 64 dc : 64 dc + 64]          (templates x d)
//   B = F[b, t0+tau : t0+tau+BN, 64 dc : 64 dc + 64]     (starts x d)
// both K-major as they lie (d contiguous), so neither needs a transpose
// bit; the contraction is ceil(D / 64) * L steps (1,024 at the bench
// shape), d-chunks outer and tau inner.  The contraction is never split
// across blocks: every output is one block's sum in one fixed order, so
// two launches are bitwise equal.
//
// The feed from L2 is what bounds a tile this size when both operands
// stream: a 128 x 192 x 64 step reads a 16 KB W box and a 24 KB frame
// box for 3.1 MFLOP, and L2 cannot deliver 40 KB a step at the tensor
// cores' rate (probe_correlation.py, variant stream_f; PERF.md).  But
// consecutive tau read the same frames shifted by one row.  So the frames come as panels: rows t0 + tau0 .. t0 + tau0 + BN
// + 31 of one 64-column chunk serve the 32 shifts tau0 .. tau0 + 31
// (TAU_GROUP), and step tau reads the panel from row tau - tau0 on: the
// wgmma descriptor's start address moves by tau - tau0 rows.  Only W
// streams, 16 KB a step; a 28 KB panel comes once per 32 steps.
//
// Layouts.  W comes by TMA through a 3-D map {D, L, K} as one {64, 1,
// 128} box at (64 dc, tau, k0), 128-byte swizzled (the canonical K-major
// SW128 layout).  A panel cannot be swizzled: the swizzle's phase is the
// row index mod 8, which a one-row start offset would break.  So it is
// kept in the canonical K-major layout without swizzle: eight strips of
// 8 columns (16 bytes) each, rows 16 bytes apart within a strip, so an
// 8-row core matrix is 128 contiguous bytes (conflict-free) wherever it
// starts, and a row offset is just 16 bytes of start address; the
// descriptor's LBO is the strip stride (the next 8 columns), SBO 128
// bytes (the next 8 rows).  Each strip comes by TMA through a 3-D map
// {D, T, B} as {8, PBOX, 1} boxes at (64 dc + 8 j, row, b): the same map
// for every tau, nothing materialized, no overlapping strides.  TMA
// zero-fills what lies outside the maps: the columns d >= D of a partial
// last chunk (D = 40 or 504) in both operands, so that chunk adds exactly
// zero; rows past T; templates k >= K.  Starts t >= T'' are computed and
// never stored.
//
// Pipeline.  A ring of STAGES 16 KB W boxes and a ring of PANELS panels,
// each slot with a full and an empty mbarrier.  The producer thread
// issues a group's panel, then its W boxes.  Consumers wait for "full",
// issue four k16 wgmmas (m64nBNk16) a step, and once wgmma.wait_group 1
// has retired the previous step's reads release its W slot, and its
// panel after a group's last step.
//
// Epilogue: c[k] added; the accumulator's columns are consecutive t, so
// a thread stores 8-byte pairs along t (four lanes to a 32-byte sector),
// 4-byte stores where a pair would be misaligned (T'' odd) or straddle
// T''.
//
// Grid: x = (utterance, t-tile), t-tiles fastest; y = template tiles, so
// the blocks that share a W tile run together.  One block an SM (222 KB
// of shared memory: ten W slots and two panels).  BN = 192 gives 16
// t-tiles at T'' = 2969, so one utterance fills 128 of the 132 SMs; 256
// is as fast at B = 8 and slower at B = 1 (variant bn256; PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // templates a tile (two consumer warpgroups)
constexpr int BN = 192;                  // window starts a tile
constexpr int BK = 64;                   // d columns a step: 128 bytes of bf16
constexpr int TAU_GROUP = 32;            // shifts one resident panel serves
constexpr int THREADS = 384;             // producer warpgroup + two consumers
constexpr int A_BYTES = BM * BK * 2;     // 16 KB, one 128B-swizzled W box
constexpr int PROWS = (BN + TAU_GROUP - 1 + 7) / 8 * 8;   // frames a panel
constexpr int PBOXES = (PROWS + 255) / 256;               // TMA boxes a strip
constexpr int PBOX = PROWS / PBOXES;                       // rows a box (<= 256)
constexpr int STRIP_BYTES = PROWS * 16;  // 8 columns of a panel
constexpr int PANEL_BYTES = 8 * STRIP_BYTES;
constexpr int PANELS = 2;
constexpr int STAGES = (232448 - 1024 - PANELS * PANEL_BYTES - 512) / A_BYTES;
constexpr int SMEM_BYTES =
    1024 + STAGES * A_BYTES + PANELS * PANEL_BYTES + 2 * (STAGES + PANELS) * 8;
static_assert(PBOX * PBOXES == PROWS && PBOX % 8 == 0, "panel boxes of whole 128-byte units");
static_assert(STAGES >= 4, "the ring needs four stages");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");

// wgmma shared-memory descriptors (16-byte units).  W: 128-byte swizzle,
// rows of 128 bytes, 8-row groups 1024 bytes apart, the next k16 slice
// 32 bytes further.  Panel: no swizzle, LBO the strip stride, SBO 128
// bytes, the next k16 slice two strips further, the next row 16 bytes.
constexpr uint64_t W_SBO = 1024 >> 4;
constexpr uint32_t W_K16 = 32 >> 4;
constexpr uint64_t P_LBO = STRIP_BYTES >> 4;
constexpr uint64_t P_SBO = 128 >> 4;
constexpr uint32_t P_K16 = (2 * STRIP_BYTES) >> 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc_w(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (W_SBO << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_panel(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (P_LBO << 16) | (P_SBO << 32);
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N, f32) += A (64 x 16) . B (16 x N), both K-major: N = BN, or
// 256 for probe_correlation.py's bn256 variant
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_n<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_n<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
correlation_kernel(const __grid_constant__ CUtensorMap map_f,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ c, float* __restrict__ out,
                   int K, int Tv, int L, int n_tt, int n_dc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // 128B-swizzle atoms
  const uint32_t panels = base + STAGES * A_BYTES;
  const uint32_t bars = panels + PANELS * PANEL_BYTES;
  auto a_s = [&](int s) { return base + s * A_BYTES; };
  auto panel = [&](int p) { return panels + p * PANEL_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto pfull = [&](int p) { return bars + 8 * (2 * STAGES + p); };
  auto pempty = [&](int p) { return bars + 8 * (2 * STAGES + PANELS + p); };

  const int b = blockIdx.x / n_tt;
  const int t0 = (blockIdx.x - b * n_tt) * BN, k0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    for (int p = 0; p < PANELS; ++p) {
      mbar_init(pfull(p), 1);
      mbar_init(pempty(p), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0, p = 0;
      uint32_t ph = 0, pph = 0;
      for (int dc = 0; dc < n_dc; ++dc) {
        for (int tau0 = 0; tau0 < L; tau0 += TAU_GROUP) {
          mbar_wait(pempty(p), pph ^ 1);
          mbar_expect_tx(pfull(p), PANEL_BYTES);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < PBOXES; ++h)
              tma_load_3d(panel(p) + j * STRIP_BYTES + h * PBOX * 16, &map_f, pfull(p),
                          dc * BK + 8 * j, t0 + tau0 + h * PBOX, b);
          if (++p == PANELS) {
            p = 0;
            pph ^= 1;
          }
          const int tau1 = min(L, tau0 + TAU_GROUP);
          for (int tau = tau0; tau < tau1; ++tau) {
            mbar_wait(empty(s), ph ^ 1);
            mbar_expect_tx(full(s), A_BYTES);
            tma_load_3d(a_s(s), &map_w, full(s), dc * BK, tau, k0);
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 -> templates k0 .. k0+63, 2 -> the next
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0, p = 0, prev_s = -1, prev_p = -1;
    uint32_t ph = 0, pph = 0;
    for (int dc = 0; dc < n_dc; ++dc) {
      for (int tau0 = 0; tau0 < L; tau0 += TAU_GROUP) {
        mbar_wait(pfull(p), pph);
        const int tau1 = min(L, tau0 + TAU_GROUP);
        for (int tau = tau0; tau < tau1; ++tau) {
          mbar_wait(full(s), ph);
          const uint64_t da = desc_w(a_s(s) + half * (A_BYTES / 2));
          const uint64_t db = desc_panel(panel(p) + (tau - tau0) * 16);
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_n<BN>(acc, da + kk * W_K16, db + kk * P_K16);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          fence_acc(acc);
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_acc(acc);
          // the previous step's reads are retired: free its W slot, and
          // its panel after a group's last step
          if (prev_s >= 0) mbar_arrive(empty(prev_s));
          if (prev_p >= 0) mbar_arrive(pempty(prev_p));
          prev_s = s;
          prev_p = tau == tau1 - 1 ? p : -1;
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
        if (++p == PANELS) {
          p = 0;
          pph ^= 1;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // accumulator layout (per warp, as mma.sync m16n8): register 4g + e
    // holds template row 16 warp + lane/4 + 8 (e/2), start column
    // 8g + 2 (lane%4) + e%2
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * half + 16 * warp + (lane >> 2) + 8 * h;
      if (k >= K) continue;
      const float ck = c[k];
      float* row = out + ((size_t)b * K + k) * Tv;
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        const int t = t0 + 8 * g + 2 * (lane & 3);
        const float v0 = acc[4 * g + 2 * h] + ck, v1 = acc[4 * g + 2 * h + 1] + ck;
        if (t + 1 < Tv && (reinterpret_cast<uintptr_t>(row + t) & 7) == 0) {
          *reinterpret_cast<float2*>(row + t) = make_float2(v0, v1);
        } else {
          if (t < Tv) row[t] = v0;
          if (t + 1 < Tv) row[t + 1] = v1;
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

// A 3-D bf16 map {d0 (contiguous), d1, d2} with a {box0, box1, box2}
// box, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
              uint32_t box0, uint32_t box1, uint32_t box2, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {box0, box1, box2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats [B, T, D] bf16, w [K, L, D] bf16, c [K] f32 -> out [B, K, T-L+1]
// f32.  D % 8 == 0 (16-byte map strides), 1 <= L <= T, B*(T-L+1) below
// 2^31, bases 16-byte aligned.  A map that does not encode returns
// cudaErrorInvalidValue; nothing falls back.
extern "C" int tsr_correlation(const void* feats, const void* w, const void* c, void* out,
                               int B, int T, int D, int K, int L, void* stream) {
  CUtensorMap map_f, map_w;
  if (!make_map(&map_f, feats, D, T, B, 8, PBOX, 1, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_w, w, D, L, K, BK, 1, BM, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int Tv = T - L + 1;
  const int n_tt = (Tv + BN - 1) / BN;
  const dim3 grid((unsigned)(B * n_tt), (unsigned)((K + BM - 1) / BM));
  correlation_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_f, map_w, static_cast<const float*>(c), static_cast<float*>(out), K, Tv, L, n_tt,
      (D + BK - 1) / BK);
  return cudaGetLastError();
}
