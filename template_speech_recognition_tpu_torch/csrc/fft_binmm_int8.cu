// int8 per-bin bank matmul of the overlap-save FFT scorer, for Hopper:
// TMA loads into a shared-memory ring, int8 wgmma from shared memory,
// one producer warp and two consumer warpgroups, TMA stores.
//
// Replaces template_speech_recognition_tpu/ops/fft_binmm_pallas.py
//   fft_binmm_pallas in int8 mode: _kernel_q (line 81; pallas_call at
//   line 202).
//
// Per frequency bin z, with xq_r, xq_i [bins, m, D] and the int8 spectra
// W2[z] = [Wa ; Wb] (2D x K):
//   Re = Xr . Wa + Xi . Wb,   Im = Xi . Wa - Xr . Wb
// summed exactly in int32 (|acc| <= 2D 127^2 = 66,064,384 at D 2048) and
// flushed as two planes, hi = bf16_rn(v), v = f32_rn(acc) * sc[z][k], at
// out[0][part][z][r][k] and lo = bf16_rn(v - f32(hi)) at
// out[1][part][z][r][k], the arithmetic of the plain version, so the two
// agree bitwise.  hi + lo keeps v to ~2^-16 of it: two evaluations whose
// int8 spectra differ by a quantum do not round a low bin's product a
// whole bf16 step apart.
//
// What bounds it on the H100: bytes.  At the scan's shapes (bins 80, m
// 192, D 2048, K 1024) W2 (336 MB) + xr/xi (63 MB) + the two bf16 output
// planes (126 MB) take 0.157 ms at 3.35 TB/s; the 258 G int8 operations
// take 0.130 ms at 1979 TOP/s.  Only wgmma reaches that rate, and it reads its
// operands from shared memory in the swizzled layouts TMA writes.
//
// Design: the bf16 kernel's (fft_binmm.cu) on int8 wgmma, m64n256k32
// s8 x s8 -> s32.  A block owns one 64-row slab of m, BN = 256 templates
// and one bin; consumer warpgroup 0 sums Re, warpgroup 1 Im, a 64 x 256
// int32 tile each (128 registers a thread).  A stage is BK = 128 int8,
// one 128-byte swizzled row: an Xr and an Xi tile (64 x 128 B each) and
// a W2 tile (256 x 128 B), 48 KB; four stages.  Grid: row slabs fastest,
// then template tiles, then bins, so W2 streams from device memory about
// once.  Two things int8 wgmma lacks shape it:
//
// * No transpose: int8 operands are K-major only, and W2 [bins, 2D, K]
//   is MN-major.  The kernel reads the bank's K-major copy [bins, 2, K,
//   Dp] (kmajor_spectra, built once with the bank; rows padded to Dp =
//   D rounded up to 16, since TMA takes only 16-byte strides) as a 3-D
//   map [2 bins, K, D]: columns past D, rows past K and past a half read
//   as zeros.  xr and xi come as views of rows padded the same way
//   (quantize_block_spectra), 3-D maps [bins, m, D] with their strides.
// * No scale-a, so no -Xr for free.  The contraction runs over W2's
//   second half first: warpgroup 0 sums Xi . Wb, warpgroup 1 Xr . Wb;
//   at the seam warpgroup 1 retires its wgmmas (wait_group 0) and
//   negates its int32 sums in registers; then warpgroup 0 sums Xr . Wa
//   and warpgroup 1 Xi . Wa, which leaves Xi . Wa - Xr . Wb.  Each A tile
//   still feeds both parts, and the negation is exact.
//
// Ring: STAGES x 48 KB with a full and an empty mbarrier each.  The
// producer waits for "empty" (all 256 consumer threads arrive), sets the
// expected bytes and issues six TMA loads (Xr, Xi, four 64-row W2 boxes)
// onto "full".  A consumer waits for "full", issues its four k32 wgmmas,
// and releases the previous stage once wgmma.wait_group 1 has retired its
// reads.  Epilogue: both warpgroups meet at a named barrier (the ring is
// then free), each scales its sums, rounds them to bf16 and writes them
// into a 128-byte swizzled 32 KB staging tile in the ring's memory (four
// 64 x 64 boxes), and one thread stores the boxes with TMA through a 3-D
// map [2 bins, m, K]: rows past m and columns past K are clipped.
//
// Probe variants (probe_fft_binmm_int8.py builds them with -D; the port
// builds none): BINMM_BN=128 (64 x 128 tiles), BINMM_REG_A (warpgroup 1
// takes -Xr from registers, negated by __vsub4, and wgmma with A from
// registers: no seam), BINMM_CLUSTER=3 (clusters of three slabs, each
// W2 tile multicast by TMA to the three), BINMM_NO_STORE (no output
// stores) and BINMM_NO_W (no W2 loads); the last two compute garbage.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, loops of 100 launches)
// it takes 0.222 ms at the scan's shape, 0.62 of its bound, and 0.083 ms
// at the log-mel D = 504; the variants that compute were all slower
// (probe_fft_binmm_int8.py; PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef BINMM_BN
#define BINMM_BN 256
#endif
#ifndef BINMM_CLUSTER
#define BINMM_CLUSTER 1
#endif
#if defined(BINMM_REG_A) && BINMM_BN != 256
#error "BINMM_REG_A is built at BINMM_BN 256 only"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;                   // rows of m per block (one wgmma M)
constexpr int BN = BINMM_BN;             // templates per block
constexpr int BK = 128;                  // int8 contraction per stage: 128 bytes
constexpr int STAGES = 4;
constexpr int THREADS = 384;             // producer warpgroup + two consumers
constexpr int CLUSTER = BINMM_CLUSTER;   // slabs sharing each W2 tile
constexpr int NACC = BN / 2;             // int32 sums a consumer thread holds
constexpr int A_BYTES = BM * BK;         // 8 KB, one 128B-swizzled box
constexpr int BOX_BYTES = 64 * BK;       // 8 KB: 64 W2 rows (templates) x 128 B
constexpr int NBOX = BN / 64;            // W2 boxes a stage
constexpr int STAGE_BYTES = 2 * A_BYTES + NBOX * BOX_BYTES;
constexpr int OUT_BOX = 64 * 64 * 2;     // 8 KB: 64 rows x 64 bf16
constexpr int OUT_BYTES = BM * BN * 2;   // one warpgroup's staged output
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(2 * OUT_BYTES <= STAGES * STAGE_BYTES, "the staging tiles reuse the ring");

// wgmma shared-memory descriptors (in 16-byte units), 128-byte swizzle,
// both operands K-major: rows of 128 bytes, 8-row groups 1024 bytes
// apart (SBO); the next k32 slice starts 32 bytes on.
constexpr uint64_t SBO = 1024 >> 4;
constexpr uint32_t K32 = 32 >> 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (SBO << 32) | (1ull << 62);
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

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

#if BINMM_CLUSTER > 1
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "h"(mask)
      : "memory");
}

// arrive on the mbarrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
#endif

// named barriers: 1 + part for one consumer warpgroup, 3 for both
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// ---- int8 wgmma, m64nNk32 s8 x s8 -> s32 (generated operand lists) ----

__device__ __forceinline__ void wgmma_n256_ss(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

#ifdef BINMM_REG_A
__device__ __forceinline__ void wgmma_n256_rs(int (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#endif

__device__ __forceinline__ void wgmma_n128_ss(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x BN, s32) += A (64 x 32, K-major, shared) . B (32 x BN, K-major)
#if BINMM_BN == 256
#define wgmma_ss wgmma_n256_ss
#else
#define wgmma_ss wgmma_n128_ss
#endif

// One stage's four k32 wgmmas of a warpgroup, A from shared memory.
__device__ __forceinline__ void stage_mma(int (&d)[NACC], uint32_t a, uint32_t b) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) wgmma_ss(d, da + kk * K32, db + kk * K32);
}

#ifdef BINMM_REG_A
// ... A from registers, negated: the 128-byte swizzled A tile read as
// wgmma's register fragment (per warp 16 rows; a thread holds rows
// lane/4 and +8, bytes 4 (lane%4) and +16 of each 32-byte k slice).
__device__ __forceinline__ void stage_mma_neg_a(int (&d)[NACC], uint32_t a, uint32_t b,
                                                int warp, int lane) {
  const uint64_t db = desc(b);
  const int r0 = 16 * warp + (lane >> 2), off = 4 * (lane & 3);
  // 4 bytes of row r, 16-byte chunk c, negated (exact in +-127)
  auto neg4 = [&](int r, int c) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n"
                 : "=r"(v) : "r"(a + r * 128 + ((c ^ (r & 7)) << 4) + off));
    return __vsub4(0u, v);
  };
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    const uint32_t f[4] = {neg4(r0, 2 * kk), neg4(r0 + 8, 2 * kk), neg4(r0, 2 * kk + 1),
                           neg4(r0 + 8, 2 * kk + 1)};
    wgmma_n256_rs(d, f, db + kk * K32);
  }
}
#endif

__global__ void __launch_bounds__(THREADS, 1)
#if BINMM_CLUSTER > 1
__cluster_dims__(CLUSTER, 1, 1)
#endif
binmm_int8_kernel(const __grid_constant__ CUtensorMap map_xr,
                  const __grid_constant__ CUtensorMap map_xi,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_out,
                  const float* __restrict__ sc, int bins, int K, int nk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // 128B-swizzle atoms
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto xr_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto xi_s = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };
  auto w_s = [&](int s) { return base + s * STAGE_BYTES + 2 * A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int n_iter = 2 * nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      // every consumer thread arrives; in a cluster, lane 0 of each
      // consumer warp of each CTA (its loads fill all of them)
      mbar_init(empty(s), CLUSTER > 1 ? 8 * CLUSTER : 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#if BINMM_CLUSTER > 1
  cluster_sync();
  const uint32_t rank = cluster_rank();
#endif

  if (wg == 0) {
    // ---- producer: one thread issues every load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int half = it < nk ? 1 : 0;          // W2's second half (Wb) first
        const int k0 = (it - (1 - half) * nk) * BK;
        mbar_wait(empty(s), ph ^ 1);
#ifdef BINMM_NO_W
        mbar_expect_tx(full(s), 2 * A_BYTES);
#else
        mbar_expect_tx(full(s), STAGE_BYTES);
#endif
        tma_load_3d(xr_s(s), &map_xr, full(s), k0, r0, z);
        tma_load_3d(xi_s(s), &map_xi, full(s), k0, r0, z);
#ifndef BINMM_NO_W
#if BINMM_CLUSTER > 1
        // the boxes are dealt round the cluster; each lands in all of it
        for (int i = rank; i < NBOX; i += CLUSTER)
          tma_load_3d_multicast(w_s(s) + i * BOX_BYTES, &map_w, full(s), k0, n0 + 64 * i,
                                2 * z + half, (1u << CLUSTER) - 1);
#else
#pragma unroll
        for (int i = 0; i < NBOX; ++i)
          tma_load_3d(w_s(s) + i * BOX_BYTES, &map_w, full(s), k0, n0 + 64 * i, 2 * z + half);
#endif
#endif
      }
#if BINMM_CLUSTER > 1
      // the CTA stays until every consumer of the cluster has released
      // every stage: their arrivals land in this CTA's barriers
      for (int it = n_iter; it < n_iter + STAGES; ++it)
        mbar_wait(empty(it % STAGES), ((it / STAGES) & 1) ^ 1);
#endif
    }
  } else {
    // ---- consumers: WG1 -> Re (part 0), WG2 -> Im (part 1) -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int part = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    int acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    auto release = [&](int s) {
#if BINMM_CLUSTER > 1
      __syncwarp();
      if (lane == 0)
        for (uint32_t c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(empty(s), c);
#else
      mbar_arrive(empty(s));
#endif
    };
    int prev = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const bool first = it < nk;                  // the Wb half
      mbar_wait(full(s), (it / STAGES) & 1);
#ifndef BINMM_REG_A
      if (part == 1 && it == nk) {
        // the seam: Im's sums so far are Xr . Wb; negate them
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = -acc[i];
      }
#endif
      // Re: Xi . Wb, then Xr . Wa;  Im: Xr . Wb (negated), then Xi . Wa
      const uint32_t a = (part == 0) == first ? xi_s(s) : xr_s(s);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#ifdef BINMM_REG_A
      if (part == 1 && first)
        stage_mma_neg_a(acc, a, w_s(s), warp, lane);
      else
#endif
        stage_mma(acc, a, w_s(s));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (it > 0) release(prev);
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
#if BINMM_CLUSTER > 1
    release(prev);
#endif

    // ---- epilogue: scale, round, stage swizzled, TMA store -----------
    // accumulator layout (per warp, the m16n8 fragment): register 4g + e
    // holds row 16 warp + lane/4 + 8 (e/2), column 8g + 2 (lane%4) + e%2.
    // Both warpgroups are done with the ring before either overwrites it.
    named_sync(3, 256);
    const uint32_t stage_out = base + part * OUT_BYTES;
    const float* scz = sc + (size_t)z * K;
    const int tq = lane & 3;
    // the hi plane, then the lo plane through the same staging tile
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        const int col = n0 + 8 * g + 2 * tq;
        float2 s2 = make_float2(0.f, 0.f);
        if (col < K) s2 = *reinterpret_cast<const float2*>(scz + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + (lane >> 2) + 8 * h;
          const float v0 = __fmul_rn(__int2float_rn(acc[4 * g + 2 * h]), s2.x);
          const float v1 = __fmul_rn(__int2float_rn(acc[4 * g + 2 * h + 1]), s2.y);
          __nv_bfloat162 p2 = __floats2bfloat162_rn(v0, v1);
          if (plane) {
            const float2 hf = __bfloat1622float2(p2);
            p2 = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
          }
          // box g/8 holds columns [64 (g/8), +64); 16-byte chunk g%8 of
          // the row, swizzled by the row's low three bits
          const uint32_t addr = stage_out + (g >> 3) * OUT_BOX + row * 128 +
                                (((g & 7) ^ (row & 7)) << 4) + 4 * tq;
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(addr), "r"(*reinterpret_cast<uint32_t*>(&p2)) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + part, 128);
#ifndef BINMM_NO_STORE
      if ((threadIdx.x & 127) == 0) {
#pragma unroll
        for (int b = 0; b < NBOX; ++b)
          if (n0 + 64 * b < K) tma_store_3d(&map_out, stage_out + b * OUT_BOX, n0 + 64 * b, r0,
                                            (2 * plane + part) * bins + z);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
#endif
      if (plane == 0) named_sync(1 + part, 128);    // the staging tile is read out
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

// A 3-D map {d0 (contiguous), d1, d2} with byte strides {s1, s2}, a
// {128 bytes, 64, 1} box, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int es, const void* ptr, uint64_t d0,
              uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / es), 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xr, xi [bins, m, D] int8 with byte strides {row_stride, bin_stride}
// (multiples of 16), w2t the K-major spectra [bins, 2, K, Dp] int8 (Dp a
// multiple of 16, >= D), sc [bins, K] f32 -> out [2 (hi, lo), 2, bins, m,
// K] bf16.  K % 8 == 0, 16-byte aligned bases.
extern "C" int tsr_fft_binmm_int8(const void* xr, const void* xi, const void* w2t,
                                  const void* sc, void* out, long long row_stride,
                                  long long bin_stride, int bins, int m, int D, int Dp, int K,
                                  void* stream) {
  CUtensorMap map_xr, map_xi, map_w, map_out;
  const auto s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!make_map(&map_xr, s8, 1, xr, D, m, bins, row_stride, bin_stride) ||
      !make_map(&map_xi, s8, 1, xi, D, m, bins, row_stride, bin_stride) ||
      !make_map(&map_w, s8, 1, w2t, D, K, 2 * (uint64_t)bins, Dp, (uint64_t)K * Dp) ||
      !make_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, K, m,
                4 * (uint64_t)bins, 2 * (uint64_t)K, 2 * (uint64_t)K * m))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      binmm_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int slabs = (m + BM - 1) / BM;
  const dim3 grid((slabs + CLUSTER - 1) / CLUSTER * CLUSTER, (K + BN - 1) / BN, bins);
  binmm_int8_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_xr, map_xi, map_w, map_out, static_cast<const float*>(sc), bins, K, (D + BK - 1) / BK);
  return cudaGetLastError();
}
