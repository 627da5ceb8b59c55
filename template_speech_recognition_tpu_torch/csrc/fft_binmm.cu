// Per-bin complex bank matmul of the overlap-save FFT scorer (bf16),
// for Hopper: TMA loads into a shared-memory ring, wgmma from shared
// memory, one producer warp and two consumer warpgroups.
//
// Replaces template_speech_recognition_tpu/ops/fft_binmm_pallas.py
//   fft_binmm_pallas, bf16 _kernel (lines 41-78; pallas_call at line 202).
//
// Per frequency bin f, with xr, xi [bins, m, D] and W2 [bins, 2D, K]:
//   out[0, f] = Xr . W2[f, :D] + Xi . W2[f, D:]     (Re of X . conj(W))
//   out[1, f] = Xi . W2[f, :D] - Xr . W2[f, D:]     (Im)
// accumulated in f32 and written [2, bins, m, K] in bf16.
//
// What bounds it on the H100: bf16 operations, just above the ridge.  At
// the scan's shapes (bins 80, m 192, D 2048, K 1024) the 258 GFLOP take
// 0.26 ms at 989 TFLOP/s; W2 (671 MB) with xr/xi and the output take
// 0.23 ms at 3.35 TB/s.  Only wgmma reaches the tensor cores' full rate,
// and it needs its operands in shared memory in the swizzled layouts that
// TMA writes.
//
// Design.  A block owns one 64-row slab of m, one BN = 256 wide tile of
// K and one bin.  Consumer warpgroup 0 accumulates Re, warpgroup 1 Im, a
// 64 x 256 f32 tile each (128 registers a thread; setmaxnreg moves
// registers from the producer to them).  Both read the same stages: each
// holds one Xr and one Xi tile (64 x BK) and one W2 tile (BK x 256).  The
// contraction runs as two loops of ceil(D / BK) steps, the first over
// W2's rows [0, D), the second over [D, 2D), so no k tile straddles the
// Xr | Xi seam (D = 504 at log-mel).  In the first half WG0 multiplies
// Xr and WG1 Xi; in the second WG0 multiplies Xi and WG1 Xr with
// wgmma's immediate scale-a = -1: the packed [Xr | Xi ; Xi | -Xr]
// operand is neither built nor sign-flipped, and each A byte feeds both
// halves of the output.
//
// W2 is read as it lies: K contiguous, an MN-major B operand (wgmma's
// transpose-B), 128-byte swizzled, each 64 x 256 tile four TMA boxes of
// 64 x 64.  Ragged edges come from TMA's zero fill: xr, xi are 3-D maps
// [bins, m, D] and W2 a 3-D map [2 bins, D, K], so rows past m, columns
// past D and K, and W2 rows past a half's D all read as zeros, never
// from the next bin or half.  The epilogue masks rows >= m (columns >= K
// too: K % 8 == 0, so a bf16 pair never straddles K).
//
// Ring: STAGES x 48 KB with a full and an empty mbarrier each.  The
// producer waits for "empty" (all 256 consumer threads arrive), sets the
// expected bytes and issues six TMA loads onto "full".  A consumer waits
// for "full", issues its four k16 wgmmas, and releases the previous stage
// once wgmma.wait_group 1 has retired its reads.  Grid: row slabs
// fastest, then K tiles, then bins, so the blocks that share a W2 tile
// run together and W2 streams from device memory about once.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;                  // rows of m per block (one wgmma M)
constexpr int BN = 256;                 // columns of K per block
constexpr int BK = 64;                  // contraction per stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;            // producer warpgroup + two consumers
constexpr int A_BYTES = BM * BK * 2;    // 8 KB, one 128B-swizzled box
constexpr int BOX_BYTES = BK * 64 * 2;  // 8 KB: 64 W2 rows x 64 columns
constexpr int B_BYTES = 4 * BOX_BYTES;  // 32 KB
constexpr int STAGE_BYTES = 2 * A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// wgmma shared-memory descriptors (in 16-byte units), 128-byte swizzle.
// A, K-major: rows of 128 bytes, 8-row groups 1024 bytes apart.  B,
// MN-major: each box is 64 k-rows of 128 bytes (64 columns), 8-row k
// groups 1024 bytes apart (SBO), boxes of 64 columns 8 KB apart (LBO).
constexpr uint64_t A_SBO = 1024 >> 4;
constexpr uint64_t B_SBO = 1024 >> 4;
constexpr uint64_t B_LBO = BOX_BYTES >> 4;
constexpr uint32_t A_K16 = 32 >> 4;        // next k16 slice of A: 32 bytes
constexpr uint32_t B_K16 = (16 * 128) >> 4;  // of B: 16 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint64_t lbo, uint64_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
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

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 256, f32) += SA * A (64 x 16, K-major) . B (16 x 256, MN-major)
template <int SA>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, %131, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void stage_mma(float (&d)[128], uint32_t a, uint32_t b) {
  const uint64_t da = desc(a, 1, A_SBO), db = desc(b, B_LBO, B_SBO);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_256<SA>(d, da + kk * A_K16, db + kk * B_K16);
}

__global__ void __launch_bounds__(THREADS, 1)
binmm_kernel(const __grid_constant__ CUtensorMap map_xr,
             const __grid_constant__ CUtensorMap map_xi,
             const __grid_constant__ CUtensorMap map_w2,
             bf16* __restrict__ out, int bins, int m, int K, int nk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // 128B-swizzle atoms
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto xr_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto xi_s = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };
  auto w_s = [&](int s) { return base + s * STAGE_BYTES + 2 * A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN, f = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int n_iter = 2 * nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int half = it >= nk, k0 = (it - half * nk) * BK;
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES);
        tma_load_3d(xr_s(s), &map_xr, full(s), k0, r0, f);
        tma_load_3d(xi_s(s), &map_xi, full(s), k0, r0, f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tma_load_3d(w_s(s) + i * BOX_BYTES, &map_w2, full(s), n0 + 64 * i, k0, 2 * f + half);
      }
    }
  } else {
    // ---- consumers: WG1 -> Re (part 0), WG2 -> Im (part 1) -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int part = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const bool second = it >= nk;
      mbar_wait(full(s), (it / STAGES) & 1);
      // Re: Xr then Xi;  Im: Xi then -Xr
      const uint32_t a = (part == 0) != second ? xr_s(s) : xi_s(s);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (part == 1 && second)
        stage_mma<-1>(acc, a, w_s(s));
      else
        stage_mma<1>(acc, a, w_s(s));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (it > 0) mbar_arrive(empty(prev));
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // accumulator layout (per warp, as mma.sync m16n8): register 4g + e
    // holds row 16 warp + lane/4 + 8 (e/2), column 8g + 2 (lane%4) + e%2
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int row = r0 + 16 * warp + (lane >> 2);
    bf16* dst = out + ((size_t)part * bins + f) * (size_t)m * K;
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int col = n0 + 8 * g + 2 * (lane & 3);
      if (col >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < m)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * K + col) =
              __floats2bfloat162_rn(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
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

// A 3-D bf16 map {d0 (contiguous), d1, d2} with a 64 x 64 x 1 box,
// 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xr, xi [bins, m, D], w2 [bins, 2D, K] -> out [2, bins, m, K]; all bf16.
// D % 8 == 0, K % 8 == 0 (16-byte row strides), 16-byte aligned bases.
extern "C" int tsr_fft_binmm(const void* xr, const void* xi, const void* w2, void* out,
                             int bins, int m, int D, int K, void* stream) {
  CUtensorMap map_xr, map_xi, map_w2;
  if (!make_map(&map_xr, xr, D, m, bins) || !make_map(&map_xi, xi, D, m, bins) ||
      !make_map(&map_w2, w2, K, D, 2 * (uint64_t)bins))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      binmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM, (K + BN - 1) / BN, bins);
  binmm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_xr, map_xi, map_w2, static_cast<bf16*>(out), bins, m, K, (D + BK - 1) / BK);
  return cudaGetLastError();
}
