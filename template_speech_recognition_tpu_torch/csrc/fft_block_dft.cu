// Kernel 3 of the overlap-save FFT scorer: the block DFT, for Hopper:
// TMA loads of the windows into a shared-memory ring, the DFT basis
// resident in shared memory, wgmma, TMA stores; one producer warp and
// one or two consumer warpgroups.
//
// Replaces template_speech_recognition_tpu/ops/fft_dft_pallas.py
//   fft_block_dft_pallas (_kernel; pallas_call at line 104).
//
//   out[f, b, i, d] = sum_{tau < nfft} g[tau, f] . x[b, i*hop + tau, d]
//
// x [B, T, D] read as zero past its T rows; f < bins goes to xr, the
// rest to xi, both [bins, B, nblk, D] bf16; f32 sums.
//
// What bounds it on the H100: bytes.  At the scan's shape (B 8, T 3072,
// D 2048, nfft 159, hop 128, nblk 24) the map in once and the spectra
// out once (101 + 126 MB) take 0.068 ms at 3.35 TB/s; the 20 GFLOP take
// 0.02 ms on the bf16 tensor cores.  So the kernel reads x about once
// and keeps loads and stores in flight.
//
// Design.  Orientation M = d, N = basis columns, K = tau: a consumer
// warpgroup owns 64 d columns of one window and runs wgmma.m64nNk16.
// The basis comes from the wrapper transposed and padded, gt [2 BP, Kp]
// K-major (Kp = nfft rounded up to 16, BP = bins rounded up to 16, or
// to 32 when 2 BP > 256; the padding is exact zeros), and stays in
// shared memory for the whole block as ceil(Kp / 64) 128-byte-swizzled
// slabs of N rows.  N = 2 BP when that is at most 256 (xr's rows, then
// xi's), else the basis is split into two passes of N = BP, xr's and
// xi's, each a block of its own (so only half of the basis is resident).
//
// x comes by TMA through a 3-D map {D, T, B} in {64, Kb, 1} boxes (Kb
// = Kp, or Kp / 2 past 256 rows), MN-major A for wgmma: a window is the
// box at (d0, i*hop, b), and TMA's zero fill past T completes the tail
// windows of each utterance (a 2-D map over [B*T, D] would read the
// next utterance's first rows instead); rows nfft..Kp-1 of a window are
// real frames times zero basis columns.  A block walks a run of
// consecutive windows of one (b, 64 or 128 d) tile through a ring of
// whole-window stages, so the L - 1 rows two windows share come from
// L2; the run length is set by the wrapper so the blocks fill the card
// (one run a tile at D 2048 and B 8: 128 blocks; four at D 504).
//
// Epilogue: the warpgroup converts its 64 x N f32 tile to bf16 and
// writes it transposed ([f][64 d], 128-byte rows, 128-byte swizzle) into
// one of its two staging buffers with stmatrix.trans (eight 16-byte
// rows a matrix land in eight different bank groups), then one thread
// stores rows [0, BP) to xr and [BP, 2 BP) to xi by TMA through 3-D
// maps {D, B*nblk, bins} in {64, 1, BP} boxes: bins past `bins` and d
// past D are clipped.  The stores drain while the next window's wgmmas
// run; a buffer is rewritten after cp.async.bulk.wait_group.read 1.
// Every output is one block's sum in one fixed order: launches are
// bitwise repeatable.
//
// Probe switches (probe_fft_block_dft.py): -DDFT_NO_STORE (no TMA
// stores), -DDFT_NO_X (no x loads: the basis only).
//
// Shape contract (the wrapper's): D % 8 == 0, 16-byte aligned bases,
// Kp <= 512, BP <= 256, the plan's shared memory within 232,448 bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 4;
constexpr int ROW = 128;                   // bytes: 64 bf16 d columns, one swizzle row
constexpr int SMEM_LIMIT = 232448;

// wgmma descriptors (16-byte units), 128-byte swizzle, 8-row groups 1024
// bytes apart (SBO).  x, MN-major: the next k16 slice is 16 rows on.
// Basis, K-major: the next k16 slice is 32 bytes on inside a 64-k slab.
constexpr uint64_t SBO = 1024 >> 4;
constexpr uint32_t X_K16 = 16 * ROW;

struct Shape {
  int T, D, hop, nblk, bins;
  int kp, kb, bp, wgs, stages, run, n_dt, n_runs, passes;
};

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

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one consumer warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int part) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + part) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N, f32) (+)= A (64 x 16, x, MN-major) . B (16 x N, basis,
// K-major); `acc` 0 overwrites d.  The accumulators are operands 3 ..
// N/2 + 2, after the two descriptors and the flag.
#define WG_R0 "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18"
#define WG_R1 "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34"
#define WG_R2 "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50"
#define WG_R3 "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66"
#define WG_R4 "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82"
#define WG_R5 "%83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98"
#define WG_R6                                                                                    \
  "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114"
#define WG_R7                                                                                    \
  "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127, %128, %129, "  \
  "%130"
#define WG_D8(i)                                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]),  \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_ASM(NN, REGS, ...)                                                                    \
  asm volatile("{\n"                                                                             \
               ".reg .pred p;\n"                                                                 \
               "setp.ne.b32 p, %2, 0;\n"                                                         \
               "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 "                      \
               "{" REGS "}, %0, %1, p, 1, 1, 1, 0;\n"                                            \
               "}\n"                                                                             \
               : "+l"(da), "+l"(db), "+r"(acc), __VA_ARGS__)

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) {
    WG_ASM(32, WG_R0, WG_D16(0));
  } else if constexpr (N == 64) {
    WG_ASM(64, WG_R0 ", " WG_R1, WG_D16(0), WG_D16(16));
  } else if constexpr (N == 96) {
    WG_ASM(96, WG_R0 ", " WG_R1 ", " WG_R2, WG_D16(0), WG_D16(16), WG_D16(32));
  } else if constexpr (N == 128) {
    WG_ASM(128, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3, WG_D16(0), WG_D16(16), WG_D16(32),
           WG_D16(48));
  } else if constexpr (N == 160) {
    WG_ASM(160, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4, WG_D16(0), WG_D16(16),
           WG_D16(32), WG_D16(48), WG_D16(64));
  } else if constexpr (N == 192) {
    WG_ASM(192, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5, WG_D16(0),
           WG_D16(16), WG_D16(32), WG_D16(48), WG_D16(64), WG_D16(80));
  } else if constexpr (N == 224) {
    WG_ASM(224, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5 ", " WG_R6,
           WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48), WG_D16(64), WG_D16(80), WG_D16(96));
  } else {
    static_assert(N == 256, "N is a multiple of 32 up to 256");
    WG_ASM(256, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5 ", " WG_R6 ", " WG_R7,
           WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48), WG_D16(64), WG_D16(80), WG_D16(96),
           WG_D16(112));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__global__ void __launch_bounds__(384, 1)
block_dft_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_g,
                 const __grid_constant__ CUtensorMap map_r,
                 const __grid_constant__ CUtensorMap map_i, const Shape s) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int TILE_BYTES = N * ROW;           // N rows of 128 bytes
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // 128B-swizzle atoms
  const int n_slab = (s.kp + 63) / 64;
  const uint32_t g_s = base;
  const uint32_t x_base = g_s + n_slab * TILE_BYTES;
  const uint32_t stage_bytes = s.wgs * s.kp * ROW;
  const uint32_t outs = x_base + s.stages * stage_bytes;
  const uint32_t bars = outs + 2 * s.wgs * TILE_BYTES;
  auto x_s = [&](int st) { return x_base + st * stage_bytes; };
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (MAX_STAGES + st); };
  const uint32_t g_bar = bars + 16 * MAX_STAGES;

  // block -> (b, d tile, run, pass), the pass fastest so both passes of
  // a window read it from L2 together
  int w = blockIdx.x;
  const int pass = w % s.passes;
  w /= s.passes;
  const int ri = w % s.n_runs;
  w /= s.n_runs;
  const int dt = w % s.n_dt;
  const int b = w / s.n_dt;
  const int i0 = ri * s.run;
  const int i1 = min(s.nblk, i0 + s.run);
  const int d0 = dt * 64 * s.wgs;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < s.stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128 * s.wgs);
    }
    mbar_init(g_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(g_bar, n_slab * TILE_BYTES);
      for (int sl = 0; sl < n_slab; ++sl)
        tma_load_2d(g_s + sl * TILE_BYTES, &map_g, g_bar, 64 * sl, pass * N);
      int it = 0;
      for (int i = i0; i < i1; ++i, ++it) {
        const int st = it % s.stages;
        mbar_wait(empty(st), ((it / s.stages) & 1) ^ 1);
#ifdef DFT_NO_X
        mbar_arrive(full(st));
#else
        mbar_expect_tx(full(st), stage_bytes);
        for (int c = 0; c < s.wgs; ++c)
          for (int r = 0; r < s.kp; r += s.kb)
            tma_load_3d(x_s(st) + (c * s.kp + r) * ROW, &map_x, full(st), d0 + 64 * c,
                        i * s.hop + r, b);
#endif
      }
    }
  } else {
    // ---- consumers: warpgroup `part` owns d columns [dw, dw + 64) -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int part = wg - 1;
    const int dw = d0 + 64 * part;
    const bool leader = threadIdx.x % 128 == 0;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int nk = s.kp / 16;
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
    // stmatrix.trans: lane l gives the address of row l % 8 of matrix
    // l / 8, which holds basis column 8 (g + l / 16) + l % 8 (the
    // staging row) and d columns 16 warp + 8 ((l / 8) % 2) .. + 7 (one
    // 16-byte chunk of it, swizzled by the row's low three bits)
    const int m_row = 8 * (lane >> 4) + (lane & 7);
    const int m_chunk = 2 * warp + ((lane >> 3) & 1);
    mbar_wait(g_bar, 0);
    int it = 0;
    for (int i = i0; i < i1; ++i, ++it) {
      const int st = it % s.stages;
      mbar_wait(full(st), (it / s.stages) & 1);
      const uint32_t xa = x_s(st) + part * s.kp * ROW;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int k = 0; k < nk; ++k)
        wgmma<N>(acc, desc(xa + k * X_K16), desc(g_s + (k >> 2) * TILE_BYTES + (k & 3) * 32),
                 k);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      mbar_arrive(empty(st));

      // ---- epilogue: bf16, transposed into a staging buffer, TMA store --
      const uint32_t sb = outs + (2 * part + (it & 1)) * TILE_BYTES;
      // the stores that last read this buffer (two windows ago) are done
      if (leader) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      warpgroup_sync(part);
#pragma unroll
      for (int g = 0; g < N / 8; g += 2) {
        const int f = 8 * g + m_row;
        const uint32_t addr = sb + f * ROW + ((m_chunk ^ (f & 7)) << 4);
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
            :: "r"(addr), "r"(pack_bf16(acc[4 * g], acc[4 * g + 1])),
               "r"(pack_bf16(acc[4 * g + 2], acc[4 * g + 3])),
               "r"(pack_bf16(acc[4 * g + 4], acc[4 * g + 5])),
               "r"(pack_bf16(acc[4 * g + 6], acc[4 * g + 7]))
            : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(part);
#ifndef DFT_NO_STORE
      if (leader && dw < s.D) {
        const int row = b * s.nblk + i;
        if (s.passes == 1) {
          tma_store_3d(&map_r, sb, dw, row, 0);
          tma_store_3d(&map_i, sb + s.bp * ROW, dw, row, 0);
        } else {
          tma_store_3d(pass == 0 ? &map_r : &map_i, sb, dw, row, 0);
        }
      }
#endif
      if (leader) asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A bf16 map of `rank` dims {d[0] (contiguous), ...}, the given box,
// 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* d,
              const uint32_t* box) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[3], strides[2];
  cuuint32_t boxes[3], estr[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    dims[i] = d[i];
    boxes[i] = box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             boxes, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int N>
int launch(const void* x, const void* gt, void* xr, void* xi, int B, Shape s, void* stream) {
  const int n_slab = (s.kp + 63) / 64;
  const int smem = 1024 + n_slab * N * ROW + s.stages * s.wgs * s.kp * ROW +
                   2 * s.wgs * N * ROW + 8 * (2 * MAX_STAGES + 1);
  if (smem > SMEM_LIMIT || s.stages < 1 || s.stages > MAX_STAGES || s.kp % s.kb ||
      s.kb > 256 || s.bp > 256 || (s.wgs != 1 && s.wgs != 2))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mg, mr, mi;
  const uint64_t dx[3] = {(uint64_t)s.D, (uint64_t)s.T, (uint64_t)B};
  const uint64_t dg[2] = {(uint64_t)s.kp, (uint64_t)(2 * s.bp)};
  const uint64_t dout[3] = {(uint64_t)s.D, (uint64_t)B * s.nblk, (uint64_t)s.bins};
  const uint32_t bx[3] = {64, (uint32_t)s.kb, 1}, bg[2] = {64, (uint32_t)N},
                 bo[3] = {64, 1, (uint32_t)s.bp};
  if (!make_map(&mx, x, 3, dx, bx) || !make_map(&mg, gt, 2, dg, bg) ||
      !make_map(&mr, xr, 3, dout, bo) || !make_map(&mi, xi, 3, dout, bo))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(block_dft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  block_dft_kernel<N><<<B * s.n_dt * s.n_runs * s.passes, 128 * (1 + s.wgs), smem,
                        static_cast<cudaStream_t>(stream)>>>(mx, mg, mr, mi, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, T, D] bf16, gt [2 bp, kp] bf16 (the basis transposed, rows past
// bins of each half and columns past nfft zero) -> xr, xi [bins, B,
// nblk, D] bf16.  The plan (kb, bp, n, passes, wgs, stages, run) is the
// wrapper's (ops/fft_dft_kernel.py, `plan`).
extern "C" int tsr_fft_block_dft(const void* x, const void* gt, void* xr, void* xi, int B, int T,
                                 int D, int hop, int nblk, int bins, int kp, int kb, int bp,
                                 int n, int passes, int wgs, int stages, int run,
                                 void* stream) {
  Shape s{T, D, hop, nblk, bins, kp, kb, bp, wgs, stages, run,
          (D + 64 * wgs - 1) / (64 * wgs), (nblk + run - 1) / run, passes};
  switch (n) {
    case 32: return launch<32>(x, gt, xr, xi, B, s, stream);
    case 64: return launch<64>(x, gt, xr, xi, B, s, stream);
    case 96: return launch<96>(x, gt, xr, xi, B, s, stream);
    case 128: return launch<128>(x, gt, xr, xi, B, s, stream);
    case 160: return launch<160>(x, gt, xr, xi, B, s, stream);
    case 192: return launch<192>(x, gt, xr, xi, B, s, stream);
    case 224: return launch<224>(x, gt, xr, xi, B, s, stream);
    case 256: return launch<256>(x, gt, xr, xi, B, s, stream);
    default: return cudaErrorInvalidValue;
  }
}
