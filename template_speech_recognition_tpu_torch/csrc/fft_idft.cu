// Kernel 5 of the overlap-save FFT scorer: the inverse-DFT epilogue,
// for Hopper: TMA loads into a shared-memory ring, wgmma from shared
// memory, TMA stores, one producer warp and two consumer warpgroups,
// persistent blocks.
//
// Replaces template_speech_recognition_tpu/ops/fft_idft_pallas.py
//   fft_idft_pallas (_kernel; pallas_call at line 94).
//
// out[b, i*hop + tau, k] = sum_r imat[r, tau] . ycat[r, j*K + k] + c[k],
// j = b*nblk + i: per block j one GEMM (hop x K) = imat^T (hop x 2 bins)
// . Y_j (2 bins x K), bf16 operands, f32 sums, written f32 time-major
// [B, nblk*hop, K], which is [m, hop, K] with m = B*nblk.
//
// What bounds it on the H100: bytes.  ycat in once and the scores out
// once (63 + 101 MB at bins 80, hop 128, m 192, K 1024) take 0.049 ms at
// 3.35 TB/s; the 8 GFLOP take 0.008 ms on the bf16 tensor cores.  So the
// kernel must keep loads and stores in flight and touch each byte once.
//
// Design.  A work item is one block j, 128 rows of hop (consumer
// warpgroup 0 the first 64, warpgroup 1 the next 64) and BN = 128
// templates; persistent blocks, one an SM, walk the items with the row
// tiles fastest, then the template tiles, then j, so blocks in flight
// read neighbouring columns of ycat and write neighbouring rows of out.
// Both operands come from TMA as they lie, MN-major (wgmma's transposed
// A and B) in 128-byte-swizzled boxes of 64 rows of 2 bins x 64
// columns: imat [2 bins, hop] (tau contiguous; 40 KB at hop 128, read
// from L2 by every item) and ycat as a 3-D map [2 bins, m, K], so
// templates past K and rows past 2 bins read as zeros, never as block
// j + 1's.  A stage holds BK = 64 rows of 2 bins: the two imat boxes
// (the warpgroups' rows) and the two ycat boxes (128 templates), 32 KB;
// four stages.  Each consumer warpgroup runs four m64n128k16 wgmmas a
// stage into 64 f32 registers a thread.
//
// Epilogue: the warpgroup adds c and writes its 64 x 128 tile into its
// own 32 KB staging buffer as four 64 x 32 boxes, 128-byte swizzled (two
// wavefronts a float2 store, no bank conflicts), then one thread stores
// them with TMA through a 3-D map over out viewed as [m, hop, K]: a box
// past hop or K is clipped at block j's end, not written into block
// j + 1's rows.  The stores drain while the next item's wgmmas run; the
// buffer is rewritten only after cp.async.bulk.wait_group.read.
//
// At the bench shape on an H100 80GB HBM3 at 700 W (chip_smoke.py) it
// takes 0.066 ms, 2.5 TB/s, 0.74 of the 3.35 TB/s peak: as fast as
// torch.mm with fp32 output on the same GEMM (0.065 ms).
//
// Shape contract (the wrapper's): K % 8 == 0 (16-byte rows of ycat and
// out), the imat row stride hop_a a multiple of 8 (the wrapper pads
// imat's columns with zeros past hop), 16-byte aligned bases.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                    // rows of hop an item (two warpgroups)
constexpr int BN = 128;                    // templates an item
constexpr int BK = 64;                     // rows of 2 bins a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;               // producer warpgroup + two consumers
constexpr int BOX_BYTES = 64 * BK * 2;     // BK rows of 128 bytes
constexpr int STAGE_BYTES = 4 * BOX_BYTES; // imat x 2, ycat x 2
constexpr int OUT_BOX = 64 * 32 * 4;       // 8 KB: 64 rows of 32 f32
constexpr int OUT_BYTES = 4 * OUT_BOX;     // a warpgroup's 64 x 128 f32 tile
constexpr int SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + 2 * OUT_BYTES + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");

// wgmma descriptors of an MN-major operand, 128-byte swizzle (in 16-byte
// units): 8-row k groups 1024 bytes apart (SBO), 64-column boxes 8 KB
// apart (LBO); the next k16 slice is 16 rows of 128 bytes further.
constexpr uint64_t SBO = 1024 >> 4;
constexpr uint64_t LBO = BOX_BYTES >> 4;
constexpr uint32_t K16 = (16 * 128) >> 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (LBO << 16) | (SBO << 32) | (1ull << 62);
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

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 16, MN-major) . B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
idft_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_y,
            const __grid_constant__ CUtensorMap map_o,
            const float* __restrict__ c, int hop, int m, int K, int two_bins) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // 128B-swizzle atoms
  const uint32_t outs = base + STAGES * STAGE_BYTES;
  const uint32_t bars = outs + 2 * OUT_BYTES;
  auto a_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto y_s = [&](int s) { return base + s * STAGE_BYTES + 2 * BOX_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int n_mt = (hop + BM - 1) / BM, n_nt = (K + BN - 1) / BN;
  const int n_items = m * n_nt * n_mt;
  const int nk = (two_bins + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

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
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int t0 = (w % n_mt) * BM, n0 = ((w / n_mt) % n_nt) * BN, j = w / (n_mt * n_nt);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load_2d(a_s(s), &map_a, full(s), t0, kt * BK);
          tma_load_2d(a_s(s) + BOX_BYTES, &map_a, full(s), t0 + 64, kt * BK);
          tma_load_3d(y_s(s), &map_y, full(s), n0, j, kt * BK);
          tma_load_3d(y_s(s) + BOX_BYTES, &map_y, full(s), n0 + 64, j, kt * BK);
        }
      }
    }
  } else {
    // ---- consumers: WG1 -> rows [t0, t0 + 64), WG2 -> the next 64 -----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int part = wg - 1;
    const bool leader = threadIdx.x % 128 == 0;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int tq = lane & 3;
    int it = 0;
    const uint32_t stage_out = outs + part * OUT_BYTES;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int t0 = (w % n_mt) * BM + 64 * part, n0 = ((w / n_mt) % n_nt) * BN;
      const int j = w / (n_mt * n_nt);
      // this thread's columns of c, loaded while the stages arrive
      float cv[32];
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const int col = n0 + 8 * g + 2 * tq;
        cv[2 * g] = col < K ? __ldg(c + col) : 0.f;
        cv[2 * g + 1] = col < K ? __ldg(c + col + 1) : 0.f;
      }
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        const uint64_t da = desc(a_s(s) + part * BOX_BYTES), db = desc(y_s(s));
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_128(acc, da + kk * K16, db + kk * K16);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        mbar_arrive(empty(s));
      }

      // ---- epilogue: + c, into the swizzled staging tile, TMA store ------
      // accumulator layout (per warp, as mma.sync m16n8): register 4g + e
      // holds row 16 warp + lane/4 + 8 (e/2), column 8g + 2 (lane%4) + e%2.
      // First, the stores that last read this staging tile are done
      // reading it.
      if (leader)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(part);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int g = i >> 2;
        const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        // box g/4 holds columns [32 (g/4), +32); 16-byte chunk 2 (g%4) +
        // tq/2 of the row, swizzled by the row's low three bits
        const int chunk = (2 * (g & 3) + (tq >> 1)) ^ (row & 7);
        const uint32_t addr =
            stage_out + (g >> 2) * OUT_BOX + row * 128 + chunk * 16 + (tq & 1) * 8;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                     :: "r"(addr), "f"(acc[i] + cv[2 * g]), "f"(acc[i + 1] + cv[2 * g + 1])
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(part);
      if (leader && t0 < hop) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (n0 + 32 * b < K) tma_store_3d(&map_o, stage_out + b * OUT_BOX, n0 + 32 * b, t0, j);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
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

// A map of `rank` dims {d[0] (contiguous), ...} with element size `es`,
// the given box, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int es, const void* ptr, int rank,
              const uint64_t* d, const uint32_t* box) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[3], strides[2];
  cuuint32_t boxes[3], estr[3] = {1, 1, 1};
  uint64_t stride = es;
  for (int i = 0; i < rank; ++i) {
    dims[i] = d[i];
    boxes[i] = box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, boxes, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ycat [2*bins, m*K] bf16, imat [2*bins, hop_a] bf16 (columns past hop
// zero), c [K] f32 -> out [m*hop, K] f32.  K % 8 == 0, hop_a % 8 == 0,
// hop <= hop_a, ycat and imat 16-byte aligned.
extern "C" int tsr_fft_idft(const void* ycat, const void* imat, const void* c, void* out,
                            int two_bins, int hop, int hop_a, int m, int K, void* stream) {
  CUtensorMap map_a, map_y, map_o;
  const uint64_t da[2] = {(uint64_t)hop_a, (uint64_t)two_bins};
  const uint64_t dy[3] = {(uint64_t)K, (uint64_t)m, (uint64_t)two_bins};
  const uint64_t dout[3] = {(uint64_t)K, (uint64_t)hop, (uint64_t)m};
  const uint32_t ba[2] = {64, BK}, by[3] = {64, 1, BK}, bo[3] = {32, 64, 1};
  if (!make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, imat, 2, da, ba) ||
      !make_map(&map_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ycat, 3, dy, by) ||
      !make_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, 3, dout, bo))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      idft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return cudaGetLastError();
  const int n_items = m * ((K + BN - 1) / BN) * ((hop + BM - 1) / BM);
  idft_kernel<<<n_items < sms ? n_items : sms, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(map_a, map_y, map_o,
                                                     static_cast<const float*>(c), hop, m, K,
                                                     two_bins);
  return cudaGetLastError();
}
