// Kernel 10: the direct sliding-window LLR correlation.
//
// Replaces template_speech_recognition_tpu/ops/correlation_pallas.py
//   correlation_scores_pallas (pallas_call at line 102).
//
//   out[b, k, t] = c[k] + sum_{tau < L} sum_{d < D} F[b, t + tau, d] * W[k, tau, d]
//
// for t < T'' = T - L + 1: bf16 operands, fp32 accumulation, fp32 out
// [B, K, T''].  The TPU kernel runs L shifted [bk, dc] x [dc, bt]
// products per tile over two adjacent feature tiles; here the whole
// correlation is one GEMM.  Window t of utterance b, F[b, t : t+L, :],
// is the contiguous run F_flat[(b*T + t)*D, + L*D) of the row-major map,
// so
//
//   out[b]^T [T'', K] = A [T'', L*D] . W_flat [K, L*D]^T
//
// with A a Hankel view of the map (row stride D) that is never
// materialized.  The rows of all B utterances stack into M = B*T''
// (each A row finds its utterance once, before the main loop); N = K;
// the contraction is L*D deep (65,536 at the bench shape).  Row t reads
// frames t .. t+L-1 <= T-1: nothing past the map is read, and the TPU
// kernel's clamped tail (starts >= T'') has no counterpart.
//
// Tiling: a 128 x 128 output tile per block of 8 warps (2 x 4, 64 x 32
// per warp), BK = 32, a 4-stage cp.async ring in dynamic shared memory.
// Both operands are k-contiguous in device memory (16-byte chunks of 8
// bf16: D % 8 == 0 keeps every chunk inside one frame and aligned) and
// in shared memory (rows padded by 8 bf16 so the ldmatrix phases hit
// distinct banks), so A and B fragments both come through ldmatrix
// without transpose into mma.sync m16n8k16.  Rows past M, templates past
// K and the contraction past L*D are zero-filled by cp.async (source
// size 0): nothing is padded in device memory.  The contraction is never
// split across blocks, so every output is one block's sum in one fixed
// order: the result is deterministic.  Grid x = M tiles (fastest): the
// blocks that share one 128-template W tile (16.8 MB at the bench shape)
// run together and read it from L2.
//
// What bounds it on the H100: bf16 operations.  At the bench shape
// (B = 8, T = 3000, K = 1024, L = 32, D = 2048) 3.19 TFLOP take 3.2 ms
// at 989 TFLOP/s; the least bytes (W 134 MB, the map 98 MB, the scores
// 97 MB) take 0.1 ms.  mma.sync reaches only part of the wgmma rate;
// wgmma + TMA is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;                            // bf16 per shared row
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;   // 81,920

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
correlation_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                   const float* __restrict__ c, float* __restrict__ out,
                   int T, int Tv, int D, int K, int LD, int M) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // each stage: this thread copies 8 bf16 at k (tid % 4) * 8 of A rows
  // and W rows tid / 4 and tid / 4 + 64
  const int lr = tid >> 2, lk = (tid & 3) * 8;
  const bf16* arow[2];
  const bf16* brow[2];
  bool aok[2], bok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + lr + 64 * r;
    aok[r] = m < M;
    const int b = aok[r] ? m / Tv : 0;
    const int t = aok[r] ? m - b * Tv : 0;
    arow[r] = feats + ((size_t)b * T + t) * D + lk;
    const int n = n0 + lr + 64 * r;
    bok[r] = n < K;
    brow[r] = w + (size_t)(bok[r] ? n : 0) * LD + lk;
  }
  auto load_stage = [&](int stage, int kt) {
    bf16* as = smem + stage * STAGE_ELEMS;
    bf16* bs = as + BM * LDS;
    const int k0 = kt * BK;
    const bool kok = k0 + lk < LD;
    const int koff = kok ? k0 : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cp_async16(as + (lr + 64 * r) * LDS + lk, arow[r] + koff, aok[r] && kok);
      cp_async16(bs + (lr + 64 * r) * LDS + lk, brow[r] + koff, bok[r] && kok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (LD + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed, and every warp is done with stage kt - 1,
    // which the prefetch below overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < nk) load_stage(pre % STAGES, pre);
    cp_async_commit();
    const bf16* as = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
      // B rows are templates (k contiguous): matrices (n 0-7, k 0-7),
      // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) give the
      // b0, b1 fragments of two n8 tiles
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bq[nj], bs + (wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                            + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], af[mi], bq[nj][0], bq[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[nj][2], bq[nj][3]);
        }
    }
  }
  cp_async_wait<0>();

  // out[b, k, t]: the 8 lanes that share a template write 8 consecutive
  // t, one 32-byte sector
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + (lane >> 2) + 8 * h;
        if (row >= M) continue;
        const int b = row / Tv, t = row - b * Tv;
        float* dst = out + (size_t)b * K * Tv + t;
        if (col < K) dst[(size_t)col * Tv] = acc[mi][ni][2 * h] + c[col];
        if (col + 1 < K) dst[(size_t)(col + 1) * Tv] = acc[mi][ni][2 * h + 1] + c[col + 1];
      }
    }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats [B, T, D] bf16, w [K, L, D] bf16, c [K] f32 -> out [B, K, T-L+1]
// f32.  D % 8 == 0, 1 <= L <= T, B*(T-L+1) and L*D below 2^31, bases
// 16-byte aligned.
extern "C" int tsr_correlation(const void* feats, const void* w, const void* c, void* out,
                               int B, int T, int D, int K, int L, void* stream) {
  const int Tv = T - L + 1;
  const int M = B * Tv;
  cudaError_t err = cudaFuncSetAttribute(
      correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (K + BN - 1) / BN);
  correlation_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(w),
      static_cast<const float*>(c), static_cast<float*>(out), T, Tv, D, K, L * D, M);
  return cudaGetLastError();
}
