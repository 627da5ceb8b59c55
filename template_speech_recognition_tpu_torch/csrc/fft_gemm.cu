// Kernel 3 of the overlap-save FFT scorer, the block DFT, on a tiled
// mma.sync GEMM routine.
//
//   3. fft_block_dft  replaces ops/fft_dft_pallas.py   fft_block_dft_pallas
//   (path under template_speech_recognition_tpu/)
//
// (Kernel 4, the per-bin bank matmul, and kernel 5, the inverse-DFT
// epilogue, run on TMA + wgmma pipelines of their own in fft_binmm.cu
// and fft_idft.cu.)
//
// A batched GEMM  C[z] (M x N) = A[z] (M x K) . B[z] (K x N) with bf16
// operands and fp32 accumulation.  gemm_kernel is written over an Ops
// policy that supplies how the operands are gathered and the results
// scattered:
//
//   load_a(z, m, k0) -> 8 bf16 of A[z][m][k0 .. k0+7]  (zeros outside)
//   load_b(z, k, n0) -> 8 bf16 of B[z][k][n0 .. n0+7]  (zeros outside)
//   store(z, m, n, c0, c1)  C[z][m][n], C[z][m][n+1]
//
// Tiling: a 128 x 128 output tile per block of 8 warps (2 x 4, 64 x 32
// per warp), BK = 32, two shared-memory stages with the next tile's
// global loads in flight in registers while the current one feeds
// mma.sync m16n8k16 (fragments through ldmatrix).  Shared rows are
// padded by 8 bf16 so the ldmatrix phases hit distinct banks.  Grid
// x = M tiles (fastest), so the blocks that share one B tile run
// together and B streams from device memory once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;    // bf16 per shared row of A (k contiguous)
constexpr int B_LD = BN + 8;    // bf16 per shared row of B (n contiguous)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint4 pack8(const bf16 (&v)[8]) {
  uint4 r;
  r.x = (uint32_t)__bfloat16_as_ushort(v[0]) | ((uint32_t)__bfloat16_as_ushort(v[1]) << 16);
  r.y = (uint32_t)__bfloat16_as_ushort(v[2]) | ((uint32_t)__bfloat16_as_ushort(v[3]) << 16);
  r.z = (uint32_t)__bfloat16_as_ushort(v[4]) | ((uint32_t)__bfloat16_as_ushort(v[5]) << 16);
  r.w = (uint32_t)__bfloat16_as_ushort(v[6]) | ((uint32_t)__bfloat16_as_ushort(v[7]) << 16);
  return r;
}

template <class Ops>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Ops ops, int M, int N, int K) {
  __shared__ __align__(16) bf16 As[2][BM][A_LD];
  __shared__ __align__(16) bf16 Bs[2][BK][B_LD];
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // per thread: 2 chunks of 8 bf16 of A (row tid/4 + 64c, k (tid%4)*8)
  // and 2 of B (k row tid/16 + 16c, n (tid%16)*8)
  uint4 ra[2], rb[2];
  auto gload = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ar = (tid >> 2) + 64 * c, ak = (tid & 3) * 8;
      ra[c] = ops.load_a(z, m0 + ar, k0 + ak, M, K);
      const int bk = (tid >> 4) + 16 * c, bn = (tid & 15) * 8;
      rb[c] = ops.load_b(z, k0 + bk, n0 + bn, K, N);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ar = (tid >> 2) + 64 * c, ak = (tid & 3) * 8;
      *reinterpret_cast<uint4*>(&As[buf][ar][ak]) = ra[c];
      const int bk = (tid >> 4) + 16 * c, bn = (tid & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[buf][bk][bn]) = rb[c];
    }
  };

  const int nk = (K + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], &As[buf][wm + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bq[nj], &Bs[buf][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                     [wn + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], af[mi], bq[nj][0], bq[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[nj][2], bq[nj][3]);
        }
    }
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + (lane >> 2);
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      if (row < M) ops.store(z, row, col, acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M) ops.store(z, row + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---- 3. overlap-save block DFT -------------------------------------
// z = b * nblk + i;  A[f][tau] = g[tau][f] (g: [nfft, 2*bins]);
// B[tau][d] = x[b, i*hop + tau, d], zero past T (the tail windows are
// completed here, nothing is padded in device memory);
// C[f][d] -> (f < bins ? xr : xi)[f mod bins, b, i, d] in bf16.
struct DftOps {
  const bf16* x; const bf16* g; bf16* xr; bf16* xi;
  int B, T, D, hop, nblk, bins;
  __device__ uint4 load_a(int, int m, int k0, int M, int K) const {
    bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      v[j] = (m < M && k < K) ? g[(size_t)k * M + m] : __float2bfloat16_rn(0.f);
    }
    return pack8(v);
  }
  __device__ uint4 load_b(int z, int k, int n0, int K, int N) const {
    const int b = z / nblk, i = z - b * nblk;
    const int row = i * hop + k;
    if (k >= K || row >= T || n0 >= N) return zero4();
    return *reinterpret_cast<const uint4*>(x + ((size_t)b * T + row) * D + n0);
  }
  __device__ void store(int z, int m, int n, float c0, float c1) const {
    const int b = z / nblk, i = z - b * nblk;
    bf16* dst = m < bins ? xr : xi;
    const int f = m < bins ? m : m - bins;
    *reinterpret_cast<__nv_bfloat162*>(dst + (((size_t)f * B + b) * nblk + i) * D + n) =
        __floats2bfloat162_rn(c0, c1);
  }
};

template <class Ops>
int launch(const Ops& ops, int M, int N, int K, int batch, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
  gemm_kernel<Ops><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(ops, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, T, D], g [nfft, 2*bins] -> xr, xi [bins, B, nblk, D]; all bf16.
// D % 8 == 0.
extern "C" int tsr_fft_block_dft(const void* x, const void* g, void* xr, void* xi,
                                 int B, int T, int D, int nfft, int hop, int nblk,
                                 int bins, void* stream) {
  DftOps ops{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
             static_cast<bf16*>(xr), static_cast<bf16*>(xi), B, T, D, hop, nblk, bins};
  return launch(ops, 2 * bins, D, nfft, B * nblk, stream);
}
