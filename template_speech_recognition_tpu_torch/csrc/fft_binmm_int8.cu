// int8 per-bin bank matmul of the overlap-save FFT scorer.
//
// Replaces template_speech_recognition_tpu/ops/fft_binmm_pallas.py
//   fft_binmm_pallas in int8 mode: _kernel_q (line 81; pallas_call at
//   line 202).
//
// Per frequency bin z:  C = [Xr | Xi ; Xi | -Xr] (2m x 2D, int8)
//                         . W2[z] (2D x K, int8)
// accumulated in int32, which is exact (|x|, |w| <= 127), and flushed
// as bf16(f32(C[r][k]) * sc[z][k]) into out[r / m][z][r mod m][k].
//
// Tiling follows the bf16 bin matmul in fft_gemm.cu: a 128 x 128
// output tile per block of 8 warps (2 x 4, 64 x 32 each), BK = 64 int8,
// two shared stages with the next tile's global loads in flight in
// registers, mma.sync m16n8k32 s8 x s8 -> s32.  The packed A operand is
// built in its load (the -Xr block by a per-byte negation), never
// materialized; where D is not a multiple of 16 (log-mel D = 504) each
// 16-byte A chunk is two 8-byte loads, since a chunk may then straddle
// the Xr | Xi seam and rows are only 8-byte aligned.  W2 is [2D, K] with K contiguous, but the s8 B fragment
// wants 4 consecutive k per register: each thread loads 4 k-rows x 4
// templates (one 32-bit load per row, 32 contiguous bytes per 8 lanes)
// and transposes the 4 x 4 bytes with byte permutes before its 32-bit
// shared stores.  Grid x = M tiles (fastest), so the blocks that share
// one W2 tile run together and W2 streams from device memory once.
//
// What bounds it on the H100: bytes.  At the scan's shapes (bins = 80,
// m = 192, D = 2048, K = 1024) W2 (336 MB) + xr/xi (63 MB) + the bf16
// output (63 MB) take 0.138 ms at 3.35 TB/s; the 258 G int8 operations
// take 0.130 ms at 1979 TOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int LD = BK + 16;     // bytes per shared row (k contiguous), 20 words

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 packed A bytes at row r (< m of its half), packed column k (a
// multiple of 8): the -Xr block by a per-byte negation, exact in +-127.
// D % 8 == 0, so the 8 bytes lie in one half of the [Xr | Xi] row.
__device__ __forceinline__ uint2 load_a8(const int8_t* __restrict__ xr,
                                         const int8_t* __restrict__ xi, size_t row_off,
                                         bool lower, int k, int D) {
  const bool second = k >= D;
  const int8_t* src = lower ? (second ? xr : xi) : (second ? xi : xr);
  uint2 v = *reinterpret_cast<const uint2*>(src + row_off + (second ? k - D : k));
  if (lower && second) { v.x = __vsub4(0u, v.x); v.y = __vsub4(0u, v.y); }
  return v;
}

// V16: D % 16 == 0, so each thread's 16 A bytes are one 16-byte load;
// otherwise (D % 8 == 0: rows of 504 bytes at log-mel D = 504 are only
// 8-byte aligned) two 8-byte loads, each zero past 2D.
template <bool V16>
__global__ void __launch_bounds__(THREADS)
binmm_int8_kernel(const int8_t* __restrict__ xr, const int8_t* __restrict__ xi,
                  const int8_t* __restrict__ w2, const float* __restrict__ sc,
                  bf16* __restrict__ out, int bins, int mh, int D, int K) {
  __shared__ __align__(16) int8_t As[2][BM][LD];
  __shared__ __align__(16) int8_t Bs[2][BN][LD];   // B transposed: [n][k]
  const int z = blockIdx.z;
  const int M = 2 * mh, N = K, Kd = 2 * D;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // A: 2 chunks of 16 bytes per thread, row (tid/4) + 64c, k (tid%4)*16.
  // B: 2 groups of 4 k-rows x 4 templates per thread; group wg = 2 warp
  // + c covers k-quads 4 (wg/4) + lane/8 and template quads 8 (wg%4) +
  // lane%8.
  uint4 ra[2];
  uint32_t rb[2][4];
  auto gload = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = m0 + (tid >> 2) + 64 * c;
      const int k = k0 + (tid & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && k < Kd) {
        const bool lower = row >= mh;
        const size_t row_off = ((size_t)z * mh + (lower ? row - mh : row)) * D;
        if (V16) {
          const bool second = k >= D;
          const int8_t* src = lower ? (second ? xr : xi) : (second ? xi : xr);
          v = __ldg(reinterpret_cast<const uint4*>(src + row_off + (second ? k - D : k)));
          if (lower && second) {    // -Xr: per-byte negation, exact in +-127
            v.x = __vsub4(0u, v.x); v.y = __vsub4(0u, v.y);
            v.z = __vsub4(0u, v.z); v.w = __vsub4(0u, v.w);
          }
        } else {
          const uint2 lo = load_a8(xr, xi, row_off, lower, k, D);
          const uint2 hi = k + 8 < Kd ? load_a8(xr, xi, row_off, lower, k + 8, D)
                                      : make_uint2(0u, 0u);
          v = make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
      ra[c] = v;
      const int wg = 2 * warp + c;
      const int kq = 4 * (wg >> 2) + (lane >> 3), nq = 8 * (wg & 3) + (lane & 7);
      const int n = n0 + 4 * nq;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kr = k0 + 4 * kq + q;
        rb[c][q] = (kr < Kd && n < N)
            ? __ldg(reinterpret_cast<const uint32_t*>(w2 + ((size_t)z * Kd + kr) * N + n))
            : 0u;
      }
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 2) + 64 * c][(tid & 3) * 16]) = ra[c];
      const int wg = 2 * warp + c;
      const int kq = 4 * (wg >> 2) + (lane >> 3), nq = 8 * (wg & 3) + (lane & 7);
      // 4 x 4 byte transpose: column j = bytes j of rows 0..3
      const uint32_t lo01 = __byte_perm(rb[c][0], rb[c][1], 0x5140);
      const uint32_t hi01 = __byte_perm(rb[c][0], rb[c][1], 0x7362);
      const uint32_t lo23 = __byte_perm(rb[c][2], rb[c][3], 0x5140);
      const uint32_t hi23 = __byte_perm(rb[c][2], rb[c][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[buf][4 * nq + j][4 * kq]) = col[j];
    }
  };

  const int nk = (Kd + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bq[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = lds32(&As[buf][r][ks + 4 * t]);
        af[mi][1] = lds32(&As[buf][r + 8][ks + 4 * t]);
        af[mi][2] = lds32(&As[buf][r][ks + 16 + 4 * t]);
        af[mi][3] = lds32(&As[buf][r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int cn = wn + nj * 8 + g;
        bq[nj][0] = lds32(&Bs[buf][cn][ks + 4 * t]);
        bq[nj][1] = lds32(&Bs[buf][cn][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_s8(acc[mi][nj], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bq[nj][0],
                 bq[nj][1]);
    }
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + g;
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= N) continue;
      const float s0 = sc[(size_t)z * K + col], s1 = sc[(size_t)z * K + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + 8 * h;
        if (rr >= M) continue;
        const int part = rr >= mh ? 1 : 0;
        const int r = rr - part * mh;
        const float v0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), s0);
        const float v1 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), s1);
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)part * bins + z) * mh + r) * K +
                                           col) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xr, xi [bins, m, D] int8, w2 [bins, 2D, K] int8, sc [bins, K] f32
// -> out [2, bins, m, K] bf16.  D % 8 == 0, K % 4 == 0, 16-byte
// aligned base pointers.
extern "C" int tsr_fft_binmm_int8(const void* xr, const void* xi, const void* w2,
                                  const void* sc, void* out, int bins, int m, int D, int K,
                                  void* stream) {
  const dim3 grid((2 * m + BM - 1) / BM, (K + BN - 1) / BN, bins);
  auto kernel = D % 16 == 0 ? binmm_int8_kernel<true> : binmm_int8_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xr), static_cast<const int8_t*>(xi),
      static_cast<const int8_t*>(w2), static_cast<const float*>(sc), static_cast<bf16*>(out),
      bins, m, D, K);
  return cudaGetLastError();
}
