// Per-pair LLR cost tiles for verify-the-winner DTW rescoring.
//
// Replaces template_speech_recognition_tpu/ops/dtw_pallas.py
//   pair_llr_pallas (_pair_llr_kernel; pallas_call at line 590).
//
//   out[n, i, j] = sum_d w[ids[n], i, d] * feats[rowstart[n] + j, d]
//
// with feats the flat [R, D] bool map (row r read as zero when r >= R)
// and w the [K, L, D] bf16 filter rows; fp32 accumulation.  The TPU
// kernel DMAs each pair's window from an 8-row-aligned start and the
// caller shifts columns afterwards (a Mosaic constraint); here every
// pair gathers its exact rows.
//
// One block of 4 warps per pair.  The [L, m] output is cut into
// 32 x 40 tiles (2 x 5 mma.sync m16n8k16 tiles); the four warps split
// the D contraction in 32-wide chunks (the last one zero-filled past D
// when D is not a multiple of 32) and add their partial tiles in
// shared memory.  Fragments are loaded straight from device memory: a
// contraction is a sum, so the k order inside a chunk may be permuted
// as long as A and B agree, and each lane takes 8 consecutive d of its
// filter row (one 16-byte load) and 8 consecutive bool bytes of its map
// row (one 8-byte load), which fill its A and B registers for two
// k16 steps.  The bools turn into bf16 (0 or 1.0, exact) in registers,
// so no bf16 copy of the map is made.
//
// What bounds it on the H100: bytes.  At the scan's shapes (984 pairs,
// m = 40, L = 32, D = 2048, peaks spread at random) the distinct map
// rows the windows cover (about 40 MB of bool), the distinct filters
// (about 83 MB of bf16) and the tiles (5 MB) take about 0.04 ms at
// 3.35 TB/s; the 5.2 GFLOP of bf16 take 0.005 ms.  This kernel loads
// each pair's window and filter once per pair (81 + 129 MB), in whole
// 32-byte sectors; overlapping windows and repeated ids hit in L2 at
// best.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int MT = 2, NT = 5;             // m16 x n8 tiles per output tile
constexpr int TM = 16 * MT, TN = 8 * NT;  // 32 template rows x 40 window rows
constexpr int KC = 32;                    // contraction chunk per warp step

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 bool bytes -> 4 bf16 (0 or 1.0 = 0x3F80) packed in two words
__device__ __forceinline__ uint2 bools_to_bf16(uint32_t w) {
  w = __vcmpne4(w, 0u) & 0x01010101u;
  const uint32_t lo = (w & 0xFFu) | ((w & 0xFF00u) << 8);
  const uint32_t hi = ((w >> 16) & 0xFFu) | ((w >> 8) & 0xFF0000u);
  return make_uint2(lo * 0x3F80u, hi * 0x3F80u);
}

__global__ void __launch_bounds__(WARPS * 32)
pair_llr_kernel(const uint8_t* __restrict__ feats, const bf16* __restrict__ w,
                const int* __restrict__ rowstart, const int* __restrict__ ids,
                float* __restrict__ out, long long R, int K, int L, int D, int m) {
  __shared__ float red[WARPS][TM][TN + 1];
  const int pair = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = rowstart[pair];
  const int kid = min(max(ids[pair], 0), K - 1);
  const bf16* wk = w + (size_t)kid * L * D;
  const int nchunks = (D + KC - 1) / KC;   // the last chunk zero-filled past D

  for (int i0 = 0; i0 < L; i0 += TM) {
    for (int j0 = 0; j0 < m; j0 += TN) {
      float acc[MT][NT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

#pragma unroll 2
      for (int ch = warp; ch < nchunks; ch += WARPS) {
        const int d = ch * KC + t * 8;
        // D % 8 == 0: a lane's 8 d lie wholly below D or wholly past
        // it, and past it both operands read as zero
        const bool d_in = d < D;
        // A: filter rows i0 + 16 mt + g (+8), d .. d+7
        uint4 a[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + 16 * mt + g + 8 * h;
            a[mt][h] = (i < L && d_in)
                           ? __ldg(reinterpret_cast<const uint4*>(wk + (size_t)i * D + d))
                           : make_uint4(0u, 0u, 0u, 0u);
          }
        // B: map rows row0 + j0 + 8 nt + g, d .. d+7, as bf16
        uint2 b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = j0 + 8 * nt + g;
          const long long r = row0 + j;
          uint2 raw = make_uint2(0u, 0u);
          if (d_in && j < m && r >= 0 && r < R)
            raw = __ldg(reinterpret_cast<const uint2*>(feats + (size_t)r * D + d));
          b[nt][0] = bools_to_bf16(raw.x);
          b[nt][1] = bools_to_bf16(raw.y);
        }
        // step 0 takes d + {0,1} (k slots 2t..) and d + {2,3} (slots
        // 2t+8..); step 1 takes d + {4,5} and d + {6,7}: the same
        // permutation for A and B
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y,
                     b[nt][0].x, b[nt][0].y);
            mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w,
                     b[nt][1].x, b[nt][1].y);
          }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = 16 * mt + g, cl = 8 * nt + 2 * t;
          red[warp][r][cl] = acc[mt][nt][0];
          red[warp][r][cl + 1] = acc[mt][nt][1];
          red[warp][r + 8][cl] = acc[mt][nt][2];
          red[warp][r + 8][cl + 1] = acc[mt][nt][3];
        }
      __syncthreads();
      for (int e = threadIdx.x; e < TM * TN; e += WARPS * 32) {
        const int r = e / TN, cl = e - r * TN;
        const int i = i0 + r, j = j0 + cl;
        if (i < L && j < m) {
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < WARPS; ++q) s += red[q][r][cl];
          out[((size_t)pair * L + i) * m + j] = s;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats [R, D] bool (uint8), w [K, L, D] bf16, rowstart [N] int32,
// ids [N] int32 -> out [N, L, m] f32.  D % 8 == 0 (D = 8 F' edge
// channels: 504 at log-mel n_mels 64), 16-byte aligned base pointers.
extern "C" int tsr_pair_llr(const void* feats, const void* w, const void* rowstart,
                            const void* ids, void* out, int R, int N, int K, int L,
                            int D, int m, void* stream) {
  pair_llr_kernel<<<N, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feats), static_cast<const bf16*>(w),
      static_cast<const int*>(rowstart), static_cast<const int*>(ids),
      static_cast<float*>(out), (long long)R, K, L, D, m);
  return cudaGetLastError();
}
