// Per-pair LLR cost tiles for verify-the-winner DTW rescoring.
//
// Replaces template_speech_recognition_tpu/ops/dtw_pallas.py
//   pair_llr_pallas (_pair_llr_kernel; pallas_call at line 590).
//
//   out[n, i, j] = sum_d w[ids[n], i, d] * feats[rowstart[n] + j, d]
//
// with feats the flat [R, D] bool map (row r read as zero when r < 0 or
// r >= R), w the [K, L, D] bf16 filter rows, ids clamped to [0, K-1];
// fp32 accumulation.  The TPU kernel DMAs each pair's window from an
// 8-row-aligned start and the caller shifts columns afterwards (a Mosaic
// constraint); here every pair gathers its exact rows.
//
// What bounds it on the H100: bytes.  At the scan's shapes (984 pairs,
// m = 40, L = 32, D = 2048, peaks spread at random) the distinct map
// rows the windows cover (about 40 MB of bool), the distinct filters
// (about 83 MB of bf16: ~630 of the 1024 templates) and the tiles (5 MB)
// take about 0.04 ms at 3.35 TB/s; the 5.2 GFLOP of bf16 take 0.005 ms.
// The kernel reads a filter and a window for every pair (210 MB).
// Reading each template's filter once (a sort launch grouping the pairs
// by id) cost more warps than it saved bytes, in every form measured,
// and no order of the pairs moved the time (PERF.md, probe_pair_llr.py).
//
// One block of 4 warps a pair walks D in stages of 128.  cp.async copies
// each stage's filter rows [32, 128] and window rows [40, 128] into a
// ring of 3 slots in shared memory (zero fill past D and outside the
// map), two stages in flight while one is multiplied, so the bytes in
// flight hold no registers; 40 KB of ring a block.  Stage rows are not
// padded: their 16-byte units are swizzled so that the fragment loads
// meet no bank conflict.
//
// The [L, m] output of a pair is cut into 32 x 40 tiles (2 x 5 mma.sync
// m16n8k16 tiles); the four warps split a stage in 32-wide chunks (D
// need only be a multiple of 8: the last stage is zero-filled) and add
// their partial tiles in shared memory in a fixed order.  A lane takes 8
// consecutive d of a filter row (one 16-byte load) and 8 consecutive
// bool bytes of a map row (one 8-byte load), which fill its A and B
// registers for two k16 steps (a contraction is a sum, so the k order
// inside a chunk may be permuted as long as A and B agree); the bools
// turn into bf16 (0 or 1.0, exact) in registers, so no bf16 copy of the
// map is made.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// the two k16 steps of one 32-wide chunk: step 0 takes d + {0,1} (k
// slots 2t..) and d + {2,3} (slots 2t+8..); step 1 takes d + {4,5} and
// d + {6,7}: the same permutation for A and B
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][NT][4], const uint4 (&a)[2][2],
                                          const uint2 (&b)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_bf16(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y, b[nt][0].x,
               b[nt][0].y);
      mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, b[nt][1].x,
               b[nt][1].y);
    }
}

constexpr int WARPS = 4;
constexpr int MT = 2, NT = 5;             // m16 x n8 tiles per output tile
constexpr int TM = 16 * MT, TN = 8 * NT;  // 32 template rows x 40 window rows

constexpr int KS = 128;                   // d a stage: one 32-wide chunk a warp
constexpr int FB = 2 * KS, XB = KS;       // bytes of a filter row, a window row in a stage
constexpr int STAGE = TM * FB + TN * XB;  // 13,312 bytes
constexpr int RED = WARPS * TM * (TN + 1) * 4;   // the partial tiles, over the ring

// stage rows are not padded; their 16-byte units are swizzled instead, so
// that the fragment loads meet no bank conflict: a filter row's 64-byte
// halves swap in odd rows (a quarter warp reads rows g and g + 1 at the
// same d), a window row's 32-byte quarters by row & 3 (a half warp reads
// rows g .. g + 3)
__device__ __forceinline__ int filt_at(int row, int byte) {
  return row * FB + (byte ^ ((row & 1) << 6));
}
__device__ __forceinline__ int win_at(int row, int byte) {
  return row * XB + (byte ^ ((row & 3) << 5));
}

constexpr int RING = 3;                   // stages in the ring: two in flight
constexpr int MIN_BLOCKS = 4;             // blocks an SM (40 KB of ring and 4 x 128 threads each)
constexpr int SMEM_BYTES = RING * STAGE > RED ? RING * STAGE : RED;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp8(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage st (d from st * KS) of the filter rows i0 .. i0 + TM and the
// window rows j0 .. j0 + TN into one ring slot; zero past D (both) and
// outside the map (the window); rows past L or m are left as they are
// (they reach only output rows and columns that are not written)
__device__ __forceinline__ void issue_stage(uint8_t* slot, const uint8_t* __restrict__ feats,
                                            const uint8_t* __restrict__ wb, long long row0,
                                            long long R, int L, int D, int m, int i0, int j0,
                                            int st) {
  const int d0 = st * KS;
  for (int u = threadIdx.x; u < TM * (FB / 16); u += WARPS * 32) {
    const int i = u / (FB / 16), c = u % (FB / 16), d = d0 + 8 * c;
    if (i0 + i < L) {
      const bool in = d < D;
      cp16(slot + filt_at(i, 16 * c), in ? wb + ((size_t)(i0 + i) * D + d) * 2 : wb,
           in ? 16 : 0);
    }
  }
  uint8_t* xs = slot + TM * FB;
  if ((D & 15) == 0) {
    for (int u = threadIdx.x; u < TN * (XB / 16); u += WARPS * 32) {
      const int j = u / (XB / 16), c = u % (XB / 16), d = d0 + 16 * c;
      const long long r = row0 + j0 + j;
      if (j0 + j < m) {
        const bool in = d < D && r >= 0 && r < R;
        cp16(xs + win_at(j, 16 * c), in ? feats + r * D + d : feats, in ? 16 : 0);
      }
    }
  } else {                                // D % 8 == 0: rows 8-byte aligned
    for (int u = threadIdx.x; u < TN * (XB / 8); u += WARPS * 32) {
      const int j = u / (XB / 8), c = u % (XB / 8), d = d0 + 8 * c;
      const long long r = row0 + j0 + j;
      if (j0 + j < m) {
        const bool in = d < D && r >= 0 && r < R;
        cp8(xs + win_at(j, 8 * c), in ? feats + r * D + d : feats, in ? 8 : 0);
      }
    }
  }
}

// block b takes pair b
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
pair_llr_kernel(const uint8_t* __restrict__ feats, const bf16* __restrict__ w,
                const int* __restrict__ rowstart, const int* __restrict__ ids,
                float* __restrict__ out, long long R, int K, int L, int D, int m) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int pair = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = rowstart[pair];
  const int kid = min(max(ids[pair], 0), K - 1);
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w + (size_t)kid * L * D);
  const int nst = (D + KS - 1) / KS;
  const int dl = 32 * warp + 8 * t;       // this lane's 8 d of a stage

  for (int i0 = 0; i0 < L; i0 += TM) {
    for (int j0 = 0; j0 < m; j0 += TN) {
      float acc[MT][NT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
#pragma unroll
      for (int s = 0; s < RING - 1; ++s) {
        if (s < nst) issue_stage(ring + s * STAGE, feats, wb, row0, R, L, D, m, i0, j0, s);
        cp_commit();
      }
      for (int st = 0; st < nst; ++st) {
        if (st + RING - 1 < nst)
          issue_stage(ring + ((st + RING - 1) % RING) * STAGE, feats, wb, row0, R, L, D, m, i0,
                      j0, st + RING - 1);
        cp_commit();
        cp_wait<RING - 1>();              // stage st has landed
        __syncthreads();
        const uint8_t* slot = ring + (st % RING) * STAGE;
        uint4 a[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *reinterpret_cast<const uint4*>(slot + filt_at(16 * mt + g + 8 * h, 2 * dl));
        uint2 b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 raw =
              *reinterpret_cast<const uint2*>(slot + TM * FB + win_at(8 * nt + g, dl));
          b[nt][0] = bools_to_bf16(raw.x);
          b[nt][1] = bools_to_bf16(raw.y);
        }
        mma_chunk<NT>(acc, a, b);
        __syncthreads();                  // every warp is past the slot
      }
      cp_wait<0>();
      // the warps' partial tiles, added in a fixed order
      float* red = reinterpret_cast<float*>(ring);
      float* rw = red + warp * TM * (TN + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = 16 * mt + g, cl = 8 * nt + 2 * t;
          rw[r * (TN + 1) + cl] = acc[mt][nt][0];
          rw[r * (TN + 1) + cl + 1] = acc[mt][nt][1];
          rw[(r + 8) * (TN + 1) + cl] = acc[mt][nt][2];
          rw[(r + 8) * (TN + 1) + cl + 1] = acc[mt][nt][3];
        }
      __syncthreads();
      for (int e = threadIdx.x; e < TM * TN; e += WARPS * 32) {
        const int r = e / TN, cl = e - r * TN;
        const int i = i0 + r, j = j0 + cl;
        if (i < L && j < m) {
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < WARPS; ++q) s += red[(q * TM + r) * (TN + 1) + cl];
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

// feats [R, D] bool (uint8), w [K, L, D] bf16, rowstart [N] int32, ids
// [N] int32 -> out [N, L, m] f32; block b takes pair b.  D % 8 == 0 (D =
// 8 F' edge channels: 504 at log-mel n_mels 64), 16-byte aligned bases.
extern "C" int tsr_pair_llr(const void* feats, const void* w, const void* rowstart,
                            const void* ids, void* out, int R, int N, int K, int L, int D,
                            int m, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_llr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  pair_llr_kernel<<<N, WARPS * 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feats), static_cast<const bf16*>(w),
      static_cast<const int*>(rowstart), static_cast<const int*>(ids), static_cast<float*>(out),
      (long long)R, K, L, D, m);
  return cudaGetLastError();
}
