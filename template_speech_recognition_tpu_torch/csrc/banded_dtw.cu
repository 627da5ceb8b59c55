// Banded DTW terminal costs, one warp per (segment, template) pair.
//
// Replaces template_speech_recognition_tpu/ops/dtw_pallas.py
//   _banded_dtw_packed (_kernel_packed; pallas_call at line 688), the
//   default for L <= 64, and banded_dtw_pallas's "full"/"band" layouts
//   (_kernel_full, _kernel_band; pallas_call at line 474) for L > 64.
// All three compute one recurrence; the TPU's three skew layouts only
// pack diagonals into 128-lane registers, so none is carried over.
//
//   D[i, j] = cost[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])
//   in band:  |j*lm1 - i*mm1| <= band*lm1,  lm1 = max(L-1, 1),
//             mm1 = max(seg_len-1, 1);  cells with j >= seg_len are out;
//   D[0, 0] = cost[0, 0];  out-of-band / unreachable cells = 3e38.
//   out[n] = D[L-1, seg_len-1]
//
// Evaluated along anti-diagonals k = i + j: a cell of diagonal k needs
// only diagonals k-1 and k-2.  Lane l owns template rows l, l+32, ...
// (R = ceil(L/32) registers, L <= 256); D[i-1, .] comes from the lane
// below through one __shfl_sync per register (lane 0 takes lane 31's
// previous register).  The pair's cost is staged 32 diagonals at a time
// into shared memory in skewed form, sk[kk][i] = cost[i, k0+kk-i]: for
// each row the 32 lanes read 32 consecutive columns (coalesced), and
// the DP then reads one diagonal as consecutive words.  A pair stops at
// its own terminal diagonal L-1 + seg_len-1.  One fp32 add and exact
// fminf per cell, so the terminals are bitwise those of the plain
// version (ops/dtw_kernel.py) on the same cost.
//
// What bounds it on the H100: neither bytes nor operations.  At the
// scan's shapes (984 pairs, L = 32, 40 cost columns) the in-band cost
// cells are about 1.6 MB of the 5 MB of tiles (0.0005 ms at 3.35 TB/s;
// the staging reads whole rows); the limit is the chain of L+seg_len-1
// dependent diagonals per pair (69 at seg_len 38), each a shuffle, a
// shared load and a few integer ops.  Four pairs per block keep several
// chains in flight on each SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float UNREACHABLE = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CK = 32;   // diagonals staged per chunk (one per lane)

template <int R, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
banded_dtw_kernel(const float* __restrict__ cost, const int* __restrict__ seg_lens,
                  float* __restrict__ out, int N, int L, int M, int band) {
  constexpr int LS = R * 32 + 1;            // padded skewed row: conflict-free
  __shared__ float smem[WARPS][CK * LS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;                       // whole warps only: no block syncs below
  float* sk = smem[warp];
  const float* c = cost + (size_t)n * L * M;
  const int mlen = seg_lens[n];
  const int lm1 = max(L - 1, 1), mm1 = max(mlen - 1, 1);
  const int bw = band * lm1;
  const int jlim = min(mlen, M);
  // the terminal cell's diagonal; a segment longer than the M cost
  // columns has no terminal cell (unreachable, as in the plain version)
  const int kmax = mlen > M ? -1 : L - 1 + mlen - 1;
  const int t_lane = (L - 1) & 31, t_reg = (L - 1) >> 5;

  float prev[R], prev2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) prev[r] = prev2[r] = UNREACHABLE;
  float term = UNREACHABLE;

  for (int k0 = 0; k0 <= kmax; k0 += CK) {
    __syncwarp();
    for (int i = 0; i < L; ++i) {
      const int j = k0 + lane - i;
      sk[lane * LS + i] = (j >= 0 && j < jlim) ? c[(size_t)i * M + j] : 0.f;
    }
    __syncwarp();
    const int kend = min(CK, kmax - k0 + 1);
    for (int kk = 0; kk < kend; ++kk) {
      const int k = k0 + kk;
      float cur[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // row i-1: lane-1's register r; lane 0 reads lane 31's register
        // r-1 (row 32r - 1), and row -1 is unreachable
        const int rp = r > 0 ? r - 1 : 0;
        const bool wrap = lane == 31 && r > 0;
        const int src = (lane + 31) & 31;
        float up = __shfl_sync(FULL, wrap ? prev[rp] : prev[r], src);
        float up2 = __shfl_sync(FULL, wrap ? prev2[rp] : prev2[r], src);
        if (lane == 0 && r == 0) up = up2 = UNREACHABLE;
        const int i = lane + 32 * r;
        const int j = k - i;
        const bool valid = i < L && j >= 0 && j < jlim && abs(j * lm1 - i * mm1) <= bw;
        float best = fminf(fminf(up, prev[r]), up2);
        if (i == 0 && j == 0) best = 0.f;
        const float v = valid ? __fadd_rn(sk[kk * LS + i], best) : UNREACHABLE;
        cur[r] = fminf(v, UNREACHABLE);
      }
      if (k == kmax) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r == t_reg) term = cur[r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        prev2[r] = prev[r];
        prev[r] = cur[r];
      }
    }
  }
  if (lane == t_lane) out[n] = term;
}

template <int R, int WARPS>
int launch(const float* cost, const int* lens, float* out, int N, int L, int M, int band,
           cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  banded_dtw_kernel<R, WARPS><<<blocks, WARPS * 32, 0, stream>>>(cost, lens, out, N, L, M, band);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cost [N, L, M] f32, seg_lens [N] int32 -> out [N] f32.  1 <= L <= 256;
// band * max(L-1, 1) must fit int32 (the wrapper clamps band).
extern "C" int tsr_banded_dtw(const void* cost, const void* seg_lens, void* out, int N,
                              int L, int M, int band, void* stream) {
  const float* c = static_cast<const float*>(cost);
  const int* s = static_cast<const int*>(seg_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory per block stays below 48 KB: 4 warps x 32 x 33 words
  // at R = 1, fewer warps as R grows
  if (L <= 32) return launch<1, 4>(c, s, o, N, L, M, band, st);
  if (L <= 64) return launch<2, 4>(c, s, o, N, L, M, band, st);
  if (L <= 128) return launch<4, 2>(c, s, o, N, L, M, band, st);
  if (L <= 256) return launch<8, 1>(c, s, o, N, L, M, band, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
