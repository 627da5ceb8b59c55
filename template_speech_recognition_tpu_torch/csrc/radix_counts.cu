// Kernel 8: one counting pass of the layered radix select.
//
// Replaces template_speech_recognition_tpu/ops/radix_pallas.py
// radix_level_counts_pallas (_count_kernel; pallas_call at line 85).
//
//   out[r][j] = #{ n : (keys[r][n] >> shift) <= cand[r][j] }
//
// over uint32 keys [R, N] (masked cells hold 0xFFFFFFFF) and uint32
// candidates [R, NC], NC <= 16; unsigned 32-bit shifts and compares.
//
// Grid (chunks of a row, rows).  Each thread holds its row's candidates
// in registers (NCT = NC rounded up to a power of two; the extra slots
// count too and are never written), reads its keys four at a time
// (16-byte loads where the row allows) and compares each against every
// candidate.  The per-thread counts are summed across the warp with
// __reduce_add_sync, across the block's warps in shared memory, and
// added into out with one atomic per (row, candidate) per block; the
// host zeroes out first.  Keys are read exactly once per launch.
//
// What bounds it on the H100: bytes.  At the log-mel scan's shapes
// (R = 32 plane rows of N = 3072 x 63 = 193,536 keys) one launch reads
// 24.8 MB, 0.0074 ms at 3.35 TB/s; its 99 M compares (NC = 16) take
// 0.003 ms at 67 T/s, though the SIMT integer pipes run at about half
// that rate, so compares and bytes are close.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;      // keys of one row per block

template <int NCT>
__global__ void __launch_bounds__(THREADS)
radix_counts_kernel(const uint32_t* __restrict__ keys,
                    const uint32_t* __restrict__ cand, int* __restrict__ out,
                    int N, int NC, int shift, bool vec) {
  __shared__ int part[WARPS][NCT];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t c[NCT];
  int cnt[NCT];
#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    c[j] = j < NC ? cand[(size_t)row * NC + j] : 0u;
    cnt[j] = 0;
  }
  const uint32_t* src = keys + (size_t)row * N;
  const int start = blockIdx.x * CHUNK;
  const int end = min(start + CHUNK, N);
  for (int i = start + 4 * threadIdx.x; i < end; i += 4 * THREADS) {
    if (vec && i + 3 < end) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + i));
      const uint32_t k[4] = {v.x >> shift, v.y >> shift, v.z >> shift, v.w >> shift};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < NCT; ++j) cnt[j] += k[q] <= c[j] ? 1 : 0;
    } else {
      // unaligned rows and the row's ragged end, one key at a time
      for (int q = 0; q < 4 && i + q < end; ++q) {
        const uint32_t hi = __ldg(src + i + q) >> shift;
#pragma unroll
        for (int j = 0; j < NCT; ++j) cnt[j] += hi <= c[j] ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[j]);
    if (lane == 0) part[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    if (s) atomicAdd(out + (size_t)row * NC + threadIdx.x, s);
  }
}

template <int NCT>
cudaError_t launch(const uint32_t* keys, const uint32_t* cand, int* out, int R, int N,
                   int NC, int shift, bool vec, cudaStream_t s) {
  const dim3 grid((unsigned)((N + CHUNK - 1) / CHUNK), (unsigned)R);
  radix_counts_kernel<NCT><<<grid, THREADS, 0, s>>>(keys, cand, out, N, NC, shift, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys [R, N] uint32, cand [R, NC] uint32 (1 <= NC <= 16), 0 <= shift
// < 32 -> out [R, NC] int32.
extern "C" int tsr_radix_counts(const void* keys, const void* cand, void* out, int R,
                                int N, int NC, int shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)R * NC, s);
  if (err != cudaSuccess) return err;
  if (N == 0) return cudaSuccess;
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* c = static_cast<const uint32_t*>(cand);
  int* o = static_cast<int*>(out);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  if (NC <= 2) return launch<2>(k, c, o, R, N, NC, shift, vec, s);
  if (NC <= 4) return launch<4>(k, c, o, R, N, NC, shift, vec, s);
  if (NC <= 8) return launch<8>(k, c, o, R, N, NC, shift, vec, s);
  return launch<16>(k, c, o, R, N, NC, shift, vec, s);
}
