// Kernel 9: binarize + frequency spread of the layered frontend.
//
// Replaces template_speech_recognition_tpu/ops/binspread_pallas.py
// binarize_freqspread_pallas (_kernel; pallas_call at line 84).
//
// For plane p of utterance b and row t < valid[b]:
//   pos[f] = plane[f] > os_hi[b][p],  neg[f] = plane[f] < os_lo[b][p]
// (float compares: -0.0 and +0.0 are equal, as the reference's are),
// each dilated by +-rf along f with zero fill at the plane's own edges
// (f < s and f >= F - s), written into the channel-major flat map
//   flat[b][t][2pF + f] = pos,  flat[b][t][(2p + 1)F + f] = neg;
// rows t >= valid[b] are written as zeros.  Time dilation stays with
// the caller.
//
// One block per (time tile of TB rows, plane, utterance): the [TB, F]
// plane tile is read once (coalesced: a tile's cells are contiguous),
// both binarized channels go to shared memory, and the dilated rows are
// written with one byte store per cell: a flat row (2PF bytes, 504 at
// F = 63) is not 16-byte aligned and a channel segment not even 4-byte
// aligned.  The planes may be any [B, P] view of [.., T, F]-contiguous
// storage (the port hands the plane-major [4, B, T, F] kernel-1 output
// as a [B, 4, T, F] view): the kernel takes both strides.
//
// What bounds it on the H100: bytes.  At the log-mel scan's shapes (B =
// 8, P = 4, T = 3072, F = 63) the planes (24.8 MB) in and the map (12.4
// MB) out take 0.011 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;           // rows per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
binspread_kernel(const float* __restrict__ planes, const float* __restrict__ os_hi,
                 const float* __restrict__ os_lo, const int* __restrict__ valid,
                 uint8_t* __restrict__ flat, long long sb, long long sp, int P, int T,
                 int F, int rf) {
  extern __shared__ uint8_t sm[];
  uint8_t* s_pos = sm;
  uint8_t* s_neg = sm + TB * F;
  const int p = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * TB;
  const int vb = valid[b];
  const float hi = os_hi[b * P + p], lo = os_lo[b * P + p];
  const float* src = planes + b * sb + p * sp + (size_t)t0 * F;
  const int rows = min(TB, T - t0);
  for (int idx = threadIdx.x; idx < rows * F; idx += THREADS) {
    const int t = t0 + idx / F;
    uint8_t pos = 0, neg = 0;
    if (t < vb) {
      const float x = src[idx];
      pos = x > hi;
      neg = x < lo;
    }
    s_pos[idx] = pos;
    s_neg[idx] = neg;
  }
  __syncthreads();
  const size_t row_len = (size_t)2 * P * F;
  uint8_t* dst0 = flat + ((size_t)b * T + t0) * row_len + (size_t)2 * p * F;
  for (int idx = threadIdx.x; idx < rows * F; idx += THREADS) {
    const int r = idx / F, f = idx - r * F;
    const int f_lo = max(f - rf, 0), f_hi = min(f + rf, F - 1);
    uint8_t op = 0, on = 0;
    for (int ff = f_lo; ff <= f_hi; ++ff) {
      op |= s_pos[r * F + ff];
      on |= s_neg[r * F + ff];
    }
    uint8_t* dst = dst0 + (size_t)r * row_len + f;
    dst[0] = op;
    dst[F] = on;
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes: element (b, p, t, f) at planes[b * sb + p * sp + t * F + f]
// (f32); os_hi, os_lo [B, P] f32, valid [B] int32 -> flat [B, T, 2PF]
// uint8.  rf >= 0.
extern "C" int tsr_binspread(const void* planes, const void* os_hi, const void* os_lo,
                             const void* valid, void* flat, long long sb, long long sp,
                             int B, int P, int T, int F, int rf, void* stream) {
  if (B == 0 || P == 0 || T == 0 || F == 0) return cudaSuccess;
  const size_t smem = (size_t)2 * TB * F;
  cudaError_t err = cudaFuncSetAttribute(
      binspread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + TB - 1) / TB), (unsigned)P, (unsigned)B);
  binspread_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(os_hi),
      static_cast<const float*>(os_lo), static_cast<const int*>(valid),
      static_cast<uint8_t*>(flat), sb, sp, P, T, F, rf);
  return cudaGetLastError();
}
