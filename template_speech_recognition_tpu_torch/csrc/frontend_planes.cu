// Kernel 1: windowed frames -> four oriented difference planes.
//
// Replaces template_speech_recognition_tpu/ops/frontend_pallas.py
// edge_response_planes_stacked_pallas (_kernel_stacked, _make_logspec)
// and edge_response_planes_pallas (_kernel): one function, written
// plane-major [4, N, F]; the four-output form is a view of it.  Both
// modes: log-magnitude, and log-mel.  See ops/frontend_kernel.py for the
// function computed.
//
// One block owns TM frame rows plus one halo row (the "next frame" of
// its last row).  Threads [0, W) (W = nfft / 2) each own one DFT column
// c for all TM + 1 rows: re/im accumulate in registers in true fp32
// (SIMT FMA -- the log amplifies TF32 error in near-zero power bins).
// Threads [W, WP) (WP = W rounded up to a warp) only help with the
// loads; the warp after them computes the Nyquist column W, one row per
// lane.  Frames stream through shared memory in chunks of KC samples,
// stored transposed so a column thread reads four rows with one
// broadcast float4 load; the cos/sin rows are read straight from global
// memory (coalesced across the column threads, L2-resident).
//
// Log-magnitude mode: the [TM + 1, W + 1] log-spectrum tile is built in
// shared memory.  Log-mel mode: the power of all W + 1 bins is kept in
// shared memory instead (33.9 KB at nfft 512), the [TM + 1, W + 1] x
// [W + 1, n_mels] mel product runs in fp32 SIMT over each filter's
// nonzero bins only (the terms left out are exact zeros, so the sum is
// the sequential sum over all bins), and the log (no 1/2) goes to a
// second tile of n_mels columns.  Either way the spectrogram tile never
// leaves shared memory: the four differences are taken there and only
// the [4, N, F] planes are written (F = W, or n_mels - 1), one scalar
// store per cell (F may be odd).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;        // frame rows per block
constexpr int RH = TM + 1;    // rows with the halo row
constexpr int RP = 36;        // padded row stride of the frames chunk
constexpr int KC = 80;        // frame samples per shared-memory chunk
constexpr float LOG_EPS = 1e-6f;

__device__ __forceinline__ float power_of(float re, float im) {
  // no FMA contraction: the same roundings as the plain version's
  // re*re + im*im
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__global__ void planes_kernel(const float* __restrict__ frames,
                              const float* __restrict__ cosm,
                              const float* __restrict__ sinm,
                              const float* __restrict__ fbt,
                              const int* __restrict__ mrange,
                              float* __restrict__ out,
                              int N, int FL, int W, int NM) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [KC][RP]: xs[k * RP + r]
  float* tile = smem + KC * RP;      // [RH][W + 1]: log-spectrum or mel-mode power
  const int r0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int bins = W + 1;            // columns of the cos/sin matrices
  const int wp = (W + 31) & ~31;
  const int lane = tid & 31;
  const bool column_thread = tid < W;
  const bool nyquist_warp = tid >= wp;

  float re[RH], im[RH];
#pragma unroll
  for (int r = 0; r < RH; ++r) { re[r] = 0.f; im[r] = 0.f; }
  float ny_re0 = 0.f, ny_im0 = 0.f, ny_re1 = 0.f, ny_im1 = 0.f;

  for (int k0 = 0; k0 < FL; k0 += KC) {
    // frames chunk, k fastest in global memory (coalesced), stored
    // transposed; rows past N clamp to N - 1 (masked by the caller)
    for (int idx = tid; idx < RH * KC; idx += blockDim.x) {
      const int r = idx / KC, kk = idx - r * KC;
      const int row = min(r0 + r, N - 1);
      const int k = k0 + kk;
      xs[kk * RP + r] = k < FL ? frames[(size_t)row * FL + k] : 0.f;
    }
    __syncthreads();
    const int kn = min(KC, FL - k0);
    if (column_thread) {
      for (int kk = 0; kk < kn; ++kk) {
        const float cv = __ldg(cosm + (size_t)(k0 + kk) * bins + tid);
        const float sv = __ldg(sinm + (size_t)(k0 + kk) * bins + tid);
        const float4* x4 = reinterpret_cast<const float4*>(xs + kk * RP);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 x = x4[q];
          re[4 * q + 0] = fmaf(x.x, cv, re[4 * q + 0]);
          im[4 * q + 0] = fmaf(x.x, sv, im[4 * q + 0]);
          re[4 * q + 1] = fmaf(x.y, cv, re[4 * q + 1]);
          im[4 * q + 1] = fmaf(x.y, sv, im[4 * q + 1]);
          re[4 * q + 2] = fmaf(x.z, cv, re[4 * q + 2]);
          im[4 * q + 2] = fmaf(x.z, sv, im[4 * q + 2]);
          re[4 * q + 3] = fmaf(x.w, cv, re[4 * q + 3]);
          im[4 * q + 3] = fmaf(x.w, sv, im[4 * q + 3]);
        }
        const float xl = xs[kk * RP + TM];
        re[TM] = fmaf(xl, cv, re[TM]);
        im[TM] = fmaf(xl, sv, im[TM]);
      }
    } else if (nyquist_warp) {
      // Nyquist warp: lane l owns row l, lane 0 also the halo row
      for (int kk = 0; kk < kn; ++kk) {
        const float cv = __ldg(cosm + (size_t)(k0 + kk) * bins + W);
        const float sv = __ldg(sinm + (size_t)(k0 + kk) * bins + W);
        const float x0 = xs[kk * RP + lane];
        ny_re0 = fmaf(x0, cv, ny_re0);
        ny_im0 = fmaf(x0, sv, ny_im0);
        const float x1 = xs[kk * RP + TM];
        ny_re1 = fmaf(x1, cv, ny_re1);
        ny_im1 = fmaf(x1, sv, ny_im1);
      }
    }
    __syncthreads();
  }

  // log-magnitude mode: 0.5 * log(power + eps); mel mode: the power
  if (column_thread) {
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const float p = power_of(re[r], im[r]);
      tile[r * bins + tid] = NM ? p : 0.5f * logf(__fadd_rn(p, LOG_EPS));
    }
  } else if (nyquist_warp) {
    const float p0 = power_of(ny_re0, ny_im0);
    tile[lane * bins + W] = NM ? p0 : 0.5f * logf(__fadd_rn(p0, LOG_EPS));
    if (lane == 0) {
      const float p1 = power_of(ny_re1, ny_im1);
      tile[TM * bins + W] = NM ? p1 : 0.5f * logf(__fadd_rn(p1, LOG_EPS));
    }
  }
  __syncthreads();

  const float* spec = tile;
  int ld = bins, F = W;
  if (NM) {
    // mel product over each filter's nonzero bins [lo, hi), then log
    float* mel = tile + RH * bins;   // [RH][NM]
    for (int idx = tid; idx < RH * NM; idx += blockDim.x) {
      const int r = idx / NM, m = idx - r * NM;
      const int lo = mrange[2 * m], hi = mrange[2 * m + 1];
      const float* pr = tile + r * bins;
      const float* fr = fbt + (size_t)m * bins;
      float acc = 0.f;
      for (int b = lo; b < hi; ++b) acc = fmaf(pr[b], __ldg(fr + b), acc);
      mel[idx] = logf(__fadd_rn(acc, LOG_EPS));
    }
    __syncthreads();
    spec = mel;
    ld = NM;
    F = NM - 1;
  }

  const size_t plane = (size_t)N * F;
  for (int idx = tid; idx < TM * F; idx += blockDim.x) {
    const int r = idx / F, f = idx - r * F;
    const int row = r0 + r;
    if (row >= N) continue;
    const float* cur = spec + r * ld;
    const float* nxt = cur + ld;
    const size_t o = (size_t)row * F + f;
    out[o] = nxt[f] - cur[f];                   // d_time
    out[plane + o] = cur[f + 1] - cur[f];       // d_freq
    out[2 * plane + o] = nxt[f + 1] - cur[f];   // d_diag
    out[3 * plane + o] = nxt[f] - cur[f + 1];   // d_anti
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames [N, FL] f32, cosm/sinm [FL, W + 1] f32 -> out [4, N, F] f32.
// Log-magnitude mode (NM == 0): F = W; fbt and mrange are unused.
// Log-mel mode (NM >= 2): fbt [NM, W + 1] f32 is the transposed mel
// filterbank, mrange [NM, 2] int32 each filter's nonzero bins [lo, hi),
// and F = NM - 1.  W rounded up to 32, plus 32, is at most 1024: the
// block has that many threads.
extern "C" int tsr_frontend_planes(const float* frames, const float* cosm,
                                   const float* sinm, const float* fbt,
                                   const int* mrange, float* out, int N,
                                   int FL, int W, int NM, void* stream) {
  const int threads = ((W + 31) & ~31) + 32;
  const size_t smem = sizeof(float) * ((size_t)KC * RP + (size_t)RH * (W + 1) +
                                       (size_t)RH * NM);
  cudaError_t err = cudaFuncSetAttribute(
      planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + TM - 1) / TM;
  planes_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, cosm, sinm, fbt, mrange, out, N, FL, W, NM);
  return cudaGetLastError();
}
