// Kernel 2: exact dual-rank order-statistic select + binarize + spread.
//
// Replaces template_speech_recognition_tpu/ops/selbin_pallas.py
// select_binspread_pallas (_kernel_allplanes and the per-plane _kernel).
// See ops/selbin_kernel.py for the function computed.
//
// The TPU kernel keeps a whole [T, F] plane (~3 MB) resident in VMEM
// and bisects it 32 times.  An SM has 227 KB of shared memory, so the
// select here is a multi-block radix select through global memory:
//
//   for level in 0..3 (8-bit digits, most significant first):
//     radix_hist:   grid (chunks, pairs); each block counts the digits
//                   of its slice of one pair's valid keys that match
//                   the prefix selected so far, for both ranks, into
//                   shared histograms (warp-aggregated atomics), then
//                   adds them into the pair's global histogram
//     radix_digit:  one thread per (pair, rank) scans the 256 counts
//                   and extends the prefix by the digit that holds
//                   the rank
//   binspread:      grid (row tiles, planes, utterances); reads the
//                   planes once more, compares canonicalized keys
//                   against both selected keys and writes the final
//                   flat map with both dilations and the row mask.
//
// Any digit schedule selects the same element as the bisection, so
// keys and map are bitwise those of the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t SIGN = 0x80000000u;
constexpr int HIST_THREADS = 256;
constexpr int CHUNK = 16384;      // keys per radix_hist block
constexpr int TT = 32;            // rows per binspread block

// state[q * 6 + r * 3 + {0, 1, 2}] = {prefix, remaining rank, done}
// for pair q = p * B + b and rank r (0: k, 1: n-1-k).

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & SIGN) ? ~b : (b | SIGN);
}

__device__ __forceinline__ uint32_t canon(uint32_t k) {
  return k == 0x7FFFFFFFu ? SIGN : k;   // -0.0 key -> +0.0 key
}

// Warp-aggregated shared-memory histogram add; bin < 0 adds nothing.
// Every lane of the warp must call it together.
__device__ __forceinline__ void hist_add(int* h, int bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int leader = __ffs(peers) - 1;
  if (bin >= 0 && (int)(threadIdx.x & 31) == leader) atomicAdd(&h[bin], __popc(peers));
}

__global__ void __launch_bounds__(HIST_THREADS)
radix_hist(const float* __restrict__ planes, const int* __restrict__ valid,
           const uint32_t* __restrict__ state, int* __restrict__ hist,
           int B, int F, size_t TF, int level) {
  __shared__ int sh[512];
  for (int j = threadIdx.x; j < 512; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  const int q = blockIdx.y;
  const int vq = valid[q % B];
  const size_t nv = vq > 0 ? (size_t)vq * F : 0;
  const size_t n = nv < TF ? nv : TF;            // valid cells: a prefix
  const size_t start = (size_t)blockIdx.x * CHUNK;
  const size_t end = start + CHUNK < n ? start + CHUNK : n;
  const int shift = 24 - 8 * level;
  bool act_hi = true, act_lo = false;            // level 0: one shared histogram
  uint32_t pre_hi = 0, pre_lo = 0;
  if (level > 0) {
    pre_hi = state[q * 6 + 0];
    act_hi = state[q * 6 + 2] == 0;
    pre_lo = state[q * 6 + 3];
    act_lo = state[q * 6 + 5] == 0;
  }
  const float* src = planes + (size_t)q * TF;
  // the trip count is uniform across the block, so every lane reaches
  // hist_add together
  for (size_t base = start; base < end; base += (size_t)HIST_THREADS * 4) {
    const size_t i = base + threadIdx.x * 4;
    float v[4];
    if (i + 3 < end) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i + j < end ? src[i + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < end;
      const uint32_t key = order_key(v[j]);
      const int digit = (int)((key >> shift) & 255u);
      const uint32_t top = level > 0 ? key >> (shift + 8) : 0u;
      hist_add(sh, (in && act_hi && top == pre_hi) ? digit : -1);
      if (level > 0)
        hist_add(sh + 256, (in && act_lo && top == pre_lo) ? digit : -1);
    }
  }
  __syncthreads();
  int* g = hist + (size_t)q * 512;
  for (int j = threadIdx.x; j < 512; j += blockDim.x)
    if (sh[j]) atomicAdd(&g[j], sh[j]);
}

__global__ void radix_digit(const int* __restrict__ hist,
                            const int* __restrict__ need_in,
                            uint32_t* __restrict__ state, int Q, int B,
                            int level) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * Q) return;
  const int q = idx >> 1, r = idx & 1;
  uint32_t* st = state + q * 6 + r * 3;
  // level 0 counted every valid key once, into the first histogram
  const int* h = hist + (size_t)q * 512 + (level == 0 ? 0 : r * 256);
  uint32_t prefix;
  int need;
  if (level == 0) {
    prefix = 0;
    need = need_in[(q % B) * 2 + r];
    int total = 0;
    for (int d = 0; d < 256; ++d) total += h[d];
    // the bisection's edge cases: rank 0 selects key 0; a rank past
    // the valid cells selects the masked key 0xFFFFFFFF
    if (need <= 0 || need > total) {
      st[0] = need <= 0 ? 0u : 0xFFFFFFFFu;
      st[1] = 0;
      st[2] = 1;
      return;
    }
  } else {
    if (st[2]) return;
    prefix = st[0];
    need = (int)st[1];
  }
  int cum = 0, d = 0;
  for (; d < 255; ++d) {
    if (cum + h[d] >= need) break;
    cum += h[d];
  }
  st[0] = (prefix << 8) | (uint32_t)d;
  st[1] = (uint32_t)(need - cum);
  st[2] = 0;
}

__global__ void binspread(const float* __restrict__ planes,
                          const int* __restrict__ valid,
                          const uint32_t* __restrict__ state,
                          uint8_t* __restrict__ flat, uint32_t* __restrict__ keys,
                          int P, int B, int T, int F, int rf, int rt) {
  extern __shared__ uint8_t sm[];
  const int p = blockIdx.y, b = blockIdx.z, q = p * B + b;
  const int rows = TT + 2 * rt;
  uint8_t* s_pos = sm;
  uint8_t* s_neg = sm + rows * F;
  const uint32_t v_hi = state[q * 6 + 0], v_lo = state[q * 6 + 3];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    keys[(b * P + p) * 2 + 0] = v_hi;
    keys[(b * P + p) * 2 + 1] = v_lo;
  }
  const uint32_t c_hi = canon(v_hi), c_lo = canon(v_lo);
  const int vb = valid[b];
  const int t0 = blockIdx.x * TT;
  const float* src = planes + (size_t)q * T * F;
  for (int idx = threadIdx.x; idx < rows * F; idx += blockDim.x) {
    const int rr = idx / F, f = idx - rr * F;
    const int t = t0 - rt + rr;
    uint8_t pos = 0, neg = 0;
    if (t >= 0 && t < T && t < vb) {
      const uint32_t k = canon(order_key(src[(size_t)t * F + f]));
      pos = k > c_hi;
      neg = k < c_lo;
    }
    s_pos[idx] = pos;
    s_neg[idx] = neg;
  }
  __syncthreads();
  const size_t row_len = (size_t)2 * P * F;
  for (int idx = threadIdx.x; idx < TT * F; idx += blockDim.x) {
    const int r = idx / F, f = idx - r * F;
    const int t = t0 + r;
    if (t >= T) continue;
    uint8_t op = 0, on = 0;
    if (t < vb) {
      for (int dt = 0; dt <= 2 * rt; ++dt) {
        const int base = (r + dt) * F;
        for (int df = -rf; df <= rf; ++df) {
          const int ff = f + df;
          if (ff < 0 || ff >= F) continue;
          op |= s_pos[base + ff];
          on |= s_neg[base + ff];
        }
      }
    }
    uint8_t* dst = flat + (size_t)(b * T + t) * row_len + (size_t)(2 * p) * F + f;
    dst[0] = op;
    dst[F] = on;
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes [P, B, T, F] f32, need [B, 2] i32, valid [B] i32
// -> flat [B, T, 2PF] u8, keys [B, P, 2] u32.
// Scratch: hist [4, P*B, 2, 256] i32, state [P*B, 6] u32.
extern "C" int tsr_select_binspread(const float* planes, const int* need,
                                    const int* valid, uint8_t* flat,
                                    uint32_t* keys, int* hist, uint32_t* state,
                                    int P, int B, int T, int F, int rf, int rt,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Q = P * B;
  const size_t TF = (size_t)T * F;
  const size_t per_level = (size_t)Q * 512;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * 4 * per_level, s);
  if (err != cudaSuccess) return err;
  const dim3 hgrid((unsigned)((TF + CHUNK - 1) / CHUNK), (unsigned)Q);
  for (int level = 0; level < 4; ++level) {
    radix_hist<<<hgrid, HIST_THREADS, 0, s>>>(planes, valid, state,
                                              hist + level * per_level, B, F,
                                              TF, level);
    radix_digit<<<(2 * Q + 63) / 64, 64, 0, s>>>(hist + level * per_level,
                                                 need, state, Q, B, level);
  }
  const size_t smem = (size_t)2 * (TT + 2 * rt) * F;
  err = cudaFuncSetAttribute(binspread, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  binspread<<<dim3((T + TT - 1) / TT, P, B), 256, smem, s>>>(
      planes, valid, state, flat, keys, P, B, T, F, rf, rt);
  return cudaGetLastError();
}
