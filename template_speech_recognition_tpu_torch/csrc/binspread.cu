// Kernel 9: binarize + frequency spread (+ time spread) of the layered
// frontend.
//
// Replaces template_speech_recognition_tpu/ops/binspread_pallas.py
// binarize_freqspread_pallas (_kernel; pallas_call at line 84), and the
// caller's time dilation and row mask after it
// (template_speech_recognition_tpu/frontend/planes.py:233-237).
//
// For plane p of utterance b and row t < valid[b] (and t < T):
//   pos[f] = plane[f] > os_hi[b][p],  neg[f] = plane[f] < os_lo[b][p]
// (float compares: -0.0 and +0.0 are equal, as the reference's are),
// each dilated by +-rf along f with zero fill at the plane's own edges
// (f < s and f >= F - s) and by +-rt along t with zero fill outside
// [0, min(valid, T)), written into the channel-major flat map
//   flat[b][t][2pF + f] = pos,  flat[b][t][(2p + 1)F + f] = neg;
// rows t >= valid[b] are written as zeros.  At rt = 0 this is the TPU
// kernel's function; at rt > 0 the caller's binarize_spread_flat.
//
// One block of 256 threads per (utterance, tile of TB time rows) holds
// all P planes, so its output is TB whole flat rows: one run of TB * 2PF
// contiguous bytes (32,256 at TB = 64, F = 63).  TB is the most rows up
// to 64 (a multiple of 4) whose planes fit in 75 KB of shared memory, so
// that three blocks share an SM and the log-mel scan's 384 tiles run in
// one wave.
//  0. The block copies each plane's halo span (TB + 2rt rows, F floats
//     each, one contiguous run) into shared memory with 16-byte cp.async
//     copies from the 16-byte boundary below it, all of them in flight at
//     once and none holding a register: one round trip to HBM a block.
//     Rows outside [0, min(valid, T)) are not read.
//  1. Each warp binarizes halo rows, a plane and a 32-wide f word at a
//     time, from shared memory: two ballots give the 32-bit masks of
//     both polarities; rows outside [0, min(valid, T)) are zero.
//  2. Each thread makes (row, channel) items of the output, a word at a
//     time: the frequency spread is shifts of the word and its two
//     neighbours (zero past the channel's F bits), the time spread an OR
//     over the 2rt + 1 halo rows; it ORs the word into a bit string of
//     the tile in flat order (bit r * 2PF + e * F + f) in shared memory.
//  The phases are written for few instructions a cell: a version that
//  decoded every 32-cell item with divisions took 0.044 ms.
//  3. Each thread turns 16 bits of that string into 16 bytes (a nibble
//     times 0x00204081 puts its bits into the low bits of four bytes)
//     and writes them with one 16-byte store; the 16-byte chunks are
//     aligned to the map's address, and a chunk that reaches past the
//     tile is written a byte at a time.
// The planes may be any [B, P] view of [.., T, F]-contiguous storage
// (the port hands the plane-major [4, B, T, F] kernel-1 output as a
// [B, 4, T, F] view): the kernel takes both strides.
//
// What bounds it on the H100: bytes.  At the log-mel scan's shapes (B =
// 8, P = 4, T = 3072, F = 63) the valid rows of the planes (24.2 MB) in
// and the map (12.4 MB) out take 0.011 ms at 3.35 TB/s, with or without
// the time spread: the map is written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
#ifndef BINSPREAD_MAX_TB
#define BINSPREAD_MAX_TB 64               // probe_binspread.py builds 32 and 16
#endif
constexpr int MAX_TB = BINSPREAD_MAX_TB;
constexpr int SMEM_TARGET = 75 * 1024;   // three blocks an SM

__host__ __device__ inline int words_of(int f) { return (f + 31) / 32; }
// floats of one plane's buffer: the halo span and the 16-byte slack
// below it, a multiple of 4
__host__ __device__ inline int plane_floats(int tb, int rt, int f) {
  return ((tb + 2 * rt) * f + 3 + 3) / 4 * 4;
}

// shared memory: the planes' halo spans, the halo rows' masks [TB +
// 2rt][2P][nw] and the tile's bit string (plus one word the last funnel
// shift reads)
__host__ __device__ inline size_t smem_bytes(int tb, int P, int F, int rt) {
  const size_t planes = (size_t)P * plane_floats(tb, rt, F);
  const size_t masks = (size_t)(tb + 2 * rt) * 2 * P * words_of(F);
  const size_t bits = ((size_t)tb * 2 * P * F + 31) / 32 + 1;
  return (planes + masks + bits) * 4;
}

// the most rows up to MAX_TB, a multiple of 4 (a tile then starts on a
// 32-byte boundary of its utterance's rows), whose block fits
// SMEM_TARGET; else 4
inline int tile_rows(int P, int F, int rt) {
  for (int tb = MAX_TB; tb > 4; tb -= 4)
    if (smem_bytes(tb, P, F, rt) <= SMEM_TARGET) return tb;
  return 4;
}

// 32 bits of the string m[0 .. nw) from bit pos on (zeros outside it)
__device__ __forceinline__ uint32_t bits_at(const uint32_t* m, int nw, int pos) {
  const int q = pos >> 5, r = pos & 31;
  const uint32_t lo = (q >= 0 && q < nw) ? m[q] : 0u;
  const uint32_t hi = (q + 1 >= 0 && q + 1 < nw) ? m[q + 1] : 0u;
  return __funnelshift_r(lo, hi, r);
}

// 4 bits -> 4 bytes of 0 or 1 (bit i to the low bit of byte i)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__global__ void __launch_bounds__(THREADS)
binspread_kernel(const float* __restrict__ planes, const float* __restrict__ os_hi,
                 const float* __restrict__ os_lo, const int* __restrict__ valid,
                 uint8_t* __restrict__ flat, long long sb, long long sp, int P, int T, int F,
                 int rf, int rt, int TB) {
  extern __shared__ __align__(16) float smf[];
  const int nw = words_of(F), E = 2 * P, rowlen = E * F;
  const int b = blockIdx.y, t0 = blockIdx.x * TB;
  const int rows = min(TB, T - t0), H = rows + 2 * rt;
  const int vb = min(valid[b], T);
  const int PF = plane_floats(TB, rt, F);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smf + (size_t)P * PF);   // [H][E][nw]
  uint32_t* fb = masks + (size_t)(TB + 2 * rt) * E * nw;                  // the bit string
  const int nfb = (rows * rowlen + 31) / 32 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nfb; i += THREADS) fb[i] = 0u;

  // 0. the halo rows in [0, vb): h in [h_lo, h_hi).  Plane p's rows are
  // one run of n_run floats from float `start` of the storage (as
  // offsets from the utterance's base); its buffer holds it from the
  // 16-byte boundary below, `shift` floats in.  cp.async: every unit is
  // in flight at once, and none holds a register.
  const int h_lo = max(0, rt - t0), h_hi = min(H, vb - t0 + rt);
  const int n_run = max(0, h_hi - h_lo) * F;
  const float* base_b = planes + b * sb;
  const long long row_lo = (long long)(t0 - rt + h_lo) * F;
  const long long lead = b * sb;         // the utterance's offset into the storage
  if (n_run > 0) {
    const int units = (n_run + 3) / 4 + 1;
    for (int p = 0; p < P; ++p) {
      const long long start = p * sp + row_lo;
      const long long a0 = ((lead + start) & ~3LL) - lead;
      float* dst = smf + (size_t)p * PF;
      for (int q = threadIdx.x; q < units; q += THREADS) {
        const long long g = a0 + 4LL * q;
        if (g >= start && g + 4 <= start + n_run) {
          cp16(dst + 4 * q, base_b + g);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = g + i >= start && g + i < start + n_run;
            cp4(dst + 4 * q + i, in ? base_b + g + i : base_b, in ? 4 : 0);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // 1. both polarities' 32-bit masks of each (halo row, plane, word): a
  // warp a row, two ballots a word
  for (int h = warp; h < H; h += WARPS) {
    const bool row_ok = h >= h_lo && h < h_hi;
    for (int p = 0; p < P; ++p) {
      const long long start = p * sp + row_lo;
      const int shift = (int)(start - (((lead + start) & ~3LL) - lead));
      const float* src = smf + (size_t)p * PF + shift + (row_ok ? (h - h_lo) * F : 0);
      const float hi = __ldg(os_hi + b * P + p), lo = __ldg(os_lo + b * P + p);
      uint32_t* mp = masks + (size_t)(h * E + 2 * p) * nw;
      for (int wd = 0; wd < nw; ++wd) {
        const int f = 32 * wd + lane;
        const bool ok = row_ok && f < F;
        const float x = ok ? src[f] : 0.f;
        const uint32_t pos = __ballot_sync(0xffffffffu, ok && x > hi);
        const uint32_t neg = __ballot_sync(0xffffffffu, ok && x < lo);
        if (lane == 0) {
          mp[wd] = pos;
          mp[nw + wd] = neg;
        }
      }
    }
  }
  __syncthreads();

  // 2. frequency and time spread of each output (row, channel), a word
  // at a time, ORed into the tile's bit string
  const uint32_t last = (F & 31) ? (1u << (F & 31)) - 1u : 0xffffffffu;
  for (int it = threadIdx.x; it < rows * E; it += THREADS) {
    const int r = it / E, e = it - r * E;
    if (t0 + r >= vb) continue;                           // the row mask
    for (int wd = 0; wd < nw; ++wd) {
      uint32_t v = 0u;
      for (int h = r; h <= r + 2 * rt; ++h) {
        const uint32_t* m = masks + (size_t)(h * E + e) * nw;
        if (rf < 32) {                                    // the neighbour words suffice
          const uint32_t mid = m[wd], lo = wd > 0 ? m[wd - 1] : 0u,
                         hi = wd + 1 < nw ? m[wd + 1] : 0u;
          v |= mid;
          for (int s = 1; s <= rf; ++s)
            v |= (mid >> s) | (hi << (32 - s)) | (mid << s) | (lo >> (32 - s));
        } else {
          for (int s = -rf; s <= rf; ++s) v |= bits_at(m, nw, 32 * wd + s);
        }
      }
      if (wd == nw - 1) v &= last;
      if (v) {
        const int pos = r * rowlen + e * F + 32 * wd, q = pos >> 5, sh = pos & 31;
        atomicOr(&fb[q], v << sh);
        if (sh) atomicOr(&fb[q + 1], v >> (32 - sh));
      }
    }
  }
  __syncthreads();

  // 3. bits -> bytes, 16 a thread, 16-byte stores aligned to the map
  const size_t g0 = ((size_t)b * T + t0) * rowlen;
  const long long nbytes = (long long)rows * rowlen;
  const size_t c0 = g0 >> 4, c1 = (g0 + nbytes + 15) >> 4;
  for (size_t c = c0 + threadIdx.x; c < c1; c += THREADS) {
    const long long o = (long long)(c * 16) - (long long)g0;   // the chunk's tile byte
    uint8_t* dst = flat + c * 16;
    if (o >= 0 && o + 16 <= nbytes) {
      const uint32_t bits = bits_at(fb, nfb, (int)o);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8), spread4(bits >> 12));
    } else {
      for (int i = 0; i < 16; ++i) {
        const long long oo = o + i;
        if (oo >= 0 && oo < nbytes) dst[i] = (fb[oo >> 5] >> (oo & 31)) & 1u;
      }
    }
  }
}

}  // namespace

extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows a block of a launch at (P, F, rt)
extern "C" int tsr_binspread_tile_rows(int P, int F, int rt) { return tile_rows(P, F, rt); }

// planes: element (b, p, t, f) at planes[b * sb + p * sp + t * F + f]
// (f32, 16-byte aligned storage); os_hi, os_lo [B, P] f32, valid [B]
// int32 -> flat [B, T, 2PF] uint8 (16-byte aligned).  rf, rt >= 0.
extern "C" int tsr_binspread(const void* planes, const void* os_hi, const void* os_lo,
                             const void* valid, void* flat, long long sb, long long sp,
                             int B, int P, int T, int F, int rf, int rt, void* stream) {
  if (B == 0 || P == 0 || T == 0 || F == 0) return cudaSuccess;
  const int tb = tile_rows(P, F, rt);
  const size_t smem = smem_bytes(tb, P, F, rt);
  cudaError_t err = cudaFuncSetAttribute(
      binspread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + tb - 1) / tb), (unsigned)B);
  binspread_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(os_hi),
      static_cast<const float*>(os_lo), static_cast<const int*>(valid),
      static_cast<uint8_t*>(flat), sb, sp, P, T, F, rf, rt, tb);
  return cudaGetLastError();
}
