#!/usr/bin/env python3
"""What holds the banded DTW (``csrc/banded_dtw.cu``, kernels 12 and 13)
back: time the kernel beside its staging alone, a row-at-a-time staging
alone, and the dependent chain with no memory, on one NVIDIA GPU (H100).

    python3 probe_banded_dtw.py [VARIANT ...]

Variants (all of them, or those named), built into
``template_speech_recognition_tpu_torch/_build/probe/``:

* ``kernel``: the source as it is (the scan's tiles by one bulk copy a
  pair, other shapes through a ring of 3 chunks a warp);
* ``unroll1``, ``unroll8``: the chain's loop unrolled 1 and 8 times
  (``-DDTW_UNROLL``; the source: 4);
* ``no_c``: the fused mode without its c reads (``-DDTW_NO_C``, wrong
  values, timed only);
* ``ring``: every pair through the ring (``-DDTW_NO_TILE``); ``ring2``:
  a ring of 2 chunks (``-DDTW_STAGES=2``);
* ``stage_tile``, ``stage_ring``: the staging alone (``-DDTW_STAGE_ONLY``:
  the bulk copies, or every chunk's cp.async copies, issued and waited
  for, one word read, no chain);
* ``chain_nocopy``: the ring kernel with no copy issued (``-DDTW_NO_COPY``,
  wrong values, timed only): the chain without copies in flight;
* ``prologue``: each pair's setup alone (``-DDTW_PROLOGUE_ONLY``: its
  segment length and row read, the warp's last diagonal, no staging);
* ``stage_old``: staging a row at a time, alone (one warp a pair, each
  lane a global load and a shared store that waits on it, L loads a
  chunk of 32 diagonals into a skewed tile, no chain);
* ``chain``: the chain floor: one warp, L + seg_len - 1 steps of two
  dependent shuffles, two ``fminf`` and one add, nothing read from
  memory; ``chain_grid``: that chain in as many warps as the kernel
  runs (two pairs a warp);
* ``empty``: an empty kernel, the launch floor of a loop of launches.

The kernel variants are first held bitwise (finite terminals and scores)
to the plain versions at 8 shapes (the scan's, L 96, m 1024, band 100 at
L 32, L 1, L 256, the exhaustive GEMM view, the gathered route's m 38).
Timed shapes: ``row12``, the verify-the-winner rescore's pairs (984 =
8 x 123, L 32, m 40, band 6, seg_len = min(2998 - t, 38) at random
window starts t, random LLR tiles, c rows of 1024 templates, random
winner ids); ``row13``, 984 pairs of L 96, m 104, band 6, seg_len in
[51, 102]; the kernel in its fused mode (``_fused``: the routes' launch)
and raw mode.  Each is timed with ``chip_smoke.time_ms`` over loops of
100 launches, each variant in a process of its own under a 240 s limit.
Prints the card's name and power limit, one line a variant and one JSON
line.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import SEED, card_line, time_ms

ROOT = Path(__file__).resolve().parent
N_PAIRS, K, VALID, BAND = 984, 1024, 2998, 6
# tag -> (L, m, seg_len low, seg_len high)
SHAPES = {"row12": (32, 40, None, None), "row13": (96, 104, 51, 102)}
FLAGS = {"kernel": [], "unroll1": ["-DDTW_UNROLL=1"], "unroll8": ["-DDTW_UNROLL=8"],
         "no_c": ["-DDTW_NO_C"],
         "ring": ["-DDTW_NO_TILE"], "ring2": ["-DDTW_NO_TILE", "-DDTW_STAGES=2"],
         "stage_tile": ["-DDTW_STAGE_ONLY"], "stage_ring": ["-DDTW_STAGE_ONLY", "-DDTW_NO_TILE"],
         "chain_nocopy": ["-DDTW_NO_COPY", "-DDTW_NO_TILE"], "prologue": ["-DDTW_PROLOGUE_ONLY"]}
CHECKED = ("kernel", "unroll1", "unroll8", "ring", "ring2")
EMBEDDED = ("stage_old", "chain", "chain_grid", "empty")
VARIANTS = tuple(FLAGS) + EMBEDDED

# staging a row at a time (a load, then the shared store that waits on
# it, for each of L rows a chunk), the chain floor and an empty kernel
PROBE_SRC = r"""
#include <cuda_runtime.h>
constexpr unsigned FULL = 0xffffffffu;
template <int R, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
stage_old(const float* __restrict__ cost, const int* __restrict__ seg_lens,
          float* __restrict__ out, int N, int L, int M) {
  constexpr int LS = R * 32 + 1;
  __shared__ float smem[WARPS][32 * LS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;
  float* sk = smem[warp];
  const float* c = cost + (size_t)n * L * M;
  const int mlen = seg_lens[n];
  const int jlim = min(mlen, M);
  const int kmax = mlen > M ? -1 : L - 1 + mlen - 1;
  float acc = 0.f;
  for (int k0 = 0; k0 <= kmax; k0 += 32) {
    __syncwarp();
    for (int i = 0; i < L; ++i) {
      const int j = k0 + lane - i;
      sk[lane * LS + i] = (j >= 0 && j < jlim) ? c[(size_t)i * M + j] : 0.f;
    }
    __syncwarp();
    acc += sk[lane * LS + (lane % L)];
  }
  if (lane == 0) out[n] = acc;
}
__global__ void chain(float* out, int steps) {
  const int lane = threadIdx.x & 31;
  float p = lane, q = lane * 0.5f;
  for (int s = 0; s < steps; ++s) {
    const float up = __shfl_sync(FULL, p, (lane + 15) & 15, 16);
    const float lq = __shfl_sync(FULL, q, (lane + 1) & 15, 16);
    const float v = __fadd_rn(fminf(up, lq), 1.f);
    q = fminf(v, up);
    p = v;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = p;
}
__global__ void empty(float*) {}
extern "C" const char* tsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
extern "C" int probe_stage_old(const void* cost, const void* lens, void* out, int N, int L,
                               int M, void* stream) {
  const float* c = static_cast<const float*>(cost);
  const int* s = static_cast<const int*>(lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 32) stage_old<1, 4><<<(N + 3) / 4, 128, 0, st>>>(c, s, o, N, L, M);
  else stage_old<4, 2><<<(N + 1) / 2, 64, 0, st>>>(c, s, o, N, L, M);
  return cudaGetLastError();
}
extern "C" int probe_chain(void* out, int warps, int steps, void* stream) {
  chain<<<(warps + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), steps);
  return cudaGetLastError();
}
extern "C" int probe_empty(void* out, void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out));
  return cudaGetLastError();
}
"""


def build(_cuda, names):
    """Build each variant's library (one nvcc each, all at once); returns
    {variant: path}, printing each build's registers and spills."""
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src_probe = out / "banded_dtw_probe.cu"
    src_probe.write_text(PROBE_SRC)
    jobs, paths = {}, {}
    for name in names:
        if name in FLAGS:
            so, src, flags = out / f"libbanded_dtw_{name}.so", _cuda.CSRC / "banded_dtw.cu", FLAGS[name]
        else:
            so, src, flags = out / "libbanded_dtw_probe.so", src_probe, []
        paths[name] = str(so)
        if str(so) in jobs:
            continue
        jobs[str(so)] = (name, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for so, (name, proc) in jobs.items():
        log, _ = proc.communicate()
        entry = "?"
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"ptxas ({Path(so).name}, {entry[-32:]}): {line.strip()}", flush=True)
    return paths


def operands(torch, dev, tag, seed):
    """The timed shape's LLR tiles, seg_lens, c rows and winner ids."""
    import numpy as np

    length, m, lo, hi = SHAPES[tag]
    rng = np.random.default_rng(seed)
    llr = torch.from_numpy(
        (rng.standard_normal((N_PAIRS, length, m)) - 2.0).astype(np.float32)).to(dev)
    if lo is None:
        t = rng.integers(0, VALID, N_PAIRS)
        lens = np.clip(VALID - t, 1, length + BAND)
    else:
        lens = rng.integers(lo, hi + 1, N_PAIRS)
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    c_rows = torch.from_numpy(rng.standard_normal((K, length)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, K, N_PAIRS).astype(np.int32)).to(dev)
    return llr, lens, c_rows, ids


def check_kernel(torch, kd, lib, dev):
    """The variant bitwise against the plain versions at 8 shapes; returns
    how many pairs it held."""
    import numpy as np

    rng = np.random.default_rng(SEED + 15)
    held = 0
    # (label, L, m, band, pairs, gemm view segments)
    for label, length, m, band, n, nb in (
            ("scan", 32, 40, 6, 984, 0), ("L 96", 96, 104, 6, 77, 0),
            ("m 1024", 32, 1024, 6, 21, 0), ("band 100 at L 32", 32, 40, 100, 37, 0),
            ("L 1", 1, 8, 3, 70, 0), ("L 256", 256, 300, 100, 9, 0),
            ("gemm view", 32, 38, 6, 0, 12), ("gathered m 38", 32, 38, 6, 53, 0)):
        if nb:
            q = 41
            gemm = torch.from_numpy(
                rng.standard_normal((nb, m, q, length)).astype(np.float32) - 2.0).to(dev)
            llr = gemm.permute(0, 2, 3, 1)
            lens = np.clip(rng.integers(length - 4, m + 1, nb), 1, m).astype(np.int32)
            lens[0] = 1
            c_tab, cid = torch.randn(q, length, device=dev), None
        else:
            llr = torch.from_numpy(
                rng.standard_normal((n, length, m)).astype(np.float32) - 2.0).to(dev)
            lens = np.clip(rng.integers(length - 4, m + 1, n), 1, m).astype(np.int32)
            lens[:3] = (1, m, m + 2)
            c_tab = torch.randn(5, length, device=dev)
            cid = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        llr4 = llr if llr.dim() == 4 else llr[:, None]
        got = kd._launch(llr4, lens, c_tab, cid, band, True, lib=lib).reshape(llr.shape[:-2])
        want = kd.banded_dtw_scores_plain(llr, lens, c_tab, band, cid)
        fin = torch.isfinite(want)
        if not (bool(fin.any()) and torch.equal(got[fin], want[fin])
                and bool(torch.isneginf(got[~fin]).all())):
            raise RuntimeError(f"fused mode at {label}: not bitwise")
        if llr.dim() == 3:
            cost = -(llr + c_tab[cid.long()][:, :, None])
            got_t = kd._launch(cost[:, None], lens, None, None, band, False, lib=lib)
            want_t = kd.banded_dtw_plain(cost, lens, band)
            fin = want_t < 1e37
            if not (torch.equal(got_t[fin], want_t[fin]) and bool((got_t[~fin] > 1e38).all())):
                raise RuntimeError(f"raw mode at {label}: not bitwise")
        held += want.numel()
    return held


def run_variant(name: str, so: str) -> dict:
    import torch

    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import dtw_kernel as kd

    lib = ctypes.CDLL(so)
    lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tsr_cuda_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda")
    row = {"variant": name}
    if name in CHECKED:
        row["bitwise_pairs"] = check_kernel(torch, kd, lib, dev)
    for tag, (length, m, _lo, _hi) in SHAPES.items():
        llr, lens, c_rows, ids = operands(torch, dev, tag, SEED + length)
        steps = int(lens.max()) + length - 1
        stream = _cuda.stream_ptr(dev)
        if name in FLAGS:
            cost = -(llr + c_rows[ids.long()][:, :, None])
            calls = {"": lambda: kd._launch(cost[:, None], lens, None, None, BAND, False, lib=lib),
                     "_fused": lambda: kd._launch(llr[:, None], lens, c_rows, ids, BAND, True,
                                                  lib=lib)}
        elif name == "stage_old":
            cost = -(llr + c_rows[ids.long()][:, :, None])
            out = torch.empty(N_PAIRS, device=dev)
            fn = _cuda.declare(lib, "probe_stage_old", 3, 3)
            calls = {"": lambda: _cuda.check(lib, fn(
                _cuda.ptr(cost), _cuda.ptr(lens), _cuda.ptr(out), N_PAIRS, length, m, stream),
                name)}
        elif name in ("chain", "chain_grid"):
            warps = 1 if name == "chain" else N_PAIRS // 2
            out = torch.empty(-(-warps // 4) * 128, device=dev)
            fn = _cuda.declare(lib, "probe_chain", 1, 2)
            calls = {"": lambda: _cuda.check(lib, fn(_cuda.ptr(out), warps, steps, stream), name)}
            row[f"{tag}_steps"] = steps
        else:
            out = torch.empty(1, device=dev)
            fn = _cuda.declare(lib, "probe_empty", 1, 0)
            calls = {"": lambda: _cuda.check(lib, fn(_cuda.ptr(out), stream), name)}
        for suffix, call in calls.items():
            call()
            torch.cuda.synchronize()
            row[f"{tag}{suffix}_loop100_ms"] = time_ms(torch, call, loop=100)
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_banded_dtw: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {VARIANTS}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    paths = build(_cuda, names)
    rows, failed = [], []
    for name in names:
        proc = subprocess.run([sys.executable, __file__, "--one", name, paths[name]],
                              capture_output=True, text=True, timeout=240, cwd=ROOT)
        if proc.returncode != 0:
            failed.append(name)
            print(f"{name}: FAILED (exit {proc.returncode})\n{proc.stderr[-3000:]}", flush=True)
            continue
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
    print(json.dumps({"probe": "banded_dtw", "rows": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
