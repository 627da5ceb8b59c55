#!/usr/bin/env python3
"""What holds the int8 bin matmul (``csrc/fft_binmm_int8.cu``, kernel 6)
back: time it beside variants of its own source on one NVIDIA GPU
(H100).

    python3 probe_fft_binmm_int8.py [VARIANT ...]

The variants are built from the source in the checkout, each with one
of the source's probe switches (``-D``; all of them, or those named),
into ``template_speech_recognition_tpu_torch/_build/probe/``:

* ``as_is``: the kernel the port launches (64 x 256 tiles, W2's second
  half first and the imaginary sums negated in registers at the seam);
* ``reg_a``: no seam: the imaginary warpgroup takes -Xr from registers
  (negated by ``__vsub4``), ``wgmma`` with A from registers;
* ``bn128``: 64 x 128 tiles (8 template tiles at K 1024 instead of 4);
* ``cluster3``: clusters of three row slabs, each W2 tile multicast by
  TMA to the three (a third of the W2 reads from L2 a CTA);
* ``no_store``: the epilogue stores nothing (the main loop alone);
* ``no_w``: no W2 tile is loaded (the Xr, Xi loads and the wgmmas).

The last two compute garbage and are not checked.  Every other variant
is held bitwise against ``fft_binmm_int8_plain`` at ragged shapes (2m
not a multiple of 64, K not of 256, D = 8, 40, 504, 2048), at +-127
inputs with 2D = 4096, and at the scan's shape (bins 80, m 192, D 2048,
K 1024), where two launches must be bitwise equal.  Then each is timed
with ``chip_smoke.time_ms`` over loops of 100 launches at the scan's
shape and at the log-mel D = 504, ``as_is`` first and last.  Inputs are
uniform int8 in [-127, 127] from seed 0, the rows padded to 16 bytes as
the scorer writes them.  Each variant runs in a process of its own
under a time limit, so a variant that hangs is reported, not waited
for.  Prints the card's name and power limit, one line a variant and
one JSON line.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import card_line, time_ms

BINS, M, K, SEED = 80, 192, 1024, 0
WIDTHS = (2048, 504)
RAGGED = ((3, 50, 40, 136), (2, 65, 504, 264), (1, 1, 8, 8), (2, 97, 2048, 1032),
          (3, 33, 8, 264), (1, 100, 40, 8))
FLAGS = {
    "as_is": [],
    "reg_a": ["-DBINMM_REG_A"],
    "bn128": ["-DBINMM_BN=128"],
    "cluster3": ["-DBINMM_CLUSTER=3"],
    "no_store": ["-DBINMM_NO_STORE"],
    "no_w": ["-DBINMM_NO_W"],
}
UNCHECKED = ("no_store", "no_w")
ROOT = Path(__file__).resolve().parent


def build(_cuda, names):
    """One nvcc per variant, all started together; returns {name:
    path}, printing each build's registers and spills."""
    src = _cuda.CSRC / "fft_binmm_int8.cu"
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        so = out / f"libbinmm8_{name}.so"
        paths[name] = so
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *FLAGS[name], "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        for line in log.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    return paths


def operands(torch, bins, m, d, k, seed, full=False):
    """int8 xr, xi [bins, m, D] as views of rows padded to 16 bytes,
    W2 [bins, 2D, K], its K-major copy and sc [bins, K]."""
    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
        int8_row_width,
        kmajor_spectra,
    )
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.zeros((2, bins, m, int8_row_width(d)), dtype=torch.int8, device=dev)
    if full:
        # +-127 everywhere; templates 0..63 align with row 0 of each bin,
        # whose real sum then meets its bound 2D x 127^2
        sign = torch.rand(2, bins, m, d, device=dev, generator=g) < 0.5
        buf[..., :d] = torch.where(sign, 127, -127).to(torch.int8)
        w2 = torch.where(torch.rand(bins, 2 * d, k, device=dev, generator=g) < 0.5,
                         127, -127).to(torch.int8)
        row0 = torch.cat([buf[0, :, 0, :d], buf[1, :, 0, :d]], dim=1)      # [bins, 2D]
        w2[:, :, : min(k, 64)] = row0[:, :, None]
    else:
        buf[..., :d] = torch.randint(-127, 128, (2, bins, m, d), dtype=torch.int8, device=dev,
                                     generator=g)
        w2 = torch.randint(-127, 128, (bins, 2 * d, k), dtype=torch.int8, device=dev,
                           generator=g)
    sc = torch.rand(bins, k, device=dev, generator=g) * 1e-4
    return buf[0, ..., :d], buf[1, ..., :d], w2, kmajor_spectra(w2), sc


def run_variant(name: str, so: str) -> dict:
    """Check (unless the variant computes garbage) and time one variant."""
    import torch

    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import (
        fft_binmm_int8_plain,
    )

    lib = ctypes.CDLL(so)
    fn = lib.tsr_fft_binmm_int8
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(xr, xi, w2t, sc, out):
        bins, m, d = xr.shape
        err = fn(xr.data_ptr(), xi.data_ptr(), w2t.data_ptr(), sc.data_ptr(), out.data_ptr(),
                 xr.stride(1), xr.stride(0), bins, m, d, w2t.shape[3], w2t.shape[2],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    def empty(bins, m, k):
        return torch.empty((2, bins, m, k), dtype=torch.bfloat16, device="cuda")

    row = {"variant": name}
    if name not in UNCHECKED:
        cases = [(s, False) for s in RAGGED] + [((2, 64, 2048, 128), True)]
        for i, ((bins, m, d, k), full) in enumerate(cases):
            xr, xi, w2, w2t, sc = operands(torch, bins, m, d, k, SEED + 1 + i, full)
            got = call(xr, xi, w2t, sc, empty(bins, m, k))
            if not torch.equal(got, fft_binmm_int8_plain(xr, xi, w2, sc)):
                raise RuntimeError(f"{name}: not bitwise at {(bins, m, d, k)}, full {full}")
        row["ragged"] = f"bitwise at {len(cases)} shapes"
    for d in WIDTHS:
        xr, xi, w2, w2t, sc = operands(torch, BINS, M, d, K, SEED)
        out = empty(BINS, M, K)
        if name not in UNCHECKED:
            got = call(xr, xi, w2t, sc, out).clone()
            if not torch.equal(got, fft_binmm_int8_plain(xr, xi, w2, sc)):
                raise RuntimeError(f"{name}: not bitwise at D = {d}")
            if not torch.equal(call(xr, xi, w2t, sc, out), got):
                raise RuntimeError(f"{name}: two launches differ at D = {d}")
            del got
        row[f"d{d}_ms"] = time_ms(torch, lambda: call(xr, xi, w2t, sc, out), loop=100)
        del xr, xi, w2, w2t, sc, out
        torch.cuda.empty_cache()
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_fft_binmm_int8: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(FLAGS)
    unknown = [n for n in names if n not in FLAGS]
    if unknown:
        print(f"probe_fft_binmm_int8: unknown variants {unknown}", file=sys.stderr)
        return 2
    card = card_line()
    paths = build(_cuda, names)
    order = names + (["as_is"] if names[0] == "as_is" and len(names) > 1 else [])
    rows, failed = [], []
    for name in order:
        try:
            proc = subprocess.run([sys.executable, __file__, "--one", name, str(paths[name])],
                                  capture_output=True, text=True, timeout=240, cwd=ROOT)
        except subprocess.TimeoutExpired:
            failed.append(f"{name}: no result within 240 s")
            print(f"[{card}] {name}: no result within 240 s", flush=True)
            continue
        if proc.returncode != 0:
            failed.append(f"{name}: exit {proc.returncode}: {proc.stderr.strip()[-2000:]}")
            print(f"[{card}] {name}: exit {proc.returncode}\n{proc.stderr.strip()[-2000:]}",
                  flush=True)
            continue
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"[{card}] " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                        for k, v in row.items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "unit": "ms", "shape": {"bins": BINS, "m": M, "K": K,
                                                            "D": list(WIDTHS)},
                      "loop": 100, "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
