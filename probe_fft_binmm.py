#!/usr/bin/env python3
"""What holds the bf16 bin matmul (``csrc/fft_binmm.cu``) back: time it
beside three variants of its own source on one NVIDIA GPU (H100).

    python3 probe_fft_binmm.py

The variants are built from the source in the checkout with one edit
each, into ``template_speech_recognition_tpu_torch/_build/probe/``:

* ``as_is``: the kernel the port launches;
* ``no_store``: the epilogue stores nothing (the main loop alone; its
  output is garbage and is not checked);
* ``ring2``: a 2-stage ring instead of 4 (how much the ring's depth hides
  the loads);
* ``wait0``: each stage's ``wgmma`` batch retires before the next is
  issued (``wgmma.wait_group 0``, no overlap of consecutive batches).

Each variant but ``no_store`` is held against ``fft_binmm_plain`` at a
few ragged shapes (one bf16 step, 2^-7 x max|ref|), then each is timed
with CUDA events (median of 10 after 3 warm-ups, ``as_is`` first and
last) at the scan's shapes: bins 80, m 192 and the tail batch's 96, D
2048, and the log-mel D = 504, K 1024; ``torch.bmm`` on the packed
operand is the yardstick.  Prints the card's name and power limit and
one JSON line.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np

SHAPES = ((80, 192, 2048, 1024), (80, 96, 2048, 1024), (80, 192, 504, 1024))
EDITS = {
    "as_is": [],
    "no_store": [("        if (r < m) {\n", "        if (r < 0) {\n")],
    "ring2": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "wait0": [('"wgmma.wait_group.sync.aligned 1;\\n"', '"wgmma.wait_group.sync.aligned 0;\\n"')],
}


def build(_cuda):
    """One nvcc per variant, all started together -> {name: library}."""
    src = (_cuda.CSRC / "fft_binmm.cu").read_text()
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit does not apply to fft_binmm.cu")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.tsr_fft_binmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tsr_fft_binmm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(torch, lib):
    def call(xr, xi, w2, out):
        bins, m, d = xr.shape
        err = lib.tsr_fft_binmm(xr.data_ptr(), xi.data_ptr(), w2.data_ptr(), out.data_ptr(),
                                bins, m, d, w2.shape[2], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def time_ms(torch, fn, reps=10, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_fft_binmm: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops.fft_binmm_kernel import fft_binmm_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    calls = {name: launcher(torch, lib) for name, lib in build(_cuda).items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    for name, call in calls.items():
        if name == "no_store":
            continue
        for bins, m, d, k in ((3, 65, 504, 136), (1, 1, 8, 8), (3, 96, 40, 1024)):
            xr, xi, w2 = rnd(bins, m, d), rnd(bins, m, d), rnd(bins, 2 * d, k)
            out = torch.empty((2, 2, bins, m, k), dtype=torch.bfloat16, device=dev)
            got = call(xr, xi, w2, out)
            ref = fft_binmm_plain(xr, xi, w2)
            err = float((got.float() - ref.float()).abs().max())
            if not err <= 2.0 ** -7 * float(ref.float().abs().max()):
                print(f"probe_fft_binmm: {name} wrong at {(bins, m, d, k)}", file=sys.stderr)
                return 1
    result = {"card": card, "unit": "ms", "shapes": []}
    for bins, m, d, k in SHAPES:
        xr, xi, w2 = rnd(bins, m, d), rnd(bins, m, d), rnd(bins, 2 * d, k, scale=0.05)
        out = torch.empty((2, 2, bins, m, k), dtype=torch.bfloat16, device=dev)
        row = {"bins": bins, "m": m, "D": d, "K": k,
               "tflop": 2 * (2 * m) * (2 * d) * k * bins / 1e12}
        for name in ("as_is", "no_store", "ring2", "wait0"):
            row[name] = time_ms(torch, lambda c=calls[name]: c(xr, xi, w2, out))
        row["as_is_again"] = time_ms(torch, lambda: calls["as_is"](xr, xi, w2, out))
        x2 = torch.cat([torch.cat([xr, xi], 2), torch.cat([xi, -xr], 2)], 1)
        row["bmm"] = time_ms(torch, lambda: torch.bmm(x2, w2))
        del x2
        result["shapes"].append(row)
        print(f"[{card}] bins {bins} m {m} D {d} K {k}: " + ", ".join(
            f"{n} {row[n]:.4f}" for n in ("as_is", "no_store", "ring2", "wait0", "as_is_again",
                                          "bmm")) + " ms", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
