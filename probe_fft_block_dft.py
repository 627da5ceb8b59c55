#!/usr/bin/env python3
"""What holds the block DFT (``csrc/fft_block_dft.cu``, kernel 3) back:
time it beside variants of its own source and of its plan on one NVIDIA
GPU (H100).

    python3 probe_fft_block_dft.py [VARIANT ...]

The source is built three times from the checkout into
``template_speech_recognition_tpu_torch/_build/probe/``: as it is, with
``-DDFT_NO_STORE`` and with ``-DDFT_NO_X``.  The variants (all of them,
or those named):

* ``as_is``: the kernel the port launches, with the wrapper's plan
  (128 d columns a block, one run of 24 windows a tile at D 2048, runs
  of 6 at D 504);
* ``no_store``: no TMA stores (the loads, the wgmmas and the staging);
* ``no_x``: no x loads (the basis, the wgmmas and the stores);
* ``run1``: runs of one window (a block a window; the basis loaded for
  each);
* ``run4``: runs of four windows;
* ``wgs1``: 64 d columns a block (one consumer warpgroup), the runs the
  wrapper's rule gives them.

``no_store`` and ``no_x`` compute garbage and are not checked.  Every
other variant is held within one bf16 step (2^-7 x max|ref|) of
``fft_block_dft_plain`` at ragged shapes (three utterances whose last
window overruns T, D 504 and 40, nfft 159, 39, 223 and 319) and at the
scan's shape (B 8, T 3072, D 2048, nfft 159, hop 128, 24 windows),
where two launches must be bitwise equal.  Then each is timed with
``chip_smoke.time_ms`` over loops of 100 launches at the scan's shape
and at the log-mel D = 504, ``as_is`` first and last.  Inputs are
random binary maps at 0.15 density from seed 0.  Each variant runs in
a process of its own under a time limit, so a variant that hangs is
reported, not waited for.  Prints the card's name and power limit, one
line a variant and one JSON line.  Needs one CUDA device; exits 2
without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import card_line, time_ms

B, T, NFFT, LENGTH, SEED = 8, 3072, 159, 32, 0
WIDTHS = (2048, 504)
RAGGED = ((300, 504, 32, 1024), (250, 40, 8, 128), (500, 40, 32, 4096), (700, 504, 64, 1024))
BUILDS = {"as_is": [], "no_store": ["-DDFT_NO_STORE"], "no_x": ["-DDFT_NO_X"]}
# variant -> (build, plan overrides)
VARIANTS = {
    "as_is": ("as_is", {}),
    "no_store": ("no_store", {}),
    "no_x": ("no_x", {}),
    "run1": ("as_is", {"run": 1}),
    "run4": ("as_is", {"run": 4}),
    "wgs1": ("as_is", {"wgs": 1}),
}
UNCHECKED = ("no_store", "no_x")
ROOT = Path(__file__).resolve().parent


def build(_cuda, names):
    """One nvcc per build the variants need, all started together;
    returns {build: path}, printing each build's registers and spills."""
    src = _cuda.CSRC / "fft_block_dft.cu"
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in sorted({VARIANTS[n][0] for n in names}):
        so = out / f"libblockdft_{name}.so"
        paths[name] = so
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *BUILDS[name], "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        for line in log.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    return paths


def run_variant(name: str, so: str) -> dict:
    """Check (unless the variant computes garbage) and time one variant."""
    import numpy as np
    import torch

    from template_speech_recognition_tpu_torch.detect.fft_scorer import _dft_mats, pick_nfft
    from template_speech_recognition_tpu_torch.ops import fft_dft_kernel as k3

    over = VARIANTS[name][1]
    lib = ctypes.CDLL(so)
    fn = lib.tsr_fft_block_dft
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def operands(b, t, d, length, bank_k, seed):
        nfft = pick_nfft(length, bank_k)
        hop = nfft - length + 1
        nblk = -(-(t - length + 1) // hop)
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.random((b, t, d)) < 0.15).to(dev, torch.bfloat16)
        cm, sm = _dft_mats(nfft, torch.bfloat16, dev)
        return x, torch.cat([cm, -sm], dim=1).contiguous(), nfft, hop, nblk

    def caller(x, g, nfft, hop, nblk):
        b, t, d = x.shape
        bins = g.shape[1] // 2
        p = k3.plan(b, d, nfft, nblk, bins, sms, **over)
        gt = k3.padded_basis(g, nfft, p.bp, p.kp)
        xr = torch.empty((bins, b, nblk, d), dtype=torch.bfloat16, device=dev)
        xi = torch.empty_like(xr)

        def call():
            err = fn(x.data_ptr(), gt.data_ptr(), xr.data_ptr(), xi.data_ptr(), b, t, d, hop,
                     nblk, bins, p.kp, p.kb, p.bp, p.n, p.passes, p.wgs, p.stages, p.run,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return xr, xi
        return call, p

    def close(x, g, nfft, hop, nblk, label):
        call, _ = caller(x, g, nfft, hop, nblk)
        got = [a.clone() for a in call()]
        ref = k3.fft_block_dft_plain(x, g, nfft, hop, nblk)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        top = max(float(r.float().abs().max()) for r in ref)
        if err > 2.0 ** -7 * top:
            raise RuntimeError(f"{name}: {err} > 2^-7 x {top} at {label}")
        return got, call

    row = {"variant": name}
    if name not in UNCHECKED:
        for i, (t, d, length, bank_k) in enumerate(RAGGED):
            close(*operands(3, t, d, length, bank_k, SEED + 1 + i), f"T {t}, D {d}, L {length}")
        row["ragged"] = f"within 2^-7 at {len(RAGGED)} shapes"
    for d in WIDTHS:
        ops = operands(B, T, d, LENGTH, 1024, SEED)
        if name not in UNCHECKED:
            got, call = close(*ops, f"D {d}")
            if not all(torch.equal(a, c) for a, c in zip(call(), got)):
                raise RuntimeError(f"{name}: two launches differ at D = {d}")
            del got
        else:
            call, _ = caller(*ops)
        row[f"d{d}_plan"] = str(caller(*ops)[1])
        row[f"d{d}_ms"] = time_ms(torch, call, loop=100)
        del ops, call
        torch.cuda.empty_cache()
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_fft_block_dft: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"probe_fft_block_dft: unknown variants {unknown}", file=sys.stderr)
        return 2
    card = card_line()
    paths = build(_cuda, names)
    order = names + (["as_is"] if names[0] == "as_is" and len(names) > 1 else [])
    rows, failed = [], []
    for name in order:
        so = str(paths[VARIANTS[name][0]])
        try:
            proc = subprocess.run([sys.executable, __file__, "--one", name, so],
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
    print(json.dumps({"card": card, "unit": "ms", "shape": {"B": B, "T": T, "nfft": NFFT,
                                                            "D": list(WIDTHS)},
                      "loop": 100, "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
