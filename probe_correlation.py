#!/usr/bin/env python3
"""What holds the direct correlation kernel (``csrc/correlation.cu``,
kernel 10) back: time it beside one-edit variants of its own source on
one NVIDIA GPU (H100).

    python3 probe_correlation.py [VARIANT ...]

The variants are built from the source in the checkout, one edit each
(``stream_f`` two; all of them, or those named), into
``template_speech_recognition_tpu_torch/_build/probe/``:

* ``as_is``: the kernel the port launches (128 x 192 tiles, each
  64-column slice of the frames resident as a panel that serves 32
  shifts, a 10-slot W ring);
* ``bn256``: 128 x 256 tiles (12 t-tiles at T'' = 2969 instead of 16);
* ``stream_f``: no resident panel: every step loads its own 192 frames
  (one shift a panel, six panel slots), as a GEMM with both operands
  streaming from L2 would;
* ``ring4``: a 4-slot W ring instead of 10;
* ``no_store``: the epilogue stores nothing (the main loop alone);
* ``no_w``: no W box is loaded (the panels and the wgmmas alone).

The last two compute garbage and are not checked.  Every other
variant is held against ``correlation_scores_plain`` within 1e-5 x
max|plain| at ragged shapes (D = 40, 504, 2048; T'' not a multiple of
the tile; K = 1, 3, 129; L = 1, 9, 48, T), with an all-zero utterance
that must score c exactly, and at the bench shape, where two launches
must be bitwise equal.  Then each is timed with CUDA events (median of
10 after 2 warm-ups) at the reference's bench shape (B 8, T 3000, K
1024, L 32, D 2048: random binary bf16 maps at 0.2 density, a random
bf16 bank, seed 0) and at one utterance (B 1), ``as_is`` first and last,
beside ``conv1d`` in bf16.  Each variant runs in a process of its own
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

B, T, K, L, D, DENSITY, SEED = 8, 3000, 1024, 32, 2048, 0.2, 0
RAGGED = ((1, 77, 40, 3, 9), (3, 250, 504, 129, 9), (1, 60, 2048, 1, 9), (2, 48, 64, 5, 48),
          (1, 200, 504, 3, 1), (3, 230, 40, 1, 48), (2, 257, 2048, 129, 32), (2, 31, 8, 2, 31))
_EXPECT_W = ("mbar_expect_tx(full(s), A_BYTES);\n"
             "            tma_load_3d(a_s(s), &map_w, full(s), dc * BK, tau, k0);")
EDITS = {
    "as_is": [],
    "bn256": [("constexpr int BN = 192;", "constexpr int BN = 256;")],
    "stream_f": [("constexpr int TAU_GROUP = 32;", "constexpr int TAU_GROUP = 1;"),
                 ("constexpr int PANELS = 2;", "constexpr int PANELS = 6;")],
    "ring4": [("constexpr int STAGES = (232448 - 1024 - PANELS * PANEL_BYTES - 512) / A_BYTES;",
               "constexpr int STAGES = 4;")],
    "no_store": [("if (k >= K) continue;", "if (k >= 0) continue;")],
    "no_w": [(_EXPECT_W, "mbar_expect_tx(full(s), 0);")],
}
UNCHECKED = ("no_store", "no_w")
ROOT = Path(__file__).resolve().parent


def build(_cuda, names):
    """One nvcc per variant not yet built, all started together;
    returns {name: path}, printing each build's registers and spills."""
    src = (_cuda.CSRC / "correlation.cu").read_text()
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        text = src
        for old, new in EDITS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit does not apply to correlation.cu")
            text = text.replace(old, new)
        cu, so = out / f"corr_{name}.cu", out / f"libcorr_{name}.so"
        paths[name] = so
        if so.exists() and cu.exists() and cu.read_text() == text:
            continue
        cu.write_text(text)
        procs[name] = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
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
    import torch

    from template_speech_recognition_tpu_torch.ops.correlation_kernel import (
        correlation_scores_plain,
    )

    lib = ctypes.CDLL(so)
    fn = lib.tsr_correlation
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")

    def call(x, w, c, out):
        err = fn(x.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), x.shape[0],
                 x.shape[1], x.shape[2], w.shape[0], w.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    def inputs(b, t, d, k, length, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = (torch.rand(b, t, d, device=dev, generator=g) < DENSITY).to(torch.bfloat16)
        w = torch.randn(k, length, d, device=dev, generator=g).to(torch.bfloat16)
        c = torch.randn(k, device=dev, generator=g)
        return x, w, c, torch.empty((b, k, t - length + 1), device=dev)

    row = {"variant": name}
    if name not in UNCHECKED:
        worst = 0.0
        for i, (b, t, d, k, length) in enumerate(RAGGED):
            x, w, c, out = inputs(b, t, d, k, length, SEED + 1 + i)
            if b > 1:
                x[-1] = 0
            got = call(x, w, c, out)
            want = correlation_scores_plain(x, w, c)
            err = float((got - want).abs().max()) / float(want.abs().max())
            worst = max(worst, err)
            if not err <= 1e-5:
                raise RuntimeError(f"{name}: {err} x max|plain| at {(b, t, d, k, length)}")
            if b > 1 and not torch.equal(got[-1], c[:, None].expand_as(got[-1])):
                raise RuntimeError(f"{name}: an all-zero utterance does not score c")
        row["ragged_err"] = worst
    x, w, c, out = inputs(B, T, D, K, L, SEED)
    xt, wt = x.transpose(1, 2).contiguous(), w.transpose(1, 2).contiguous()
    if name not in UNCHECKED:
        got = call(x, w, c, out).clone()
        want = correlation_scores_plain(x, w, c)
        row["bench_err"] = float((got - want).abs().max()) / float(want.abs().max())
        if not row["bench_err"] <= 1e-5:
            raise RuntimeError(f"{name}: {row['bench_err']} x max|plain| at the bench shape")
        if not torch.equal(call(x, w, c, out), got):
            raise RuntimeError(f"{name}: two launches differ")
        del got, want
    row["bench_ms"] = time_ms(torch, lambda: call(x, w, c, out))
    row["conv1d_ms"] = time_ms(torch, lambda: torch.nn.functional.conv1d(xt, wt))
    x1, out1 = x[:1].contiguous(), out[:1].contiguous()
    xt1 = xt[:1].contiguous()
    row["b1_ms"] = time_ms(torch, lambda: call(x1, w, c, out1))
    row["b1_conv1d_ms"] = time_ms(torch, lambda: torch.nn.functional.conv1d(xt1, wt))
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_correlation: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(EDITS)
    unknown = [n for n in names if n not in EDITS]
    if unknown:
        print(f"probe_correlation: unknown variants {unknown}", file=sys.stderr)
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
    print(json.dumps({"card": card, "unit": "ms", "shape": {"B": B, "T": T, "K": K, "L": L,
                                                            "D": D}, "rows": rows,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
