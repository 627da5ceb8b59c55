#!/usr/bin/env python3
"""What holds binarize + spread (``csrc/binspread.cu``, kernel 9) back:
time it at other tile heights on one NVIDIA GPU (H100).

    python3 probe_binspread.py [VARIANT ...]

The source is built from the checkout into
``template_speech_recognition_tpu_torch/_build/probe/`` as it is
(``tb64``: tiles of up to 64 rows, 384 blocks at the log-mel scan's
planes, one wave) and with ``-DBINSPREAD_MAX_TB=32`` (``tb32``) and
``=16`` (``tb16``): more, smaller blocks, so that one block's loads
overlap another's bit work and stores.  Each variant runs in a process
of its own under a 240 s limit: held bitwise to
``binarize_freqspread_plain`` at rt 0 and 1 on random normal plane-major
planes [4, 8, 3072, 63] (a [B, P] view, 2997 valid frames, the
statistics of the layered select at q 0.98, rf 1, seed 0), then timed
with ``chip_smoke.time_ms`` over loops of 100 calls at rt 0 and rt 1,
``tb64`` first and last.  Prints the card's name and power limit, one
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

BUILDS = {"tb64": [], "tb32": ["-DBINSPREAD_MAX_TB=32"], "tb16": ["-DBINSPREAD_MAX_TB=16"]}
B, P, T_PAD, F, VALID, QUANTILE = 8, 4, 3072, 63, 2997, 0.98
ROOT = Path(__file__).resolve().parent


def build(_cuda, names):
    """One nvcc per variant, all started together; returns {name: path}."""
    src = _cuda.CSRC / "binspread.cu"
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        paths[name] = out / f"libbinspread_{name}.so"
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *BUILDS[name], "-o", str(paths[name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
    return paths


def run_variant(name: str, so: str) -> dict:
    import torch

    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import binspread_kernel as k9

    lib = ctypes.CDLL(so)
    lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tsr_cuda_error_string.restype = ctypes.c_char_p
    _cuda._LIBS[k9.NAME] = lib                     # the wrapper launches this build
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn(P, B, T_PAD, F, device=dev, generator=g).transpose(0, 1)
    valid = torch.full((B,), VALID, dtype=torch.int32, device=dev)
    hi, lo = (x.contiguous() for x in fp.plane_order_statistics(planes, valid, QUANTILE))
    row = {"variant": name}
    for rt in (0, 1):
        args = (planes, hi, lo, valid, 1, rt)
        if not torch.equal(k9.binarize_freqspread(*args), k9.binarize_freqspread_plain(*args)):
            raise RuntimeError(f"{name}: not bitwise at rt {rt}")
        row[f"rt{rt}_loop100_ms"] = time_ms(torch, lambda args=args: k9.binarize_freqspread(*args),
                                            loop=100)
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_binspread: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(BUILDS)
    unknown = [n for n in names if n not in BUILDS]
    if unknown:
        print(f"probe_binspread: unknown variants {unknown}", file=sys.stderr)
        return 2
    card = card_line()
    paths = build(_cuda, names)
    order = names + (["tb64"] if names[0] == "tb64" and len(names) > 1 else [])
    rows, failed = [], []
    for name in order:
        try:
            proc = subprocess.run([sys.executable, __file__, "--one", name, str(paths[name])],
                                  capture_output=True, text=True, timeout=240, cwd=ROOT)
        except subprocess.TimeoutExpired:
            failed.append(f"{name}: no result within 240 s")
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
    print(json.dumps({"card": card, "unit": "ms", "loop": 100, "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
