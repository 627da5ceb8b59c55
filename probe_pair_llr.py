#!/usr/bin/env python3
"""What holds the pair-LLR tiles (``csrc/pair_llr.cu``, kernel 11) back:
time the port's kernel with its pairs in three orders on one NVIDIA
GPU (H100).

    python3 probe_pair_llr.py [VARIANT ...]

The source is built from the checkout into
``template_speech_recognition_tpu_torch/_build/probe/``.  The variants
(all of them, or those named):

* ``as_is``: the kernel (one block of 4 warps a pair, its filter rows
  and window staged through a ring of 3 cp.async stages of 128 d) on
  the pairs in the caller's order;
* ``sorted_by_id``: the pairs in the order of a stable sort by template
  id, so that the pairs of one template run side by side and their
  filter meets in L2;
* ``sorted_by_row``: the pairs in the order of the windows' first rows,
  so that overlapping windows read their shared rows from L2.

Variants measured and dropped (the first port's per-pair kernel, a
resident walk of runs of one template, groups of one template's pairs a
block, the ring at other depths and occupancies) are recorded in
PERF.md, section 6.

The two sorted orders permute the pairs once with ``torch.argsort``,
outside the timed loop (the tiles then come out in that order): they
measure the order's effect on the memory traffic, not the cost of
sorting.  Every variant is held to ``pair_llr_plain`` within
1e-5 x max|ref| at 4 ragged shapes (windows into the next utterance and
past the map's end, ids out of range, L 6 / 40, D 64 / 504 / 2048, one
id for all pairs) and at the timed shapes: the verify-the-winner
rescore of the smoke test's scans (B 8, T_pad 3072, 123 peaks an
utterance at random frames below 2998, random ids of K = 1024 templates
of L = 32, m = 40) at D = 2048 (``d2048``) and at the log-mel D = 504
(``d504``), and at D = 2048 with the ids drawn from 42 templates
(``skew``: the DTW scan's winners name 42), on random maps of 0.15
density and random bf16 filters.  Each is timed with
``chip_smoke.time_ms`` over loops of 100 calls, ``as_is`` first and
last, beside its bound (each distinct map row and filter read once,
the tiles written once); a ``torch.profiler`` trace gives the median
device time of a call.  Each variant runs in a process of its own
under a 240 s limit.  Prints the card's name and power limit, one line
a variant and one JSON line.  Needs one CUDA device; exits 2 without
one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import HBM_BPS, SEED, card_line, time_ms
from probe_radix_select import breakdown

# variant -> the order of the pairs
VARIANTS = {"as_is": "pairs", "sorted_by_id": "by_id", "sorted_by_row": "by_row"}
# (B, T, D, K, L, m, N, one id for all)
RAGGED = ((2, 50, 64, 5, 6, 16, 7, False), (3, 40, 504, 4, 40, 48, 9, False),
          (2, 40, 2048, 30, 32, 40, 50, False), (2, 60, 504, 7, 32, 40, 33, True))
B, T_PAD, VALID, TOP_K, K, L, M = 8, 3072, 2998, 123, 1024, 32, 40
ROOT = Path(__file__).resolve().parent


def build(_cuda):
    """The source built as it is (one nvcc); returns its path, printing
    its kernels' registers and spills."""
    src = _cuda.CSRC / "pair_llr.cu"
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libpair_llr_probe.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
            print(f"ptxas: {line.strip()}", flush=True)
    return so


def launcher(torch, lib):
    """bind(feats, w, rowstart, ids, m) -> a call that launches the
    kernel on those operands and returns its output."""
    from template_speech_recognition_tpu_torch.ops import _cuda

    fn = _cuda.declare(lib, "tsr_pair_llr", 5, 6)

    def bind(feats, w, rowstart, ids, m):
        b, t, d = feats.shape
        k, length, _ = w.shape
        n = rowstart.shape[0]
        dev = feats.device
        ptrs = [_cuda.ptr(feats), _cuda.ptr(w), _cuda.ptr(rowstart), _cuda.ptr(ids)]

        def call():
            out = torch.empty((n, length, m), dtype=torch.float32, device=dev)
            err = fn(*ptrs, _cuda.ptr(out), b * t, n, k, length, d, m, _cuda.stream_ptr(dev))
            _cuda.check(lib, err, "pair_llr")
            return out

        return call

    return bind


def ordered(torch, args, how):
    """The operands with their pairs in the variant's order."""
    feats, w, rowstart, ids, m = args
    if how == "pairs":
        return args
    by = ids.long().clamp(0, w.shape[0] - 1) if how == "by_id" else rowstart.long()
    perm = torch.argsort(by, stable=True)
    return feats, w, rowstart[perm].contiguous(), ids[perm].contiguous(), m


def scan_pairs(torch, dev, d, seed, n_ids=K):
    """The verify-the-winner rescore's operands at the smoke test's shape
    and width d, the ids drawn from n_ids templates, and the least bytes
    of the call."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    fmap = torch.rand(B, T_PAD, d, device=dev, generator=g) < 0.15
    w16 = torch.randn(K, L, d, device=dev, generator=g).to(torch.bfloat16)
    times = torch.from_numpy(rng.integers(0, VALID, (B, TOP_K))).to(dev)
    named = rng.permutation(K)[:n_ids]
    ids = torch.from_numpy(named[rng.integers(0, n_ids, B * TOP_K)].astype(np.int32)).to(dev)
    rowstart = (torch.arange(B, device=dev)[:, None] * T_PAD + times).reshape(-1)
    rowstart = rowstart.to(torch.int32)
    rows = rowstart.long()[:, None] + torch.arange(M, device=dev)
    covered = torch.zeros(B * T_PAD, dtype=torch.bool, device=dev)
    covered[rows[rows < B * T_PAD]] = True
    n_rows, n_ids = int(covered.sum()), int(torch.unique(ids).numel())
    nbytes = n_rows * d + n_ids * L * d * 2 + rowstart.numel() * 8 + B * TOP_K * L * M * 4
    return (fmap, w16, rowstart, ids, M), nbytes, n_rows, n_ids


def run_variant(name: str, so: str) -> dict:
    """Check and time one variant."""
    import numpy as np
    import torch

    from template_speech_recognition_tpu_torch.ops import pair_llr_kernel as kp

    lib = ctypes.CDLL(so)
    lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tsr_cuda_error_string.restype = ctypes.c_char_p
    bind = launcher(torch, lib)
    how = VARIANTS[name]
    dev = torch.device("cuda")

    def close(args, label):
        got = bind(*args)()
        want = kp.pair_llr_plain(*args)
        torch.cuda.synchronize()
        err, top = float((got - want).abs().max()), float(want.abs().max())
        if not err <= 1e-5 * top:
            raise RuntimeError(f"{name}: {label}: max error {err} > 1e-5 x {top}")
        return err, top

    rng = np.random.default_rng(SEED + 3)
    for bb, tt, dd, kk, length, mm, n, same in RAGGED:
        fmap = torch.from_numpy(rng.random((bb, tt, dd)) < 0.3).to(dev)
        wq = torch.randn(kk, length, dd, device=dev).to(torch.bfloat16)
        rs = rng.integers(-2, bb * tt + 3, n).astype(np.int32)
        rs[:3] = (bb * tt - 1, bb * tt - 9, tt - 4)
        ids = np.full(n, 2, np.int32) if same else rng.integers(-2, kk + 3, n).astype(np.int32)
        close(ordered(torch, (fmap, wq, torch.from_numpy(rs).to(dev),
                              torch.from_numpy(ids).to(dev), mm), how),
              f"B {bb}, T {tt}, D {dd}, K {kk}, L {length}, m {mm}, N {n}")
    row = {"variant": name, "ragged": f"within 1e-5 at {len(RAGGED)} shapes"}
    for tag, d, named in (("d2048", 2048, K), ("d504", 504, K), ("skew", 2048, 42)):
        args, nbytes, n_rows, n_ids = scan_pairs(torch, dev, d, SEED + d, named)
        args = ordered(torch, args, how)
        err, top = close(args, f"the scan's shape at D {d}, ids of {named} templates")
        call = bind(*args)
        ms = time_ms(torch, call, loop=100)
        bound = nbytes / HBM_BPS * 1e3
        row.update({f"{tag}_err": err, f"{tag}_loop100_ms": ms, f"{tag}_bound_ms": bound,
                    f"{tag}_share": bound / ms, f"{tag}_rows": n_rows, f"{tag}_ids": n_ids})
        row.update({f"{tag}_{k}": v for k, v in breakdown(torch, call).items()
                    if k != "ops"})
        del args, call
        torch.cuda.empty_cache()
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_pair_llr: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"probe_pair_llr: unknown variants {unknown}", file=sys.stderr)
        return 2
    card = card_line()
    so = str(build(_cuda))
    order = names + (["as_is"] if names[0] == "as_is" and len(names) > 1 else [])
    rows, failed = [], []
    for name in order:
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
    print(json.dumps({"card": card, "unit": "ms", "loop": 100, "rows": rows,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
