#!/usr/bin/env python3
"""Where the cluster variant of kernel 2 (``csrc/select_binspread.cu``,
``selbin_cluster``) spends its time: time it beside variants of its own
source that stop after each phase, on one NVIDIA GPU (H100).

    python3 probe_select_binspread.py

The variants are built from the source in the checkout with one edit
each, into ``template_speech_recognition_tpu_torch/_build/probe/``:

* ``as_is``: the kernel the port launches (persistent: each resident
  cluster walks the pairs, loading the next plane while it writes the
  current map);
* ``one_pair``: one cluster a pair, no overlap; the variants below
  start from it:
* ``load``: each CTA loads its rows with the bulk copies and returns;
* ``level0``: ... then turns them into keys and counts the top digits;
* ``select``: ... then runs the four radix levels across the cluster
  and returns;
* ``select_nocount``: ``select`` with levels 1-3 counting nothing (the
  cluster barriers, DSMEM sums and digit picks alone);
* ``no_compact``: levels 1-3 count from every key, not from the
  level-1 candidates;
* ``no_store``: everything but the map's global stores;
* ``nt512``: the kernel with 512 threads a CTA instead of 1,024.

Only ``as_is`` writes a map; it is held bitwise against
``select_binspread_plain`` first.  Each variant is timed with
``chip_smoke.time_ms`` over loops of 100 launches at the scan's bench
shape (P 4, B 8, T 3072, F 256, q 0.98, rf = rt = 1) on two inputs:
random normal planes with 2998 valid frames, and the default scan's
own planes of its first batch (kernel 1 on ``chip_smoke.py``'s 8
synthetic utterances of 30 s); ``as_is`` first and last.  Prints the
card's name and power limit, ``cudaOccupancyMaxActiveClusters`` and one
JSON line.  Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

P, B, T, F, VALID, Q, RF, RT = 4, 8, 3072, 256, 2998, 0.98, 1, 1
ONE_PAIR = ("min(P * B, clusters)", "P * B")
RET3 = ("    // 3. four 8-bit levels:", "    return;\n    // 3.")
SELECTED = ("    const uint32_t v_hi = st[0], v_lo = st[3];",
            "    cluster.sync();\n    return;\n    const uint32_t v_hi = st[0], v_lo = st[3];")
WAITED = "        phase ^= 1u << c;\n"
EDITS = {
    "as_is": [],
    "one_pair": [ONE_PAIR],
    "load": [ONE_PAIR, (WAITED, WAITED + "        continue;\n"), RET3],
    "level0": [ONE_PAIR, RET3],
    "select": [ONE_PAIR, SELECTED],
    "select_nocount": [ONE_PAIR, SELECTED, ("      if (level > 0) {", "      if (level > 99) {")],
    "no_compact": [ONE_PAIR, ("          if (level >= 2 || !wide) {", "          if (false) {")],
    "no_store": [ONE_PAIR, ("        uint8_t* dst = dst_row", "        if (word != 0x12345678u) continue;\n"
                            "        uint8_t* dst = dst_row")],
    "nt512": [("constexpr int NT = 1024;", "constexpr int NT = 512;")],
}


def build(_cuda):
    """One nvcc per variant, all started together -> {name: library}."""
    src = (_cuda.CSRC / "select_binspread.cu").read_text()
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit does not apply to select_binspread.cu")
            text = text.replace(old, new)
        cu, so = out / f"selbin_{name}.cu", out / f"libselbin_{name}.so"
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
        lib.tsr_selbin_cluster.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.tsr_selbin_cluster.restype = ctypes.c_int
        libs[name] = lib
    return libs


def scan_planes(torch, dev):
    """The default scan's planes [4, B, T_pad, F] of its first batch
    (kernel 1 on ``chip_smoke.py``'s first 8 utterances of 30 s) and
    their valid frames."""
    from chip_smoke import SECONDS, SEED, Corpus
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.scan import bucket_length

    fcfg = C.PipelineConfig().frontend
    corpus = Corpus(SEED)
    n = int(SECONDS * corpus.sample_rate)
    wavs = torch.zeros((B, bucket_length(n)), dtype=torch.float32)
    for i, (_u, w, _p) in enumerate(corpus.utts[:B]):
        wavs[i, : len(w)] = torch.from_numpy(w)
    frames = fp._windowed_frames(wavs.to(dev), fcfg)
    planes = fp._stacked_planes(frames, fcfg, plain=False).reshape(P, B, -1, F)
    valid = torch.full((B,), (n - fcfg.frame_length) // fcfg.hop_length, dtype=torch.int32,
                       device=dev)
    if planes.shape[2] != T:
        raise RuntimeError(f"the scan's planes have {planes.shape[2]} rows, not {T}")
    return planes.contiguous(), valid


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_select_binspread: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line, time_ms
    from template_speech_recognition_tpu_torch.frontend.planes import _dual_ranks
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import selbin_kernel as k2

    card = card_line()
    dev = torch.device("cuda")
    libs = build(_cuda)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {
        "random": (torch.randn(P, B, T, F, device=dev, generator=gen),
                   torch.full((B,), VALID, dtype=torch.int32, device=dev)),
        "scan": scan_planes(torch, dev),
    }
    result = {"card": card, "unit": "ms", "shape": [P, B, T, F],
              "max_active_clusters": k2.max_active_clusters()}
    for label, (planes, valid) in inputs.items():
        need = _dual_ranks(valid, F, Q)
        flat = torch.empty((B, T, 2 * P * F), dtype=torch.uint8, device=dev)
        keys = torch.empty((B, P, 2), dtype=torch.int64, device=dev)

        def call(lib):
            err = lib.tsr_selbin_cluster(planes.data_ptr(), need.data_ptr(), valid.data_ptr(),
                                         flat.data_ptr(), keys.data_ptr(), P, B, T, F, RF, RT,
                                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        call(libs["as_is"])
        ref_flat, ref_keys = k2.select_binspread_plain(planes, need, valid, RF, RT)
        torch.cuda.synchronize()
        if not (torch.equal(flat, ref_flat) and torch.equal(keys, ref_keys)):
            print(f"probe_select_binspread: as_is is not bitwise the plain version ({label})",
                  file=sys.stderr)
            return 1
        row = result[label] = {}
        for name in (*EDITS, "as_is_again"):
            lib = libs[name.replace("_again", "")]
            row[name] = time_ms(torch, lambda lib=lib: call(lib), loop=100)
        print(f"[{card}] {label} planes: " + ", ".join(
            f"{n} {row[n]:.4f}" for n in (*EDITS, "as_is_again")) + " ms", flush=True)
    print(f"[{card}] max_active_clusters {result['max_active_clusters']}", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
