#!/usr/bin/env python3
"""What holds the radix select (``csrc/radix_select.cu``, kernel 8) back:
time it beside variants of its own source on one NVIDIA GPU (H100).

    python3 probe_radix_select.py [VARIANT ...]

The source is built from the checkout into
``template_speech_recognition_tpu_torch/_build/probe/`` as it is and
with the switches the variants need.  The variants (all of them, or
those named):

* ``as_is``: the kernel the port launches (digits of 11, 11 and 10
  bits, level 1 into one private histogram a warp, levels 2 and 3 and
  the last pick in the fourth launch, the wrapper's chunks);
* ``match``: level 1 into one histogram a block with warp-aggregated
  increments (``-DRADIX_L0_MATCH``: ``__match_any_sync``);
* ``half_batch``: as is on the first 4 utterances' planes (12.1 MB):
  whether a working set well inside L2 streams faster;
* ``level1_only``: the zeroing kernel and level 1 alone
  (``-DRADIX_LEVEL1_ONLY``);
* ``skip_level1``: levels 2 and 3 alone on empty level-1 counts
  (``-DRADIX_SKIP_LEVEL1``: they match no key, so they only stream the
  planes): whether the later levels read from L2.

Schedules measured and dropped (8-bit digits in four levels, the last
pick in a fifth launch, other chunks, eight loads in flight a thread)
are recorded in PERF.md, section 6, PR 13.

``level1_only`` and ``skip_level1`` compute garbage and are not checked.
Every other variant is held bitwise to ``radix_select_plain`` at 12
ragged shapes (F 39, 63, 64 and 511; valid 0, 1, T - 1, T and mixes;
an unaligned base; ties, signed zeros and all-equal planes) and at the
log-mel scan's planes (8 utterances of 30 s of the smoke test's corpus,
``FrontendConfig(use_mel=True)``: P 4, B 8, T_pad 3072, F 63, 2997 valid
frames, q 0.98), where two launches must be bitwise equal.  Then each is
timed with ``chip_smoke.time_ms`` over loops of 100 calls at those
planes, ``as_is`` first and last; the share of the valid cells that
level 2 collects (either rank's level-1 bin) is printed.  Each variant runs in a process of
its own under a time limit, so a variant that hangs is reported, not
waited for.  Each variant's calls are also traced with ``torch.profiler``:
the median device time of each operation of a call, in order, the gaps
between them and the call's span.  Prints
the card's name and power limit, one line a variant and one JSON line.
Needs one CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import B, SEED, Corpus, card_line, time_ms

BUILDS = {"as_is": [], "match": ["-DRADIX_L0_MATCH"], "level1_only": ["-DRADIX_LEVEL1_ONLY"],
          "skip_level1": ["-DRADIX_SKIP_LEVEL1"]}
# variant -> (build, utterances of the scan's batch taken, None for all)
VARIANTS = {
    "as_is": ("as_is", None),
    "match": ("match", None),
    "half_batch": ("as_is", 4),
    "level1_only": ("level1_only", None),
    "skip_level1": ("skip_level1", None),
}
UNCHECKED = ("level1_only", "skip_level1")
# (B, P, T, F, valid, kind)
RAGGED = (
    (1, 4, 40, 39, [40], "random"), (3, 4, 33, 63, [32, 1, 0], "random"),
    (8, 4, 17, 64, [17, 16, 1, 0, 9, 3, 12, 5], "random"), (3, 2, 9, 511, [9, 8, 0], "random"),
    (1, 3, 50, 63, [49], "random"), (8, 2, 12, 39, [0, 1, 0, 1, 11, 12, 2, 0], "random"),
    (3, 4, 21, 511, [1, 20, 21], "random"), (1, 1, 130, 64, [129], "random"),
    (3, 4, 250, 63, [250, 83, 0], "ties"), (3, 4, 77, 63, [77, 1, 40], "equal"),
    (2, 4, 1000, 512, [999, 3], "random"), (3, 4, 33, 63, [32, 1, 0], "unaligned"),
)
QUANTILE = 0.98
ROOT = Path(__file__).resolve().parent


def build(_cuda, names):
    """One nvcc per build the variants need, all started together;
    returns {build: path}, printing each build's registers and spills."""
    src = _cuda.CSRC / "radix_select.cu"
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in sorted({VARIANTS[n][0] for n in names}):
        so = out / f"libradix_{name}.so"
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


def ragged_planes(torch, dev, b, p, t, f, kind, seed):
    """Plane-major [P, B, T, F] planes of one ragged case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "ties":
        vals = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0], np.float32)
        x = vals[rng.integers(0, len(vals), (p, b, t, f))]
    elif kind == "equal":
        x = np.empty((p, b, t, f), np.float32)
        for i in range(p):
            x[i] = (0.5, -0.0, 0.0, -3.25)[i % 4]
    else:
        x = rng.standard_normal((p, b, t, f)).astype(np.float32)
        x[:, :, : t // 3] = np.round(x[:, :, : t // 3] * 4) / 4
        x[:, :, min(5, t - 1), :7] = -0.0
    if kind == "unaligned":
        buf = torch.zeros(x.size + 1, device=dev)
        pm = buf[1:].view(x.shape)
        pm.copy_(torch.from_numpy(x))
        assert pm.data_ptr() % 16 == 4
        return pm
    return torch.from_numpy(x).to(dev)


def scan_planes(torch, dev):
    """The log-mel scan's planes of the smoke test's first 8 utterances,
    padded to the scan's bucket: (plane-major [4, B, T_pad, F], valid [B])."""
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.scan import bucket_length

    corpus = Corpus(SEED)
    mcfg = C.FrontendConfig(use_mel=True)
    n = len(corpus.utts[0][1])
    wavs = torch.zeros((B, bucket_length(n)), dtype=torch.float32)
    for i, (_u, w, _p) in enumerate(corpus.utts[:B]):
        wavs[i, : len(w)] = torch.from_numpy(w)
    frames = fp._windowed_frames(wavs.to(dev), mcfg)
    planes = fp.response_planes(frames, mcfg)                  # [B, 4, T_pad, F] view
    valid = torch.full((B,), (n - mcfg.frame_length) // mcfg.hop_length, dtype=torch.int32,
                       device=dev)
    return planes.transpose(0, 1), valid


def breakdown(torch, call, n=20):
    """Median device time of each operation of one call, in order, and of
    the call's span, first start to last end, from a ``torch.profiler``
    trace of ``n`` calls; {} if the trace holds no device event."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    calls, cur = [], []
    for e in ev:                          # a call starts with the trace's first operation
        if e[2] == ev[0][2] and cur:
            calls.append(cur)
            cur = []
        cur.append(e)
    if cur:
        calls.append(cur)
    calls = [c for c in calls if len(c) == len(calls[-1])]
    if not calls:
        return {}
    out = {}
    for i in range(len(calls[0])):
        out[f"op{i}_us"] = float(np.median([c[i][1] - c[i][0] for c in calls]))
        if i:
            out[f"gap{i}_us"] = float(np.median([c[i][0] - c[i - 1][1] for c in calls]))
    out["span_us"] = float(np.median([c[-1][1] - c[0][0] for c in calls]))
    out["ops"] = " | ".join(e[2][:40] for e in calls[0])
    return out


def collected_share(torch, pm, valid, selected) -> float:
    """The share of the valid cells that level 2 collects: those in
    either rank's level-1 bin (the top 11 bits of the selected keys)."""
    from template_speech_recognition_tpu_torch.ops.edges import order_keys

    p, b, t, f = pm.shape
    top = order_keys(pm) >> 21                                    # [P, B, T, F]
    rows = torch.arange(t, device=pm.device)[None, :, None] < valid[:, None, None]
    hit = torch.zeros_like(top, dtype=torch.bool)
    for os_ in selected:                                          # [B, P]
        want = (order_keys(os_) >> 21).t()[:, :, None, None]       # [P, B, 1, 1]
        hit |= top == want
    return float((hit & rows[None]).sum()) / float(rows.sum() * p * f)


def run_variant(name: str, so: str) -> dict:
    """Check (unless the variant computes garbage) and time one variant."""
    import torch

    from template_speech_recognition_tpu_torch.frontend.planes import _dual_ranks
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import radix_kernel as k8

    lib = ctypes.CDLL(so)
    lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tsr_cuda_error_string.restype = ctypes.c_char_p
    _cuda._LIBS[k8.NAME] = lib                     # the wrapper launches this build
    batch = VARIANTS[name][1]
    dev = torch.device("cuda")

    row = {"variant": name}
    if name not in UNCHECKED:
        for i, (b, p, t, f, valid, kind) in enumerate(RAGGED):
            pm = ragged_planes(torch, dev, b, p, t, f, kind, SEED + 1 + i)
            vt = torch.tensor(valid, dtype=torch.int32, device=dev)
            for q in (0.0, 0.3, QUANTILE):
                need = _dual_ranks(vt, f, q)
                got = k8.radix_select(pm, vt, need)
                want = k8.radix_select_plain(pm, vt, need)
                for g, w in zip(got, want):
                    if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                        raise RuntimeError(f"{name}: not bitwise at B {b}, P {p}, T {t}, "
                                           f"F {f}, valid {valid}, {kind}, q {q}")
        row["ragged"] = f"bitwise at {len(RAGGED)} shapes x 3 quantiles"
    pm, valid = scan_planes(torch, dev)
    if batch is not None:
        pm, valid = pm[:, :batch].contiguous(), valid[:batch].contiguous()
    need = _dual_ranks(valid, pm.shape[3], QUANTILE)
    def call():
        return k8.radix_select(pm, valid, need)

    if name not in UNCHECKED:
        got = [t.clone() for t in call()]
        want = k8.radix_select_plain(pm, valid, need)
        again = call()
        for g, w, a in zip(got, want, again):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise RuntimeError(f"{name}: not bitwise at the scan's planes")
            if not torch.equal(g.view(torch.int32), a.view(torch.int32)):
                raise RuntimeError(f"{name}: two launches differ at the scan's planes")
        row["collected"] = collected_share(torch, pm, valid, want)
    row["shape"] = f"P {pm.shape[0]}, B {pm.shape[1]}, T {pm.shape[2]}, F {pm.shape[3]}"
    row["valid"] = int(valid[0])
    row["loop100_ms"] = time_ms(torch, call, loop=100)
    row["one_call_ms"] = time_ms(torch, call)
    row.update(breakdown(torch, call))
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_radix_select: no CUDA device", file=sys.stderr)
        return 2
    from template_speech_recognition_tpu_torch.ops import _cuda

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"probe_radix_select: unknown variants {unknown}", file=sys.stderr)
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
    print(json.dumps({"card": card, "unit": "ms", "quantile": QUANTILE, "loop": 100,
                      "rows": rows, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
