#!/usr/bin/env python3
"""The frontend planes on the tensor cores: a 3-pass TF32 redesign of
kernel 1 (``probe_frontend_planes_tf32.cu``: TMA loads, ``wgmma`` with
split operands), measured beside the port's fp32 SIMT kernel
(``csrc/frontend_planes.cu``) on one NVIDIA GPU (H100).

    python3 probe_frontend_planes.py

The TF32 source is built with the port's ``nvcc`` flags into
``template_speech_recognition_tpu_torch/_build/probe/``; the port does
not launch it.  Inputs are ``chip_smoke.py``'s: the windowed frames of
the first 8 of its utterances of 30 s (24,576 rows of 400 samples).

For each kernel and shape, ``chip_smoke.planes_metrics``: the scaled
error against the plain version (``chip_smoke.py`` holds kernel 1 to
1e-5) and, for kernel and plain version, against float64, with the
share of the fp32 error bound used (the TF32 kernel's bound with its
split's term).  Beside them, the exact DFT rounded once to fp32, the
best any fp32 kernel can return, against the plain version.  Shapes:
the bench shape (nfft 512) at n_mels 0, 64 and 129; ``chip_smoke.py``'s
small ones (501 rows at nfft 512, n_mels 40, 64, 129, and nfft 400);
1, 63, 64, 65 and 511 rows, nfft 1024 and 1984 at n_mels 0 and 129,
a frame length of 398, and 501 rows at four more offsets.  The plain
GEMM is also taken on all 24,576 rows and sliced, which sets cuBLAS's
error at 501 rows against its error at the bench shape.  Then: a base
pointer 4 bytes off must raise in the TF32 wrapper (TMA needs 16
bytes); the share of the default scan's first-batch map cells that each
kernel sets otherwise than the plain run; both kernels and the
yardsticks of ``chip_smoke.py`` timed with CUDA events (median of 10,
SIMT, TF32, TF32, SIMT).  Prints the card's name and power limit, the
TF32 build's ``-Xptxas -v`` lines and one JSON line; exits 1 if a
kernel leaves its fp32 error bound of float64, 2 without a GPU (a
launch the card refuses is printed, not fatal: the SIMT kernel's block
of one thread a DFT column does not fit the register file past 480
columns).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "probe_frontend_planes_tf32.cu"
BENCH_MELS = (0, 64, 129)


def build(_cuda) -> tuple[ctypes.CDLL, str]:
    """The TF32 kernel's library (built unless the same source and flags
    were) and the compiler's log."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(_cuda.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _cuda.BUILD_DIR / "probe" / f"libplanes_tf32-{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = "cached"
    if not out.exists():
        proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(SOURCE)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc exit {proc.returncode}\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tsr_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


class Tf32Planes:
    """The TF32 kernel behind the port's wrapper contract: [N, FL] f32
    frames -> [4, N, F] planes.  The DFT basis is split once per (FL,
    nfft, device) and stored K-major [6, bins, FL4] (cos-hi, cos-lo,
    -sin-hi, -sin-lo, cos, -sin); a frame length that is not a multiple
    of 4 is padded with zero samples (a TMA row is a multiple of 16
    bytes), otherwise the frames must start on a 16-byte boundary."""

    def __init__(self, torch, _cuda, k1, lib):
        self.torch, self._cuda, self.k1, self.lib = torch, _cuda, k1, lib
        self.fn = _cuda.declare(lib, "tsr_frontend_planes_tf32", 5, 4)
        lib.tsr_frontend_planes_tf32_smem.argtypes = [ctypes.c_int]
        lib.tsr_frontend_planes_tf32_smem.restype = ctypes.c_int

    @functools.lru_cache(maxsize=8)
    def basis(self, frame_length, nfft, device):
        torch, k1 = self.torch, self.k1
        cos_m, sin_m = k1.dft_matrices(frame_length, nfft, device)
        fl4 = -(-frame_length // 4) * 4
        ct = torch.nn.functional.pad(cos_m.t(), (0, fl4 - frame_length))
        st = torch.nn.functional.pad(sin_m.t(), (0, fl4 - frame_length))
        return torch.stack([*k1.split_tf32(ct), *k1.split_tf32(st), ct, st]).contiguous()

    def smem(self, n_mels):
        return self.lib.tsr_frontend_planes_tf32_smem(n_mels)

    def __call__(self, frames, nfft, sample_rate=0, n_mels=0):
        torch, _cuda = self.torch, self._cuda
        _cuda.require(frames, "frames", torch.float32, 2)
        n, fl = frames.shape
        dev = str(frames.device)
        basis = self.basis(fl, nfft, dev)
        fl4 = basis.shape[2]
        if fl4 != fl:
            frames = torch.nn.functional.pad(frames, (0, fl4 - fl))
        elif frames.data_ptr() % 16:
            raise ValueError("frames must be 16-byte aligned")
        fbt = mrange = None
        f = nfft // 2
        if n_mels:
            fbt, mrange = self.k1._mel_on(sample_rate, nfft, n_mels, dev)
            f = n_mels - 1
        out = torch.empty((4, n, f), dtype=torch.float32, device=frames.device)
        err = self.fn(_cuda.ptr(frames), _cuda.ptr(basis), _cuda.ptr(fbt), _cuda.ptr(mrange),
                      _cuda.ptr(out), n, fl4, nfft // 2, n_mels,
                      _cuda.stream_ptr(frames.device))
        _cuda.check(self.lib, err, "frontend_planes_tf32")
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_frontend_planes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from template_speech_recognition_tpu_torch import config as C
    from template_speech_recognition_tpu_torch.frontend import planes as fp
    from template_speech_recognition_tpu_torch.ops import _cuda
    from template_speech_recognition_tpu_torch.ops import frontend_kernel as k1
    from template_speech_recognition_tpu_torch.ops.dft import dft_matrices, mel_filterbank
    from template_speech_recognition_tpu_torch.scan import bucket_length

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build(["frontend_planes"])
    lib, log = build(_cuda)
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"ptxas tf32: {line.strip()}", flush=True)
    tf32 = Tf32Planes(torch, _cuda, k1, lib)
    kernels = {"simt": k1.edge_response_planes, "tf32": tf32}

    dev = torch.device("cuda")
    fcfg = C.FrontendConfig()
    corpus = cs.Corpus(cs.SEED)
    wavs = torch.zeros((cs.B, bucket_length(int(cs.SECONDS * corpus.sample_rate))))
    for i, (_u, w, _p) in enumerate(corpus.utts[: cs.B]):
        wavs[i, : len(w)] = torch.from_numpy(w)
    wavs = wavs.to(dev)
    nvalid = torch.full((cs.B,), int(cs.SECONDS * corpus.sample_rate), dtype=torch.int32,
                        device=dev)
    frames = fp._windowed_frames(wavs, fcfg)
    fpad = torch.zeros((cs.B, 3072, fcfg.frame_length), device=dev)
    fpad[:, : frames.shape[1]] = frames
    frames2 = fpad.reshape(-1, fcfg.frame_length).contiguous()
    nfft, sr = fcfg.nfft, 16000

    fr = frames2[1000 : 1000 + 4 * 128 - 11]
    cases = [(fr, 512, 40), (fr, 512, 64), (fr, 512, 129), (fr, 400, 0)]
    cases += [(frames2[1000 : 1000 + n], 512, nm) for n in (1, 63, 64, 65, 511) for nm in (0, 64)]
    cases += [(fr, nf, nm) for nf in (1024, 1984) for nm in (0, 129)]
    fr398 = fr[:, :398].contiguous()
    cases += [(fr398, 512, 0), (fr398, 512, 64)]
    cases += [(frames2[o : o + 501], nf, 0) for o in (3000, 9000, 15000, 21000) for nf in (400, 512)]
    cases = [(x, nf, nm, f"N {x.shape[0]}, FL {x.shape[1]}, nfft {nf}, n_mels {nm}")
             for x, nf, nm in cases]
    cases += [(frames2, nfft, nm, f"bench, n_mels {nm}") for nm in BENCH_MELS]

    def ideal(x, nf, sample_rate, nm):
        """The exact DFT rounded once to fp32, then the plain version's
        power, log(-mel) and differences."""
        cm, sm = dft_matrices(x.shape[1], nf, x.device)
        x64 = x.double()
        p = (x64 @ cm.double()).float() ** 2 + (x64 @ sm.double()).float() ** 2
        if nm:
            spec = torch.log(p @ mel_filterbank(sample_rate, nf, nm, x.device) + 1e-6)
            return k1._differences(spec, nm - 1)
        return k1._differences(0.5 * torch.log(p + 1e-6), nf // 2)

    rows, over, trips = [], [], {"simt": 0, "tf32": 0, "ideal": 0}
    failed = {"simt": [], "tf32": []}
    for x, nf, nm, label in cases:
        want = k1.edge_response_planes_plain(x, nf, sr, nm)
        row = {"case": label}
        for name, fn in (*kernels.items(), ("ideal", ideal)):
            try:
                got = fn(x, nf, sr, nm)
            except RuntimeError as exc:     # a launch the card refuses
                failed[name].append(f"{label}: {exc}")
                row[name] = {k: float("nan") for k in ("scaled", "scaled64", "head")}
                continue
            m = cs.planes_metrics(torch, x, nf, got, want, sr, nm, split=name == "tf32")
            row[name] = {k: float(f"{v:.4g}") for k, v in m.items() if k != "err"}
            trips[name] += m["scaled"] > 1e-5
            if name != "ideal" and max(m["head"], m["plain_head"]) > 1.0:
                over.append(f"{name} {label}")
        rows.append(row)
        print(f"{label}: " + "; ".join(
            f"{n} scaled {row[n]['scaled']:.3g} (64: {row[n]['scaled64']:.3g}, bound "
            f"{row[n]['head']:.3g})" for n in ("simt", "tf32", "ideal"))
            + f"; plain 64: {row['ideal']['plain_scaled64']:.3g}", flush=True)
        del want, got

    # cuBLAS's error at 501 rows against its error on the whole batch
    cm, sm = dft_matrices(400, 400, dev)
    whole = torch.stack([frames2 @ cm, frames2 @ sm])[:, 1000:1501]
    p = whole[0] ** 2 + whole[1] ** 2
    sliced = k1._differences(0.5 * torch.log(p + 1e-6), 200)
    want = k1.edge_response_planes_plain(fr, 400)
    m_whole = cs.planes_metrics(torch, fr, 400, sliced, want)
    print(f"plain GEMM on 24,576 rows, rows 1000-1500, nfft 400: scaled {m_whole['scaled']:.3g} "
          f"against the 501-row GEMM, {m_whole['scaled64']:.3g} against float64 (the 501-row "
          f"GEMM: {m_whole['plain_scaled64']:.3g})", flush=True)

    off = fr.reshape(-1)[: 3 * 400 + 1].clone()[1:].view(3, 400)
    try:
        tf32(off, 512)
        misaligned = "taken"
    except ValueError:
        misaligned = "raised"

    map_share = {}
    map_p = fp.frontend_batch_flat(wavs, nvalid, fcfg, plain=True).binary
    for name, fn in kernels.items():
        k1.edge_response_planes = fn
        try:
            map_k = fp.frontend_batch_flat(wavs, nvalid, fcfg).binary
        finally:
            k1.edge_response_planes = kernels["simt"]
        map_share[name] = int((map_k != map_p).sum()) / map_k.numel()
    print(f"default scan, first batch: share of map cells unlike the plain run's {map_share}",
          flush=True)

    cs_m = torch.cat(dft_matrices(400, nfft, dev), dim=1).contiguous()
    pw = torch.rand(frames2.shape[0], nfft // 2 + 1, device=dev)
    times = {}
    for nm in BENCH_MELS:
        for name in ("simt", "tf32", "tf32", "simt"):
            times.setdefault(f"{name} n_mels {nm}", []).append(
                cs.time_ms(torch, lambda: kernels[name](frames2, nfft, sr, nm)))
        fb = mel_filterbank(sr, nfft, nm, dev) if nm else None
        yard = ((lambda: torch.matmul(frames2, cs_m)) if not nm else
                (lambda: (torch.matmul(frames2, cs_m), torch.matmul(pw, fb))))
        times[f"plain n_mels {nm}"] = [cs.time_ms(torch, lambda: k1.edge_response_planes_plain(
            frames2, nfft, sr, nm))]
        times[f"library n_mels {nm}"] = [cs.time_ms(torch, yard)]
    for k, v in times.items():
        print(f"{k}: " + " / ".join(f"{t:.4f}" for t in v) + " ms", flush=True)

    for name, msgs in failed.items():
        for msg in msgs:
            print(f"{name} did not launch at {msg}", flush=True)
    print(card)
    print(json.dumps({"trips": trips, "over_bound": over, "launch_failed": failed,
                      "misaligned": misaligned,
                      "map_share": map_share, "tf32_smem": {nm: tf32.smem(nm) for nm in BENCH_MELS},
                      "times_ms": times, "cublas_whole_batch": m_whole, "cases": rows}))
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main())
