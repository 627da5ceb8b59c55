"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a self-contained source with a plain C
interface.  At first use it is compiled with ``nvcc`` for ``sm_90a``
into ``_build/`` inside the package (listed in ``.gitignore``) and
loaded with ``ctypes``; every pointer and the stream cross as
``c_void_p``.  Each C entry returns ``cudaGetLastError()`` and
``check`` raises when it is not 0.

``build`` starts one ``nvcc`` per missing source, all at once, so a
fresh checkout compiles every kernel in the time of the slowest one.

Launch counts: every kernel wrapper calls ``count_launch`` exactly once
where it launches its kernel (never on the plain path), so a run can
show which kernels the main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launches() -> None:
    _LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def build(stems) -> dict[str, str]:
    """Compile the given ``csrc`` sources that are not built yet, one
    ``nvcc`` process each, all started together.  Returns the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills)
    per source it compiled; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems:
        out = _lib_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            build([stem])
            lib = ctypes.CDLL(str(_lib_path(stem)))
            lib.tsr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tsr_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib


def declare(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int, n_long: int = 0):
    """Declare a C entry taking ``n_ptr`` pointers, ``n_long`` 64-bit
    ints, ``n_int`` ints and the stream (in that order), returning the
    CUDA error code."""
    f = getattr(lib, fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_long
        + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device address (NULL for ``None``: an unused operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.tsr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Raise on what a kernel does not take: wrong device, dtype,
    rank, or a non-contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    require_layout(t, name, dtype, ndim)


def require_layout(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """``require`` without its device check (the CPU tests of a wrapper's
    refusals run it on CPU tensors)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def padded_width(d: int, multiple: int = 8) -> int:
    """``d`` rounded up to ``multiple``."""
    return -(-d // multiple) * multiple


def aligned_rows(t: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """``t`` itself where its rows suit a TMA or 16-byte load (the last
    dimension a multiple of ``multiple``, contiguous, the base 16-byte
    aligned), else a fresh contiguous copy with zero columns appended up
    to the next multiple.  A zero column adds exact zeros to every
    product over the last dimension, so a kernel that contracts it
    gives the unpadded result."""
    d = t.shape[-1]
    if d % multiple == 0 and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[:-1] + (padded_width(d, multiple),))
    out[..., :d] = t
    return out


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain path); raises for
    a device that is neither the CPU nor CUDA, or for a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA: {kinds}")
