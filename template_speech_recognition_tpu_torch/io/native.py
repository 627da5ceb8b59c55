"""ctypes bindings for the native audio IO library (``native/``).

The port's own copy of ``template_speech_recognition_tpu.io.native``:
it loads the same ``native/libtsr_audio.so`` (C++ shared by both
packages, outside either).  Twins of ``io.audio.read_audio`` and of the
decode + preemphasis + framing prefix of the frontend, plus a threaded
batch loader.  If the library is absent it is built once with
``native/Makefile`` (a host C++ compiler); if that fails, callers fall
back to the Python readers: the same samples, slower.  A library that
exists is never rebuilt (the lock, then the check, as in the
reference), so processes that load it at once do not race.

Bit-compatibility with ``io.audio`` and ``ops.framing`` is held by
``tests/test_torch_io.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtsr_audio.so")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    subprocess.run(
        ["make", "-s"], cwd=_NATIVE_DIR, check=True, capture_output=True
    )


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library; raises
    NativeUnavailable if neither works."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                _build()
            except (OSError, subprocess.CalledProcessError) as e:
                raise NativeUnavailable(f"native build failed: {e}") from e
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            raise NativeUnavailable(f"cannot load {_SO_PATH}: {e}") from e
        c_i64 = ctypes.c_int64
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_ip = ctypes.POINTER(ctypes.c_int)
        c_fp = ctypes.POINTER(ctypes.c_float)
        lib.tsr_probe_audio.argtypes = [ctypes.c_char_p, c_i64p, c_ip]
        lib.tsr_read_audio.argtypes = [ctypes.c_char_p, c_fp, c_i64, c_i64p, c_ip]
        lib.tsr_read_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_float, c_i64, c_i64, c_fp, c_i64,
            c_i64p, c_ip,
        ]
        lib.tsr_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), c_i64, c_fp, c_i64, c_i64p,
            c_ip, ctypes.c_int,
        ]
        for fn in (lib.tsr_probe_audio, lib.tsr_read_audio,
                   lib.tsr_read_frames, lib.tsr_read_batch):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


def _check(rc: int, path: str) -> None:
    if rc:
        msgs = {-1: "cannot open", -2: "bad container",
                -3: "unsupported coding", -4: "buffer too small"}
        raise IOError(f"{path}: native decode failed "
                      f"({msgs.get(rc, rc)})")


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Native twin of ``io.audio.read_audio``."""
    lib = load_library()
    count = ctypes.c_int64()
    rate = ctypes.c_int()
    _check(lib.tsr_probe_audio(path.encode(), ctypes.byref(count),
                               ctypes.byref(rate)), path)
    out = np.empty(count.value, np.float32)
    _check(
        lib.tsr_read_audio(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            count.value, ctypes.byref(count), ctypes.byref(rate),
        ),
        path,
    )
    return out, rate.value


def read_frames(
    path: str,
    preemphasis: float,
    frame_length: int,
    hop_length: int,
) -> tuple[np.ndarray, int]:
    """Decode + preemphasis + framing in C++: returns
    ([T, frame_length] float32, sample_rate) -- the exact prefix of
    the frontend before windowing."""
    lib = load_library()
    count = ctypes.c_int64()
    rate = ctypes.c_int()
    _check(lib.tsr_probe_audio(path.encode(), ctypes.byref(count),
                               ctypes.byref(rate)), path)
    max_frames = max(
        0, 1 + (count.value - frame_length) // hop_length
    ) if count.value >= frame_length else 0
    out = np.empty((max_frames, frame_length), np.float32)
    n_frames = ctypes.c_int64()
    _check(
        lib.tsr_read_frames(
            path.encode(), preemphasis, frame_length, hop_length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_frames, ctypes.byref(n_frames), ctypes.byref(rate),
        ),
        path,
    )
    return out[: n_frames.value], rate.value


def read_batch(
    paths: list[str],
    max_samples: int,
    num_threads: int = 8,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded batch decode into one padded arena.

    Returns (arena [N, max_samples] float32 zero-padded,
    counts [N] int64, rates [N] int32).
    """
    lib = load_library()
    n = len(paths)
    arena = np.zeros((n, max_samples), np.float32)
    counts = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.tsr_read_batch(
        c_paths, n,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    if rc:
        bad = [paths[i] for i in range(n) if counts[i] < 0]
        raise IOError(f"native batch decode failed for {bad[:3]}...")
    return arena, counts, rates
