"""The persistent kernel build, all at once.

Counterpart of ``template_speech_recognition_tpu.utils.compile_cache``,
which points JAX at an on-disk compile cache so that a second CLI
process compiles nothing.  The port already keeps such a cache: each
``csrc/*.cu`` is built once into ``_build/`` under a hash of its source
and flags (``ops._cuda``), and a later process loads it.  But
``_cuda.load`` builds one source at a time, when a wrapper first
launches it.  ``enable_compile_cache`` builds every source not built
yet at once, one ``nvcc`` each, when a card is present, so a process's
first scan waits for the slowest build and not for their sum.  It sets
no environment variable.
"""

from __future__ import annotations

import torch

from template_speech_recognition_tpu_torch.ops import _cuda


def enable_compile_cache() -> str:
    """Build every kernel source not built yet, where a card is present
    (none is started on a machine without one); returns the build
    directory."""
    if torch.cuda.is_available():
        _cuda.build(sorted(p.stem for p in _cuda.CSRC.glob("*.cu")))
    return str(_cuda.BUILD_DIR)
