"""Repository-wide pytest hook: build the native IO library once.

``tests/test_native_io.py`` decides at collection whether
``native/libtsr_audio.so`` loads.  Under pytest-xdist every worker
collects it at once, and a worker that finds the library missing runs
``make`` into the same file as the others (the loader's lock is per
process), so a worker can load a half-written library and skip the
module.  Here the controlling process (the only process of a run
without xdist) runs ``make -s`` in ``native/`` once, before any worker
starts.  A failed build is left to the module's own skip.
"""

from __future__ import annotations

import os
import subprocess

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    if os.path.exists(os.path.join(_NATIVE, "libtsr_audio.so")):
        return
    try:
        subprocess.run(["make", "-s"], cwd=_NATIVE, check=False, capture_output=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass
