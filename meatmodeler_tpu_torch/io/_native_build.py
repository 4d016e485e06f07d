"""Shared lazy g++ build-and-load for first-party native libraries.

The port's copy of ``meatmodeler_tpu/io/_native_build.py``. The native
components (the y4m loader, the preprocessing ops, the host pass-1 scan)
follow the same contract: compile their C++ source with g++ on first use,
cache the ``.so`` in ``build/meatmodeler_tpu_torch/`` beside the CUDA
kernels' library, rebuild when the source is newer, and degrade to a
pure-Python fallback (or a raise, for the pass-1 scan) when no toolchain
exists. The y4m loader and the preprocessing ops build the sources in
``native/``, shared with the JAX package; the pass-1 scan builds the port's
own threaded copy in ``meatmodeler_tpu_torch/native/``.

Loads are serialized with a lock (pass 1 calls the preprocess ops from both
the main chunk loop and the board-detection worker thread), and the compile
writes to a unique temp file then ``os.replace``s it into place, so two
processes racing a cold build can never load a truncated library.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

_REPO = Path(__file__).resolve().parents[2]
# The first-party C++ sources, shared with the JAX package (they hold no JAX).
NATIVE_DIR = _REPO / "native"
# C++ sources of the port alone.
PORT_NATIVE_DIR = _REPO / "meatmodeler_tpu_torch" / "native"
BUILD_DIR = _REPO / "build" / "meatmodeler_tpu_torch"


@functools.lru_cache(maxsize=1)
def _machine_tag() -> str:
    """Short hash of the host's CPU feature flags.

    Libraries build with ``-march=native``; a working directory shared (or
    restored) across machine classes must not load a .so vectorized for a
    different CPU — keying the filename per feature set forces a rebuild
    instead of a SIGILL.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.processor().encode()).hexdigest()[:8]


class NativeLib:
    """Lazy-built ctypes library handle with a one-shot failure latch."""

    def __init__(
        self,
        src: Path,
        lib_path: Path,
        configure: Callable,
        extra_flags: Sequence[str] = (),
    ):
        self._src = src
        self._lib_path = lib_path.with_name(
            f"{lib_path.stem}-{_machine_tag()}{lib_path.suffix}"
        )
        self._configure = configure
        self._extra_flags = list(extra_flags)
        self._lib = None
        self._failed = False
        self._lock = threading.Lock()

    def load(self):
        """Return the configured CDLL, or None if the build/load failed."""
        import ctypes

        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            try:
                stale = not self._lib_path.exists() or (
                    self._src.exists()
                    and self._src.stat().st_mtime > self._lib_path.stat().st_mtime
                )
                if stale:
                    self._lib_path.parent.mkdir(parents=True, exist_ok=True)
                    tmp = self._lib_path.with_suffix(f".tmp{os.getpid()}.so")
                    try:
                        subprocess.run(
                            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                             *self._extra_flags,
                             "-o", str(tmp), str(self._src)],
                            check=True,
                            capture_output=True,
                        )
                        os.replace(tmp, self._lib_path)
                    finally:
                        tmp.unlink(missing_ok=True)
                lib = ctypes.CDLL(str(self._lib_path))
                self._configure(lib, ctypes)
                self._lib = lib
            except Exception:
                self._failed = True
            return self._lib
