"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each library is compiled from its sources with ``nvcc`` for ``sm_90a`` at
first use into ``build/meatmodeler_tpu_torch/`` beside the package, and
loaded with ``ctypes`` (plain C interface: pointers and the stream as
``c_void_p``). A library is rebuilt when it is missing or older than one of
its sources or any shared header (``csrc/*.cuh``); a failed build raises
with nvcc's output.
Nothing here runs at import.

The wrappers' launch counters (one plain dict per module) share one lock:
the batch entry points launch from two host threads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "CudaLibrary", "compile_source", "count", "nvcc", "on_card", "reset"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "meatmodeler_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_count_lock = threading.Lock()


def count(launches: Dict[str, int], name: str) -> None:
    with _count_lock:
        launches[name] += 1


def reset(launches: Dict[str, int]) -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def on_card(t) -> bool:
    """Whether a dispatch launches its kernel for tensor ``t``: a CUDA
    tensor. CPU tensors take the plain version."""
    return t.device.type == "cuda"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def compile_source(source: Path, out: Path, extra: Sequence[str] = ()) -> str:
    """nvcc ``source`` into the shared library ``out``; returns nvcc's
    output, raises with it on failure."""
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, *extra, "-o", str(out), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


class CudaLibrary:
    """``csrc/<name>.cu`` (and ``csrc/<more>.cu`` for each of ``more``)
    built into ``build/.../lib<name>.so`` and loaded once; ``bind(lib)`` sets
    the C entries' argument types."""

    def __init__(
        self, name: str, bind: Callable[[ctypes.CDLL], None], extra_flags: Sequence[str] = (),
        more: Sequence[str] = (),
    ):
        self.source = CSRC / f"{name}.cu"
        self.sources = [self.source, *(CSRC / f"{m}.cu" for m in more)]
        self.path = BUILD_DIR / f"lib{name}.so"
        self._bind = bind
        self._extra = list(extra_flags)
        self._lib = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def load(self) -> ctypes.CDLL:
        """Compile when the library is missing or older than a source or a
        shared header, then load it; raises on a failed build."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            newest = max(src.stat().st_mtime for src in (*self.sources, *CSRC.glob("*.cuh")))
            if not self.path.exists() or self.path.stat().st_mtime < newest:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = self.path.with_suffix(f".tmp{os.getpid()}.so")
                try:
                    # The further sources are linked in as further inputs of nvcc.
                    compile_source(self.source, tmp, [*self._extra, *map(str, self.sources[1:])])
                    os.replace(tmp, self.path)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(self.path))
            self._bind(lib)
            self._lib = lib
            return lib
