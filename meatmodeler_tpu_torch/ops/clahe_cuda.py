"""Build, bind and launch the CLAHE CUDA kernels (``csrc/clahe.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/meatmodeler_tpu_torch/`` beside the package, and loaded with
``ctypes`` (plain C interface: pointers and the stream as ``c_void_p``).
Nothing here is imported or built at module import; a failed build or
launch raises. ``LAUNCHES`` counts each kernel's launches so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch

from meatmodeler_tpu_torch.ops.clahe import tile_geometry

__all__ = ["clahe_cuda", "clahe_lut", "clahe_apply", "build", "LAUNCHES", "reset_launches"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "clahe.cu"
BUILD_DIR = _PKG.parent / "build" / "meatmodeler_tpu_torch"
LIBRARY = BUILD_DIR / "libclahe.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# Launch counts per kernel, incremented only where the kernel is launched.
LAUNCHES = {"clahe_lut": 0, "clahe_apply": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CLAHE kernels")


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its source) and
    load the kernel library; raises with nvcc's output on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = LIBRARY.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(str(LIBRARY))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clahe_lut.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        lib.clahe_lut.restype = i
        lib.clahe_apply.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.clahe_apply.restype = i
        _lib = lib
        return lib


def _check_image(img: torch.Tensor) -> None:
    if not img.is_cuda:
        raise ValueError(f"CLAHE kernel needs a CUDA tensor, got {img.device}")
    if img.dtype != torch.float32:
        raise ValueError(f"CLAHE kernel needs float32, got {img.dtype}")
    if img.ndim != 3 or not img.is_contiguous():
        raise ValueError(f"CLAHE kernel needs a contiguous (B, H, W) tensor, got {tuple(img.shape)}")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def clahe_lut(img: torch.Tensor, clip_limit: float, tiles: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) float32 -> (B, ty*tx, 256) float32 tile LUTs."""
    _check_image(img)
    lib = build()
    b, h, w = img.shape
    ty, tx = tiles
    th, tw = tile_geometry(h, w, tiles)
    if th * ty - h >= h or tw * tx - w >= w:
        raise ValueError(f"image {h}x{w} too small for a {ty}x{tx} tile grid")
    clip = max(1, int(clip_limit * th * tw / 256.0))
    lut = torch.empty((b, ty * tx, 256), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    code = lib.clahe_lut(img.data_ptr(), lut.data_ptr(), b, h, w, ty, tx, th, tw, clip, stream)
    _raise_on(code, "clahe_lut_kernel")
    LAUNCHES["clahe_lut"] += 1
    return lut


def clahe_apply(img: torch.Tensor, lut: torch.Tensor, tiles: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) image + its (B, ty*tx, 256) LUTs -> (B, H, W) float32."""
    _check_image(img)
    b, h, w = img.shape
    ty, tx = tiles
    if lut.shape != (b, ty * tx, 256) or lut.dtype != torch.float32 or not lut.is_contiguous():
        raise ValueError(f"clahe_apply: bad LUT {tuple(lut.shape)} {lut.dtype}")
    if lut.device != img.device:
        raise ValueError("clahe_apply: image and LUT on different devices")
    lib = build()
    th, tw = tile_geometry(h, w, tiles)
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    code = lib.clahe_apply(
        img.data_ptr(), lut.data_ptr(), out.data_ptr(), b, h, w, ty, tx, th, tw, stream
    )
    _raise_on(code, "clahe_apply_kernel")
    LAUNCHES["clahe_apply"] += 1
    return out


def clahe_cuda(img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on (..., H, W) CUDA images in [0, 255] through the two kernels."""
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(-1, h, w).to(torch.float32).contiguous()
    lut = clahe_lut(flat, clip_limit, tiles)
    return clahe_apply(flat, lut, tiles).reshape(*batch_shape, h, w)
