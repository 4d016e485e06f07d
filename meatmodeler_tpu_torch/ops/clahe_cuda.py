"""Bind and launch the CLAHE CUDA kernels (``csrc/clahe.cu``).

The library is built and loaded by ``ops/cuda_build.py`` (nvcc for
``sm_90a`` at first use, ctypes); nothing here is built at module import,
and a failed build or launch raises. ``LAUNCHES`` counts each kernel's
launches so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.ops.clahe import tile_geometry

__all__ = ["clahe_cuda", "clahe_lut", "clahe_apply", "build", "LAUNCHES", "reset_launches"]

# Launch counts per kernel, incremented only where the kernel is launched.
LAUNCHES = {"clahe_lut": 0, "clahe_apply": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clahe_lut.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
    lib.clahe_lut.restype = i
    lib.clahe_apply.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.clahe_apply.restype = i


_LIB = cuda_build.CudaLibrary("clahe", _bind)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its source) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


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
    # The library's runtime calls act on the current device: make it the image's.
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = lib.clahe_lut(img.data_ptr(), lut.data_ptr(), b, h, w, ty, tx, th, tw, clip, stream)
    _raise_on(code, "clahe_lut_kernel")
    cuda_build.count(LAUNCHES, "clahe_lut")
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
    with torch.cuda.device(img.device):  # its cudaFuncSetAttribute is per device
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = lib.clahe_apply(
            img.data_ptr(), lut.data_ptr(), out.data_ptr(), b, h, w, ty, tx, th, tw, stream
        )
    _raise_on(code, "clahe_apply_kernel")
    cuda_build.count(LAUNCHES, "clahe_apply")
    return out


def clahe_cuda(img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on (..., H, W) CUDA images in [0, 255] through the two kernels."""
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(-1, h, w).to(torch.float32).contiguous()
    lut = clahe_lut(flat, clip_limit, tiles)
    return clahe_apply(flat, lut, tiles).reshape(*batch_shape, h, w)
