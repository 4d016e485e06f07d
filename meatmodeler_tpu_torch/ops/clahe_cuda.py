"""Bind and launch the CLAHE CUDA kernels (``csrc/clahe.cu``) and ORB's
(``csrc/orb.cu``), which share the library.

ORB's serve one pyramid level of a whole (B, H, W) stack each:
``orb_level_build`` (the blur the descriptor samples and the next level),
``orb_response`` (FAST, Harris, NMS, margin) and ``orb_describe``
(orientation, bin and steered BRIEF of every selected keypoint). The tables
they read (the banded downscale taps of each level size, the packed BRIEF
table) are built on the host once and kept on each device, so a warm call
uploads nothing and reads nothing back.

The library is built and loaded by ``ops/cuda_build.py`` (nvcc for
``sm_90a`` at first use, ctypes); nothing here is built at module import,
and a failed build or launch raises. ``LAUNCHES`` counts each kernel's
launches so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.ops import orb as orb_mod
from meatmodeler_tpu_torch.ops.clahe import tile_geometry

__all__ = ["clahe_cuda", "clahe_lut", "clahe_apply", "orb_describe", "orb_level_build", "orb_response", "build",
           "LAUNCHES", "reset_launches"]

# Launch counts per kernel, incremented only where the kernel is launched.
LAUNCHES = {"clahe_lut": 0, "clahe_apply": 0, "orb_level": 0, "orb_response": 0, "orb_describe": 0}
# The Harris constants of ``features.harris_response`` at block size 7.
HARRIS_K = 0.04
HARRIS_SCALE = 1.0 / (4.0 * 255.0 * 7) ** 2


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clahe_lut.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
    lib.clahe_lut.restype = i
    lib.clahe_apply.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.clahe_apply.restype = i
    f = ctypes.c_float
    lib.orb_level_build.argtypes = [p, p, p, i, i, i, i, i, p, p, i, p, p, i, p, p]
    lib.orb_level_build.restype = i
    lib.orb_response.argtypes = [p, p, p, i, i, i, f, f, f, i, p]
    lib.orb_response.restype = i
    lib.orb_describe.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.orb_describe.restype = i


_LIB = cuda_build.CudaLibrary("clahe", _bind, more=("orb",))
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its source) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
        code = lib.clahe_lut(img.data_ptr(), lut.data_ptr(), b, h, w, ty, tx, th, tw, clip, _stream(img.device))
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
        code = lib.clahe_apply(
            img.data_ptr(), lut.data_ptr(), out.data_ptr(), b, h, w, ty, tx, th, tw, _stream(img.device)
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


_GAUSS_TAPS = ctypes.c_float * 7
_tables: Dict[tuple, object] = {}
_tables_lock = threading.Lock()


def _resident(key: tuple, device: torch.device, make):
    """``make()``'s host arrays as tensors on ``device``, made once."""
    key = (*key, device)
    with _tables_lock:
        if key not in _tables:
            _tables[key] = tuple(torch.from_numpy(a).to(device) for a in make())
        return _tables[key]


def _check_level(img: torch.Tensor, what: str) -> None:
    if not img.is_cuda or img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (B, H, W) float32 CUDA tensor, got {tuple(img.shape)} "
                         f"{img.dtype} on {img.device}")


def orb_level_build(img: torch.Tensor, next_size: Optional[Tuple[int, int]]):
    """(B, H, W) level -> (its ``orb._gauss7`` blur, the next level of size
    ``next_size`` by ``orb._resize``'s taps, or None without a size)."""
    _check_level(img, "orb_level_build")
    lib = build()
    b, h, w = img.shape
    blur = torch.empty_like(img)
    nxt, nh, nw = None, 0, 0
    taps = (None,) * 4
    ny = nx = 0
    if next_size is not None:
        nh, nw = next_size
        nxt = torch.empty((b, nh, nw), dtype=torch.float32, device=img.device)
        taps = (*_resident(("rows", h, nh), img.device, lambda: orb_mod._resize_taps(h, nh)),
                *_resident(("cols", w, nw), img.device, lambda: orb_mod._resize_taps(w, nw)))
        ny, nx = taps[1].shape[1], taps[3].shape[1]
    gauss = _GAUSS_TAPS(*orb_mod._gauss_taps().tolist())
    ptrs = [t.data_ptr() if t is not None else None for t in taps]
    with torch.cuda.device(img.device):
        code = lib.orb_level_build(
            img.data_ptr(), blur.data_ptr(), nxt.data_ptr() if nxt is not None else None, b, h, w, nh, nw,
            ptrs[0], ptrs[1], ny, ptrs[2], ptrs[3], nx, ctypes.cast(gauss, ctypes.c_void_p), _stream(img.device),
        )
    _raise_on(code, "level_build_kernel")
    cuda_build.count(LAUNCHES, "orb_level")
    return blur, nxt


def orb_response(img: torch.Tensor, threshold: float, margin: int, raw: bool = False):
    """(B, H, W) level -> (B, H, W) float32: the Harris response where
    FAST-9/16 fires at ``threshold``, the 3x3 maximum holds and the pixel
    lies ``margin`` or more inside; -inf elsewhere. With ``raw`` also the
    response before the maximum and the margin (-inf where FAST does not
    fire), as a second tensor: what the tests hold to FAST's flags and
    Harris at every pixel."""
    _check_level(img, "orb_response")
    lib = build()
    b, h, w = img.shape
    masked = torch.empty_like(img)
    before = torch.empty_like(img) if raw else None
    with torch.cuda.device(img.device):
        code = lib.orb_response(img.data_ptr(), masked.data_ptr(), before.data_ptr() if raw else None, b, h, w,
                                threshold, HARRIS_K, HARRIS_SCALE, margin, _stream(img.device))
    _raise_on(code, "response_kernel")
    cuda_build.count(LAUNCHES, "orb_response")
    return (masked, before) if raw else masked


def orb_describe(img: torch.Tensor, blurred: torch.Tensor, idx: torch.Tensor, resp: torch.Tensor, bin_width: float):
    """Every selected keypoint of a level: ``idx`` (B, K) flat pixel
    indices and ``resp`` (B, K) their responses (not finite: a padded
    slot) -> (angle (B, K) float32, descriptors (B, K, 256) int8)."""
    _check_level(img, "orb_describe")
    _check_level(blurred, "orb_describe")
    b, h, w = img.shape
    k = idx.shape[1]
    if blurred.shape != img.shape or idx.shape != (b, k) or resp.shape != (b, k):
        raise ValueError(f"orb_describe: shapes {tuple(img.shape)}, {tuple(blurred.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(resp.shape)} do not fit")
    if idx.dtype != torch.int64 or resp.dtype != torch.float32 or {idx.device, resp.device, blurred.device} != {img.device}:
        raise ValueError("orb_describe: indices int64 and responses float32 on the image's device")
    lib = build()
    (table,) = _resident(("brief",), img.device, lambda: (orb_mod._brief_table(),))
    idx, resp = idx.contiguous(), resp.contiguous()
    angle = torch.empty((b, k), dtype=torch.float32, device=img.device)
    desc = torch.empty((b, k, orb_mod._NBITS), dtype=torch.int8, device=img.device)
    with torch.cuda.device(img.device):
        code = lib.orb_describe(img.data_ptr(), blurred.data_ptr(), idx.data_ptr(), resp.data_ptr(), table.data_ptr(),
                                angle.data_ptr(), desc.data_ptr(), b, h, w, k, bin_width, _stream(img.device))
    _raise_on(code, "describe_kernel")
    cuda_build.count(LAUNCHES, "orb_describe")
    return angle, desc
