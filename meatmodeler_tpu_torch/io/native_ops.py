"""ctypes bindings for the native preprocessing tier (native/preprocess.cpp);
the port's copy of ``meatmodeler_tpu/io/native_ops.py``.

Same lazy-build pattern as the y4m loader (io/y4m.py): compile with g++ on
first use, cache the .so in ``build/meatmodeler_tpu_torch/``, fall back to
NumPy when no toolchain is available. The exposed op is the host side of pass 1's
transfer-optimal path: BGR -> downscaled grey in one streaming pass, so only
one byte per (downscaled) pixel crosses the host->device link.
"""

from __future__ import annotations

import ctypes

import numpy as np

from meatmodeler_tpu_torch.io._native_build import BUILD_DIR, NATIVE_DIR, NativeLib

__all__ = ["bgr_to_grey_down", "native_available"]


def _configure(lib, ct):
    lib.bgr_grey_down.argtypes = [
        ct.POINTER(ct.c_uint8),
        ct.POINTER(ct.c_uint8),
        ct.c_long,
        ct.c_long,
        ct.c_long,
        ct.c_long,
    ]


_native = NativeLib(
    src=NATIVE_DIR / "preprocess.cpp",
    lib_path=BUILD_DIR / "_libpreprocess.so",
    configure=_configure,
)


def _load_native():
    return _native.load()


def native_available() -> bool:
    return _load_native() is not None


def bgr_to_grey_down(frames: np.ndarray, scale: int = 1) -> np.ndarray:
    """(T, H, W, 3) uint8 BGR -> (T, H//scale, W//scale) uint8 BT.601 grey.

    Point-sampled decimation (matches ``frames[:, ::scale, ::scale]``).
    Native C++ when available; NumPy otherwise (bit-compatible within 1 LSB).
    """
    frames = np.ascontiguousarray(frames)
    t, h, w, c = frames.shape
    assert c == 3, frames.shape
    oh, ow = h // scale, w // scale
    lib = _load_native()
    if lib is not None:
        out = np.empty((t, oh, ow), np.uint8)
        lib.bgr_grey_down(
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            t,
            h,
            w,
            scale,
        )
        return out
    small = frames[:, : oh * scale : scale, : ow * scale : scale]
    return (
        (
            small[..., 0].astype(np.uint16) * 29
            + small[..., 1].astype(np.uint16) * 150
            + small[..., 2].astype(np.uint16) * 77
        )
        >> 8
    ).astype(np.uint8)
