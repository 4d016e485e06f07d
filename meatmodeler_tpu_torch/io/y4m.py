"""Y4M (YUV4MPEG2) video IO: native C++ threaded-prefetch loader + NumPy
fallback + writer; the port's copy of ``meatmodeler_tpu/io/y4m.py``.

The native loader (``native/y4m_loader.cpp``) is the framework's first-party
replacement for the decode tier the reference borrows from OpenCV's C++
``VideoCapture`` (``processor.py:310-319``; SURVEY.md §2.4): a background
thread decodes and color-converts ahead of the consumer through a ring
buffer, overlapping host decode with device compute. The library builds
lazily with g++ on first use and caches in ``build/meatmodeler_tpu_torch/``; environments
without a toolchain silently fall back to the NumPy path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from meatmodeler_tpu_torch.io import _native_build

__all__ = ["read_y4m", "write_y4m", "native_available"]

_NATIVE_SRC = _native_build.NATIVE_DIR / "y4m_loader.cpp"
_NATIVE_LIB = _native_build.BUILD_DIR / "_liby4m.so"


def _configure(lib, ct):
    lib.y4m_open.restype = ct.c_void_p
    lib.y4m_open.argtypes = [ct.c_char_p]
    lib.y4m_width.argtypes = [ct.c_void_p]
    lib.y4m_height.argtypes = [ct.c_void_p]
    lib.y4m_next.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint8)]
    lib.y4m_close.argtypes = [ct.c_void_p]


_native = _native_build.NativeLib(
    src=_NATIVE_SRC, lib_path=_NATIVE_LIB, configure=_configure, extra_flags=("-pthread",)
)


def _load_native() -> Optional[ctypes.CDLL]:
    return _native.load()


def native_available() -> bool:
    return _load_native() is not None


def read_y4m(path) -> np.ndarray:
    """Decode a .y4m file to (T, H, W, 3) uint8 BGR frames."""
    lib = _load_native()
    if lib is not None:
        handle = lib.y4m_open(str(path).encode())
        if handle:
            w, h = lib.y4m_width(handle), lib.y4m_height(handle)
            frames = []
            buf = np.empty((h, w, 3), np.uint8)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            while lib.y4m_next(handle, ptr):
                frames.append(buf.copy())
            lib.y4m_close(handle)
            return np.stack(frames) if frames else np.empty((0, h, w, 3), np.uint8)
    return _read_y4m_numpy(path)


def _read_y4m_numpy(path) -> np.ndarray:
    data = Path(path).read_bytes()
    nl = data.index(b"\n")
    header = data[:nl].decode("ascii").split()
    assert header[0] == "YUV4MPEG2", "not a y4m file"
    w = h = 0
    cs = "420"
    for tok in header[1:]:
        if tok[0] == "W":
            w = int(tok[1:])
        elif tok[0] == "H":
            h = int(tok[1:])
        elif tok[0] == "C":
            cs = tok[1:]
    if cs.startswith("444"):
        cw, ch = w, h
    elif cs.startswith("422"):
        cw, ch = w // 2, h
    else:
        cw, ch = w // 2, h // 2

    ysz, csz = w * h, cw * ch
    frames = []
    pos = nl + 1
    while pos < len(data):
        fnl = data.index(b"\n", pos)
        assert data[pos : pos + 5] == b"FRAME"
        pos = fnl + 1
        y = np.frombuffer(data, np.uint8, ysz, pos).reshape(h, w)
        u = np.frombuffer(data, np.uint8, csz, pos + ysz).reshape(ch, cw)
        v = np.frombuffer(data, np.uint8, csz, pos + ysz + csz).reshape(ch, cw)
        pos += ysz + 2 * csz
        uu = u.repeat(h // ch, 0).repeat(w // cw, 1).astype(np.int32) - 128
        vv = v.repeat(h // ch, 0).repeat(w // cw, 1).astype(np.int32) - 128
        yy = y.astype(np.int32)
        r = yy + (359 * vv >> 8)
        g = yy - ((88 * uu + 183 * vv) >> 8)
        b = yy + (454 * uu >> 8)
        frames.append(
            np.stack([b, g, r], axis=-1).clip(0, 255).astype(np.uint8)
        )
    return np.stack(frames) if frames else np.empty((0, h, w, 3), np.uint8)


def write_y4m(path, frames: np.ndarray, colorspace: str = "444") -> str:
    """Write (T, H, W, 3) uint8 BGR frames as .y4m (default C444: lossless
    chroma so decode round-trips exactly up to BT.601 integer math)."""
    frames = np.asarray(frames, np.uint8)
    t, h, w = frames.shape[:3]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{colorspace}\n".encode())
        for frame in frames:
            b = frame[..., 0].astype(np.int32)
            g = frame[..., 1].astype(np.int32)
            r = frame[..., 2].astype(np.int32)
            # BT.601 full-range forward transform (x256 fixed point).
            y = (77 * r + 150 * g + 29 * b) >> 8
            u = ((-43 * r - 85 * g + 128 * b) >> 8) + 128
            v = ((128 * r - 107 * g - 21 * b) >> 8) + 128
            y = y.clip(0, 255).astype(np.uint8)
            u = u.clip(0, 255).astype(np.uint8)
            v = v.clip(0, 255).astype(np.uint8)
            if colorspace.startswith("420"):
                u = u[::2, ::2]
                v = v[::2, ::2]
            elif colorspace.startswith("422"):
                u = u[:, ::2]
                v = v[:, ::2]
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
    return str(path)
