"""Bind and launch the pyramidal Lucas-Kanade CUDA kernel (``csrc/klt.cu``).

One launch tracks every point of a ``klt.lucas_kanade`` call through every
level (a block a point, one barrier an iteration). The library is built
and loaded by ``ops/cuda_build.py`` (nvcc for ``sm_90a`` at first use,
ctypes), with ``-fmad=false`` so that each product and sum rounds as the
plain version's do. Nothing is built at import; a
failed build or launch raises. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build

__all__ = ["lk_track", "build", "LAUNCHES", "reset_launches", "MAX_WIN", "MAX_LEVELS"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"lk_track": 0}
MAX_WIN = 31  # kMaxWin in csrc/klt.cu: four window pixels per thread
MAX_LEVELS = 8  # kMaxLevels
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lk_track.argtypes = [
        ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(i), i,
        p, p, p, i, i, i, ctypes.c_float, p, p, p, p, p, p,
    ]
    lib.lk_track.restype = i


_LIB = cuda_build.CudaLibrary("klt", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its source) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def _levels(prev_pyr, curr_pyr, levels: int, device) -> Tuple[list, list]:
    prev, curr = list(prev_pyr[:levels]), list(curr_pyr[:levels])
    if len(curr) < levels:
        raise ValueError(f"lk_track: {levels} levels asked, the current pyramid has {len(curr)}")
    for lvl, (a, b) in enumerate(zip(prev, curr)):
        for img in (a, b):
            if img.device != device:
                raise ValueError(f"lk_track: level {lvl} on {img.device}, points on {device}")
            if img.dtype != torch.float32:
                raise ValueError(f"lk_track needs float32 pyramids, got {img.dtype} at level {lvl}")
            if img.ndim != 2 or not img.is_contiguous():
                raise ValueError(f"lk_track needs contiguous (H, W) levels, got {tuple(img.shape)} at level {lvl}")
        if a.shape != b.shape:
            raise ValueError(f"lk_track: level {lvl} shapes differ, {tuple(a.shape)} and {tuple(b.shape)}")
    return prev, curr


def lk_track(
    prev_pyr: Sequence[torch.Tensor],
    curr_pyr: Sequence[torch.Tensor],
    points: torch.Tensor,
    win: int,
    levels: int,
    max_iters: int,
    eps: float,
    point_mask: Optional[torch.Tensor] = None,
    initial_flow: Optional[torch.Tensor] = None,
    iterations: Optional[torch.Tensor] = None,
    path: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``klt.lucas_kanade`` on CUDA tensors in one launch: (points (N, 2),
    status (N,), error (N,)). ``levels`` is already capped at the pyramid's
    depth. For counting the work a call needed: ``iterations``, if given,
    is an (N, levels) int32 tensor that receives the iterations each point
    ran at each level (level 0 first); ``path``, if given, an (N, levels,
    max_iters, 2) float32 tensor that receives the displacement (at that
    level's scale) each of those iterations sampled the current level at."""
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"lk_track needs CUDA tensors, got {device}")
    if not 1 <= win <= MAX_WIN:
        raise ValueError(f"lk_track takes windows of 1 to {MAX_WIN} px, got {win}")
    if not 1 <= levels <= MAX_LEVELS or max_iters < 0:
        raise ValueError(f"lk_track: levels {levels} (1 to {MAX_LEVELS}), max_iters {max_iters} (>= 0)")
    prev, curr = _levels(prev_pyr, curr_pyr, levels, device)
    points = points.to(torch.float32).contiguous()
    n = points.shape[0]
    if points.shape != (n, 2):
        raise ValueError(f"lk_track needs (N, 2) points, got {tuple(points.shape)}")
    if point_mask is None:
        point_mask = torch.ones(n, dtype=torch.bool, device=device)
    point_mask = point_mask.to(torch.bool).contiguous()
    if initial_flow is not None:
        initial_flow = initial_flow.to(torch.float32).contiguous()
    for name, t, shape in (("point_mask", point_mask, (n,)), ("initial_flow", initial_flow, (n, 2)),
                           ("iterations", iterations, (n, levels)), ("path", path, (n, levels, max_iters, 2))):
        if t is not None and (t.device != device or t.shape != shape):
            raise ValueError(f"lk_track: {name} {tuple(t.shape)} on {t.device}, expected {shape} on {device}")
    for name, t, dtype in (("iterations", iterations, torch.int32), ("path", path, torch.float32)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"lk_track: {name} must be a contiguous {dtype} tensor")
    out_pts = torch.empty((n, 2), dtype=torch.float32, device=device)
    status = torch.empty(n, dtype=torch.bool, device=device)
    error = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out_pts, status, error
    lib = build()
    ptr = ctypes.c_void_p
    args = (
        (ptr * levels)(*[t.data_ptr() for t in prev]), (ptr * levels)(*[t.data_ptr() for t in curr]),
        (ctypes.c_int * levels)(*[t.shape[0] for t in prev]), (ctypes.c_int * levels)(*[t.shape[1] for t in prev]),
        levels, points.data_ptr(), None if initial_flow is None else initial_flow.data_ptr(),
        point_mask.data_ptr(), n, win, max_iters, eps * eps, out_pts.data_ptr(), status.data_ptr(),
        error.data_ptr(), None if iterations is None else iterations.data_ptr(),
        None if path is None else path.data_ptr(),
    )
    with torch.cuda.device(device):
        code = lib.lk_track(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"lk_track_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "lk_track")
    return out_pts, status, error
