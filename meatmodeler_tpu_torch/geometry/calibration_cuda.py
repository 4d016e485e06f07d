"""Bind and launch the calibration LM CUDA kernel (``csrc/calib.cu``).

One launch runs one whole ``calibration.run_lm``: every iteration, both
damping trials and the accept/stop rule, with the Jacobian kept as its
arrowhead blocks and each trial solved through the intrinsics' Schur
complement (sums and solves in double), a warp per view on a cluster of up
to 8 blocks; nothing is read back until it ends. The views' terms stay in
the blocks' shared memory; only a call with more views than that holds
gets a global workspace (``calib_lm_workspace``). The library is built and
loaded by ``ops/cuda_build.py`` (nvcc for ``sm_90a`` at first use,
ctypes), with ``-fmad=false`` so that each product and sum rounds as the
plain version's do. Nothing is built at import; a failed build or launch
raises. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build

__all__ = ["calib_lm", "build", "LAUNCHES", "reset_launches"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"calib_lm": 0}
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)
_ENTRY = {torch.float32: "calib_lm_f32", torch.float64: "calib_lm_f64"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, d, d, i, p, p, p, p, p]
        fn.restype = i
    lib.calib_lm_workspace.argtypes = [i, i, i, i]
    lib.calib_lm_workspace.restype = ctypes.c_longlong


_LIB = cuda_build.CudaLibrary("calib", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its sources) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def calib_lm(
    theta0: torch.Tensor,
    img_points: torch.Tensor,
    obj_points: torch.Tensor,
    image_size: Tuple[float, float],
    num_dist: int,
    max_iters: int,
    fix_principal_point: bool,
    single_focal: bool,
    view_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``calibration.run_lm_reference`` on CUDA tensors in one launch:
    float32 or float64 ``theta0`` (n_intr + 6F) in ``calibration._unpack``'s
    layout, (F, N, 2) ``img_points``, (N, 3) ``obj_points`` and an optional
    bool (F,) ``view_mask``, all on one device. Returns (theta, cost = 0.5
    sum r^2, iterations taken (int32)), on the device."""
    if img_points.ndim != 3 or img_points.shape[-1] != 2:
        raise ValueError(f"calib_lm needs (F, N, 2) img_points, got {tuple(img_points.shape)}")
    if not 0 <= num_dist <= 5 or max_iters < 0:
        raise ValueError(f"calib_lm: num_dist {num_dist} outside 0-5 or max_iters {max_iters} < 0")
    f, n = img_points.shape[:2]
    n_focal, n_pp = (1 if single_focal else 2), (0 if fix_principal_point else 2)
    n_intr = n_focal + n_pp + num_dist
    dtype = img_points.dtype
    if dtype not in _ENTRY:
        raise ValueError(f"calib_lm: img_points are {dtype}, expected float32 or float64")
    named = [("theta0", theta0, (n_intr + 6 * f,), dtype), ("img_points", img_points, (f, n, 2), dtype),
             ("obj_points", obj_points, (n, 3), dtype)]
    if view_mask is not None:
        named.append(("view_mask", view_mask, (f,), torch.bool))
    for name, t, shape, want in named:
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"calib_lm: {name} is {t.dtype} {tuple(t.shape)}, expected {want} {shape}")
    device = img_points.device
    tensors = [t for _, t, _, _ in named]
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"calib_lm needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    if f == 0 or n == 0:
        raise ValueError(f"calib_lm needs at least one view and one point, got {f} x {n}")
    tensors = [t.contiguous() for t in tensors] + ([] if view_mask is not None else [None])
    lib = build()
    work = torch.empty(int(lib.calib_lm_workspace(f, n, n_intr, img_points.element_size())), dtype=torch.uint8,
                       device=device)
    theta = torch.empty_like(tensors[0])
    cost = torch.empty((), dtype=dtype, device=device)
    iters = torch.empty((), dtype=torch.int32, device=device)
    args = [None if t is None else t.data_ptr() for t in tensors]
    w, h = float(image_size[0]), float(image_size[1])
    with torch.cuda.device(device):
        code = getattr(lib, _ENTRY[dtype])(
            args[0], args[1], args[2], args[3], f, n, n_focal, n_pp, num_dist, 0.5 * w, 0.5 * h, max_iters,
            work.data_ptr(), theta.data_ptr(), cost.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"calib_lm_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "calib_lm")
    return theta, cost, iters
