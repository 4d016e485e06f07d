"""Bind and launch the planar PnP refinement CUDA kernel (``csrc/pnp.cu``).

One launch refines every frame and both planar twins of a
``pnp.solve_pnp_batch`` call (or the poses of one ``pnp.refine_pose``
call) through all of their Gauss-Newton iterations, and returns each
refined pose's cost. The library is built and loaded by
``ops/cuda_build.py`` (nvcc for ``sm_90a`` at first use, ctypes), with
``-fmad=false`` so that each product and sum rounds as the plain version's
do. Nothing is built at import; a failed build or launch raises.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build

__all__ = ["pnp_refine", "build", "LAUNCHES", "reset_launches"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"pnp_refine": 0}
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)
_ENTRY = {torch.float32: "pnp_refine_f32", torch.float64: "pnp_refine_f64"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_double, p, p, p]
        fn.restype = i


_LIB = cuda_build.CudaLibrary("pnp", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its sources) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def pnp_refine(
    poses: torch.Tensor,
    obj_pts: torch.Tensor,
    img_pts: torch.Tensor,
    intrinsics: torch.Tensor,
    iters: int = 10,
    damping: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pnp.refine_pose_reference`` on CUDA tensors in one launch, for
    (T, F, 6) ``poses`` (T starts per frame: the two planar twins, or one)
    against (N, 3) ``obj_pts``, each frame's (F, N, 2) ``img_pts`` and a
    (3, 3) ``intrinsics``, float32 or float64, all on one device. Returns
    the refined poses (T, F, 6) and their costs sum |proj - img|^2 (T, F)."""
    if poses.ndim != 3 or img_pts.ndim != 3:
        raise ValueError(f"pnp_refine needs (T, F, 6) poses and (F, N, 2) pixels, got {tuple(poses.shape)}, "
                         f"{tuple(img_pts.shape)}")
    t, f, n = poses.shape[0], poses.shape[1], img_pts.shape[1]
    dtype = poses.dtype
    if dtype not in _ENTRY:
        raise ValueError(f"pnp_refine: poses are {dtype}, expected float32 or float64")
    tensors = (poses, obj_pts, img_pts, intrinsics)
    for name, x, shape in zip(("poses", "obj_pts", "img_pts", "intrinsics"), tensors,
                              ((t, f, 6), (n, 3), (f, n, 2), (3, 3))):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"pnp_refine: {name} is {x.dtype} {tuple(x.shape)}, expected {dtype} {shape}")
    device = poses.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError(f"pnp_refine needs CUDA tensors on one device, got {[str(x.device) for x in tensors]}")
    if iters < 0:
        raise ValueError(f"pnp_refine: iters {iters} < 0")
    out = torch.empty((t, f, 6), dtype=dtype, device=device)
    cost = torch.empty((t, f), dtype=dtype, device=device)
    if t == 0 or f == 0:
        return out, cost
    tensors = [x.contiguous() for x in tensors]
    lib = build()
    args = [x.data_ptr() for x in tensors]
    with torch.cuda.device(device):
        code = getattr(lib, _ENTRY[dtype])(
            *args, t, f, n, iters, float(damping), out.data_ptr(), cost.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"pnp_refine_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "pnp_refine")
    return out, cost
