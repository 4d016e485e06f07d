"""Bind and launch the relative-pose refinement CUDA kernel
(``csrc/relpose.cu``).

One launch refines every candidate of a ``ransac.refine_relative_pose``
call through all of its iterations. The library is built and loaded by
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

__all__ = ["refine_relpose", "build", "LAUNCHES", "reset_launches"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"refine_relpose": 0}
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.refine_relpose.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.refine_relpose.restype = i


_LIB = cuda_build.CudaLibrary("relpose", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its source) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def refine_relpose(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    iters: int = 15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ransac.refine_relative_pose`` on CUDA tensors in one launch: float32
    (B, 3) ``rvec`` and ``tvec``, (N, 2) pixel ``pts1`` and ``pts2``, a bool
    (N,) ``mask`` and a (3, 3) ``intrinsics``, all on one device. Returns
    the refined (rvec (B, 3), unit tvec (B, 3))."""
    if rvec.ndim != 2 or pts1.ndim != 2:
        raise ValueError(f"refine_relpose needs (B, 3) rvec and (N, 2) pts1, got {tuple(rvec.shape)}, {tuple(pts1.shape)}")
    b, n = rvec.shape[0], pts1.shape[0]
    tensors = (rvec, tvec, pts1, pts2, mask, intrinsics)
    for name, t, shape, dtype in zip(
        ("rvec", "tvec", "pts1", "pts2", "mask", "intrinsics"), tensors,
        ((b, 3), (b, 3), (n, 2), (n, 2), (n,), (3, 3)),
        (torch.float32,) * 4 + (torch.bool, torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"refine_relpose: {name} is {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
    device = rvec.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"refine_relpose needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    if iters < 0:
        raise ValueError(f"refine_relpose: iters {iters} < 0")
    out_r = torch.empty((b, 3), dtype=torch.float32, device=device)
    out_t = torch.empty((b, 3), dtype=torch.float32, device=device)
    if b == 0:
        return out_r, out_t
    # The kernel reads the points as float2: 8-byte aligned.
    tensors = [t.contiguous() for t in tensors]
    tensors = [t if t.data_ptr() % 8 == 0 else t.clone() for t in tensors]
    scratch = torch.empty((b, n), dtype=torch.float32, device=device)  # each candidate's residuals
    lib = build()
    args = [t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        code = lib.refine_relpose(
            *args, b, n, iters, scratch.data_ptr(), out_r.data_ptr(), out_t.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"refine_relpose_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "refine_relpose")
    return out_r, out_t
