"""Bind and launch the relative-pose refinement CUDA kernel
(``csrc/relpose.cu``).

One launch refines every candidate of a ``ransac.refine_relative_pose``
call through all of its iterations (a block a candidate, on the slots
that can affect the result, compacted once a launch: ``csrc/relpose.cu``'s
note gives the rule). The library is built and loaded by
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

__all__ = ["refine_relpose", "build", "kept_slots", "LAUNCHES", "reset_launches"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"refine_relpose": 0}
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)
# kRayLimit and kFocalLimit in csrc/relpose.cu: the compaction's rule.
RAY_LIMIT = 64.0
FOCAL_LIMIT = 1e6


def kept_slots(pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the slots the kernel keeps when it compacts a launch
    (``csrc/relpose.cu``'s note): every slot in the mask, and every other
    slot unless all four of its coordinates lie within ``RAY_LIMIT`` focal
    lengths of the principal point (a NaN or inf fails that) under a finite
    K with nonzero fx, fy and |focal| <= ``FOCAL_LIMIT``. The dropped slots
    add exactly 0 to every sum of the plain version at every pose."""
    f32 = torch.float32
    fx, fy, cx, cy = (intrinsics[i, j].to(f32) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    focal = 0.5 * (fx + fy)
    may_drop = bool(torch.isfinite(torch.stack([fx, fy, cx, cy])).all() and fx != 0 and fy != 0
                    and torch.abs(focal) <= FOCAL_LIMIT)
    if not may_drop:
        return torch.ones_like(mask, dtype=torch.bool)
    lim = torch.stack([RAY_LIMIT * torch.abs(fx), RAY_LIMIT * torch.abs(fy)])
    centre = torch.stack([cx, cy])
    inside = ((torch.abs(pts1.to(f32) - centre) <= lim) & (torch.abs(pts2.to(f32) - centre) <= lim)).all(dim=1)
    return mask.to(torch.bool) | ~inside


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.refine_relpose.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.refine_relpose.restype = i
    lib.refine_relpose_scratch_bytes.argtypes = [i, i]
    lib.refine_relpose_scratch_bytes.restype = ctypes.c_size_t


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
    lib = build()
    args = [t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        # Global memory for the compacted points and residuals, only where
        # they outgrow the card's shared memory.
        nbytes = lib.refine_relpose_scratch_bytes(b, n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
        code = lib.refine_relpose(
            *args, b, n, iters, None if scratch is None else scratch.data_ptr(), out_r.data_ptr(), out_t.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"refine_relpose_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "refine_relpose")
    return out_r, out_t
