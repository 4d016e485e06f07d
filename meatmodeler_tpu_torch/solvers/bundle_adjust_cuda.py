"""Bind and launch the per-observation BA Jacobian CUDA kernel
(``csrc/ba_jac.cu``).

One launch computes every observation's (2, 6) camera and (2, 3) point
Jacobian, masked and weighted, for one LM iteration of one problem or of a
lane axis of problems (``solve_ba_batch``). The library is built and loaded
by ``ops/cuda_build.py`` (nvcc for ``sm_90a`` at first use, ctypes), with
``-fmad=false`` so that each product and sum rounds as the plain version's
do. Nothing is built at import; a failed build or launch raises.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build

__all__ = ["obs_jacobians", "build", "LAUNCHES", "reset_launches"]

# Launch counts, incremented only where the kernel is launched.
LAUNCHES = {"obs_jacobians": 0}
# Each product and sum rounds on its own, as the plain version's do.
NVCC_EXTRA = ("-fmad=false",)
_ENTRY = {torch.float32: "obs_jacobians_f32", torch.float64: "obs_jacobians_f64"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p, p]
        fn.restype = i


_LIB = cuda_build.CudaLibrary("ba_jac", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its sources) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def obs_jacobians(
    cam: torch.Tensor,
    pts: torch.Tensor,
    intrinsics: torch.Tensor,
    fidx: torch.Tensor,
    pidx: torch.Tensor,
    mask: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bundle_adjust._obs_jacobians`` on CUDA tensors in one launch:
    float32 or float64 (F, 6) ``cam``, (P, 3) ``pts``, (3, 3)
    ``intrinsics``, int64 (N,) ``fidx`` and ``pidx``, bool (N,) ``mask`` and
    an optional (N,) ``weight``, all on one device; or every argument with a
    leading lane axis (V,), indices numbered within their lane. Returns
    (jc (..., N, 2, 6), jp (..., N, 2, 3)), already multiplied by mask and
    weight."""
    lanes = cam.ndim == 3
    lead = tuple(cam.shape[:1]) if lanes else ()
    if cam.ndim not in (2, 3) or pts.ndim != cam.ndim or fidx.ndim != cam.ndim - 1:
        raise ValueError(
            f"obs_jacobians needs (F, 6) cam, (P, 3) pts and (N,) indices, each with one optional leading lane axis; "
            f"got {tuple(cam.shape)}, {tuple(pts.shape)}, {tuple(fidx.shape)}"
        )
    f, p, n = cam.shape[-2], pts.shape[-2], fidx.shape[-1]
    dtype = cam.dtype
    if dtype not in _ENTRY:
        raise ValueError(f"obs_jacobians: cam is {dtype}, expected float32 or float64")
    named = [("cam", cam, lead + (f, 6), dtype), ("pts", pts, lead + (p, 3), dtype),
             ("intrinsics", intrinsics, lead + (3, 3), dtype), ("fidx", fidx, lead + (n,), torch.int64),
             ("pidx", pidx, lead + (n,), torch.int64), ("mask", mask, lead + (n,), torch.bool)]
    if weight is not None:
        named.append(("weight", weight, lead + (n,), dtype))
    for name, t, shape, want in named:
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"obs_jacobians: {name} is {t.dtype} {tuple(t.shape)}, expected {want} {shape}")
    device = cam.device
    tensors = [t for _, t, _, _ in named]
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"obs_jacobians needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
    jc = torch.empty(lead + (n, 2, 6), dtype=dtype, device=device)
    jp = torch.empty(lead + (n, 2, 3), dtype=dtype, device=device)
    if n == 0 or (lanes and lead[0] == 0):
        return jc, jp
    tensors = [t.contiguous() for t in tensors]
    if weight is None:
        tensors.append(None)
    lib = build()
    args = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        code = getattr(lib, _ENTRY[dtype])(
            *args, lead[0] if lanes else 1, f, p, n, jc.data_ptr(), jp.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"obs_jacobians_kernel launch failed: cudaError {code}")
    cuda_build.count(LAUNCHES, "obs_jacobians")
    return jc, jp
