"""Bind and launch the relative pose's hypothesis, cheirality and scoring
CUDA kernels (``csrc/relpose_hyp.cu``).

One ``ransac.estimate_relative_pose`` call on the card launches each of
them once, the homography kernel twice (its hypotheses, then its polish and
decomposition), with no host read: ``essential_hypotheses``,
``homography_hypotheses`` / ``homography_polish``, ``recover_pose`` and
``score_candidates`` take and return what their plain versions in
``geometry/ransac.py`` (``*_reference``) do. The library is built and
loaded by ``ops/cuda_build.py`` (nvcc for ``sm_90a`` at first use, ctypes),
with ``-fmad=false`` so that each product and sum rounds as the plain
versions' do. Float32 is the path's type; float64 is there to hold the
kernels to their plain versions. Nothing is built at import; a failed build
or launch raises. ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from meatmodeler_tpu_torch.ops import cuda_build

__all__ = [
    "LAUNCHES",
    "build",
    "essential_hypotheses",
    "homography_hypotheses",
    "homography_polish",
    "recover_pose",
    "reset_launches",
    "score_candidates",
]

# Launch counts, incremented only where a kernel is launched.
LAUNCHES = {"essential_hypotheses": 0, "homography_hypotheses": 0, "recover_pose": 0, "score_candidates": 0}
# Each product and sum rounds on its own, as the plain versions' do.
NVCC_EXTRA = ("-fmad=false",)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# relpose_hyp_scratch_bytes' kinds.
_ESSENTIAL, _HOMOGRAPHY, _POLISH = 0, 1, 2


def _bind(lib: ctypes.CDLL) -> None:
    p, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    args = {
        "essential_hypotheses": [p] * 6 + [i, i, p, p, p, p],
        "homography_hypotheses": [p] * 4 + [d, i, i, p, p, p, p],
        "homography_polish": [p] * 6 + [d, i, i, p, p, p, p, p, p],
        "recover_pose": [p] * 4 + [ll, p, p, i, i, p, p, p, p],
        "score_candidates": [p] * 7 + [i, i] + [p] * 8,
    }
    for name, argtypes in args.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = i
    lib.relpose_hyp_scratch_bytes.argtypes = [i, i, i, i]
    lib.relpose_hyp_scratch_bytes.restype = ctypes.c_size_t


_LIB = cuda_build.CudaLibrary("relpose_hyp", _bind, extra_flags=NVCC_EXTRA)
SOURCE, LIBRARY = _LIB.source, _LIB.path


def build() -> ctypes.CDLL:
    """Compile (when the library is missing or older than its sources) and
    load the kernel library; raises with nvcc's output on failure."""
    return _LIB.load()


def reset_launches() -> None:
    cuda_build.reset(LAUNCHES)


def _check(name: str, specs: Sequence[Tuple[str, torch.Tensor, tuple, torch.dtype]]) -> torch.device:
    """Each (label, tensor, shape, dtype) as stated, all CUDA tensors on one
    device; returns it. Raises ValueError before any launch."""
    for label, t, shape, dtype in specs:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {label} is {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
    device = specs[0][1].device
    if device.type != "cuda" or any(t.device != device for _, t, _, _ in specs):
        raise ValueError(f"{name} needs CUDA tensors on one device, got {[str(t.device) for _, t, _, _ in specs]}")
    return device


def _dtype(name: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{name}: points are {t.dtype}, expected float32 or float64")
    return t.dtype


def _points(name: str, pts1: torch.Tensor) -> int:
    if pts1.ndim != 2 or pts1.shape[0] < 1:
        raise ValueError(f"{name} needs (N, 2) points with N >= 1, got {tuple(pts1.shape)}")
    return pts1.shape[0]


def _ptrs(tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    lib = build()
    with torch.cuda.device(device):
        code = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}_kernel launch failed: cudaError {code}")


def _scratch(kind: int, dtype: torch.dtype, h: int, n: int, device: torch.device) -> Optional[torch.Tensor]:
    """Global memory for a launch's compacted slots, only where they outgrow
    the card's shared memory."""
    with torch.cuda.device(device):
        nbytes = build().relpose_hyp_scratch_bytes(kind, int(dtype == torch.float64), h, n)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


def essential_hypotheses(
    pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, intrinsics: torch.Tensor, idx: torch.Tensor,
    thr2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ransac.essential_hypotheses_reference`` in one launch: (N, 2) pixel
    ``pts1`` / ``pts2``, a bool (N,) ``mask``, a (3, 3) ``intrinsics``, int64
    (H, 8) slot indices ``idx`` (each in [0, N)) and the 0-d squared gate
    ``thr2`` in ray units. Returns (essential matrices (H, 3, 3), int64
    consensus counts (H,))."""
    n = _points("essential_hypotheses", pts1)
    dtype = _dtype("essential_hypotheses", pts1)
    h = idx.shape[0] if idx.ndim == 2 else -1
    device = _check("essential_hypotheses", [
        ("pts1", pts1, (n, 2), dtype), ("pts2", pts2, (n, 2), dtype), ("mask", mask, (n,), torch.bool),
        ("intrinsics", intrinsics, (3, 3), dtype), ("idx", idx, (h, 8), torch.int64), ("thr2", thr2, (), dtype),
    ])
    es = torch.empty((h, 3, 3), dtype=dtype, device=device)
    counts = torch.empty((h,), dtype=torch.int64, device=device)
    if h == 0:
        return es, counts
    ins = [t.contiguous() for t in (pts1, pts2, mask, intrinsics, idx, thr2)]
    scratch = _scratch(_ESSENTIAL, dtype, h, n, device)
    _launch("essential_hypotheses", f"essential_hypotheses_{_SUFFIX[dtype]}", device, *_ptrs(ins), h, n,
            *_ptrs([scratch, es, counts]))
    cuda_build.count(LAUNCHES, "essential_hypotheses")
    return es, counts


def homography_hypotheses(
    pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ransac.homography_hypotheses_reference`` in one launch (mode 0 of
    the homography kernel): int64 (H, 4) slot indices ``idx`` and the gate
    ``threshold`` in pixels. Returns (homographies (H, 3, 3), int64 counts
    (H,))."""
    n = _points("homography_hypotheses", pts1)
    dtype = _dtype("homography_hypotheses", pts1)
    h = idx.shape[0] if idx.ndim == 2 else -1
    device = _check("homography_hypotheses", [
        ("pts1", pts1, (n, 2), dtype), ("pts2", pts2, (n, 2), dtype), ("mask", mask, (n,), torch.bool),
        ("idx", idx, (h, 4), torch.int64),
    ])
    hs = torch.empty((h, 3, 3), dtype=dtype, device=device)
    counts = torch.empty((h,), dtype=torch.int64, device=device)
    if h == 0:
        return hs, counts
    ins = [t.contiguous() for t in (pts1, pts2, mask, idx)]
    scratch = _scratch(_HOMOGRAPHY, dtype, h, n, device)
    _launch("homography_hypotheses", f"homography_hypotheses_{_SUFFIX[dtype]}", device, *_ptrs(ins),
            float(threshold) * float(threshold), h, n, *_ptrs([scratch, hs, counts]))
    cuda_build.count(LAUNCHES, "homography_hypotheses")
    return hs, counts


def homography_polish(
    pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, hs: torch.Tensor, counts: torch.Tensor,
    threshold: float, intrinsics: Optional[torch.Tensor] = None,
):
    """``ransac.homography_polish_reference`` in one launch (mode 1 of the
    homography kernel): the first best of ``hs`` (H, 3, 3) by ``counts``,
    polished twice. Returns (H (3, 3), residuals (N,) inf out of the mask,
    inliers (N,), and with ``intrinsics`` the 8 decompositions' rvecs and
    unit tvecs (8, 3) each, else None, None)."""
    n = _points("homography_polish", pts1)
    dtype = _dtype("homography_polish", pts1)
    h = hs.shape[0] if hs.ndim == 3 else -1
    specs = [
        ("pts1", pts1, (n, 2), dtype), ("pts2", pts2, (n, 2), dtype), ("mask", mask, (n,), torch.bool),
        ("hs", hs, (h, 3, 3), dtype), ("counts", counts, (h,), torch.int64),
    ]
    if intrinsics is not None:
        specs.append(("intrinsics", intrinsics, (3, 3), dtype))
    device = _check("homography_polish", specs)
    if h < 1:
        raise ValueError("homography_polish needs at least one hypothesis")
    out_h = torch.empty((3, 3), dtype=dtype, device=device)
    res = torch.empty((n,), dtype=dtype, device=device)
    inl = torch.empty((n,), dtype=torch.bool, device=device)
    rv = tv = None
    if intrinsics is not None:
        rv = torch.empty((8, 3), dtype=dtype, device=device)
        tv = torch.empty((8, 3), dtype=dtype, device=device)
    ins = [t.contiguous() for t in (pts1, pts2, mask, hs, counts)]
    k = None if intrinsics is None else intrinsics.contiguous()
    scratch = _scratch(_POLISH, dtype, h, n, device)
    _launch("homography_hypotheses", f"homography_polish_{_SUFFIX[dtype]}", device, *_ptrs([*ins, k]),
            float(threshold) * float(threshold), h, n, *_ptrs([scratch, out_h, res, inl, rv, tv]))
    cuda_build.count(LAUNCHES, "homography_hypotheses")
    return out_h, res, inl, rv, tv


def recover_pose(
    essential: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, intrinsics: torch.Tensor,
    thr2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ransac.recover_pose_reference`` in one launch, a block a candidate:
    (B, 3, 3) ``essential``, a bool ``mask`` of (N,) (every candidate's) or
    (B, N), and the optional 0-d Sampson gate ``thr2``. Returns (rvec (B, 3),
    unit t (B, 3), int64 votes (B, 4))."""
    n = _points("recover_pose", pts1)
    dtype = _dtype("recover_pose", pts1)
    b = essential.shape[0] if essential.ndim == 3 else -1
    mshape = (n,) if mask.ndim == 1 else (b, n)
    specs = [
        ("essential", essential, (b, 3, 3), dtype), ("pts1", pts1, (n, 2), dtype), ("pts2", pts2, (n, 2), dtype),
        ("mask", mask, mshape, torch.bool), ("intrinsics", intrinsics, (3, 3), dtype),
    ]
    if thr2 is not None:
        specs.append(("thr2", thr2, (), dtype))
    device = _check("recover_pose", specs)
    rv = torch.empty((b, 3), dtype=dtype, device=device)
    tv = torch.empty((b, 3), dtype=dtype, device=device)
    votes = torch.empty((b, 4), dtype=torch.int64, device=device)
    if b == 0:
        return rv, tv, votes
    ins = [t.contiguous() for t in (essential, pts1, pts2, mask)]
    tail = [intrinsics.contiguous(), None if thr2 is None else thr2.contiguous()]
    _launch("recover_pose", f"recover_pose_{_SUFFIX[dtype]}", device, *_ptrs(ins), 0 if mask.ndim == 1 else n,
            *_ptrs(tail), b, n, *_ptrs([rv, tv, votes]))
    cuda_build.count(LAUNCHES, "recover_pose")
    return rv, tv, votes


def score_candidates(
    rvecs: torch.Tensor, tvecs: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor,
    intrinsics: torch.Tensor, thr2: torch.Tensor,
):
    """``ransac.score_candidates_reference`` in one launch, a block a
    candidate: (C, 3) ``rvecs`` / ``tvecs`` and the 0-d squared gate
    ``thr2``. Returns (int64 good counts (C,), truncated costs (C,), rvecs
    and unit tvecs after the cheirality vote (C, 3), E (C, 3, 3), Sampson
    residuals (C, N) inf out of the mask, inliers (C, N))."""
    n = _points("score_candidates", pts1)
    dtype = _dtype("score_candidates", pts1)
    c = rvecs.shape[0] if rvecs.ndim == 2 else -1
    device = _check("score_candidates", [
        ("rvecs", rvecs, (c, 3), dtype), ("tvecs", tvecs, (c, 3), dtype), ("pts1", pts1, (n, 2), dtype),
        ("pts2", pts2, (n, 2), dtype), ("mask", mask, (n,), torch.bool), ("intrinsics", intrinsics, (3, 3), dtype),
        ("thr2", thr2, (), dtype),
    ])
    good = torch.empty((c,), dtype=torch.int64, device=device)
    msac = torch.empty((c,), dtype=dtype, device=device)
    rvd = torch.empty((c, 3), dtype=dtype, device=device)
    tvd = torch.empty((c, 3), dtype=dtype, device=device)
    e = torch.empty((c, 3, 3), dtype=dtype, device=device)
    res = torch.empty((c, n), dtype=dtype, device=device)
    inl = torch.empty((c, n), dtype=torch.bool, device=device)
    if c == 0:
        return good, msac, rvd, tvd, e, res, inl
    ins = [t.contiguous() for t in (rvecs, tvecs, pts1, pts2, mask, intrinsics, thr2)]
    _launch("score_candidates", f"score_candidates_{_SUFFIX[dtype]}", device, *_ptrs(ins), c, n,
            *_ptrs([good, msac, rvd, tvd, e, res, inl]))
    cuda_build.count(LAUNCHES, "score_candidates")
    return good, msac, rvd, tvd, e, res, inl
