"""Time the relative pose's CUDA kernels against their bounds on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.relpose_bench [--ptxas] [--compare SOURCE [--paths]]

The refinement (``csrc/relpose.cu``): at the shapes of
``refine_relative_pose``'s three callers, on seeded two-view scenes
(``relpose_case``): the odometry's (16 essential and 8 homography
candidates, 128 points), the marker-free bootstrap's (16 candidates, 8192
track slots, 40% of them masked, 20% of the rest outliers) and two-view's
(8 candidates, 4096 match slots, 96% padding): the kernel's device time,
its plain PyTorch version's, the work the call needs, the bound it sets and
the share of it reached. Times are ``clahe_bench.time_ms``'s: medians with
a cold L2 and the host's launch time hidden (25 calls of the kernel, 10 of
the plain version, which takes ~100 ms a call).

The hypothesis, cheirality and scoring kernels (``csrc/relpose_hyp.cu``,
``HYP_KERNELS``): at the seeded calls of ``estimate_relative_pose`` at the
three paths' shapes (``hyp_case``: 1024 hypotheses at 128 points, 2048 at
8192 slots with ~421 in the mask, 2048 at 4096 with ~149), the same
figures, and beside the essential kernel one ``torch.linalg.eigh`` of the
same (H, 9, 9) normal matrices, a yardstick for its eigen part alone (no
single PyTorch call computes any of the four functions). ``hyp_work``
counts their work (see its note); ``*_agreement`` hold each kernel to its
plain version (see ``hyp_agreement``).

The refinement's work (``relpose_work``) is counted for the points that enter the fit,
the mask's: rays once a call (8 operations a point); then each iteration
of each candidate: the residual (35: ex1 12, etx2 8, num 4, the squared
sum 7, clamp, sqrt, scale and divide 4), its six tangents (42 each: dex1
12, detx2 8, dnum 4, dsum 11, the clamp's and sqrt's tangent 3, dr 4), the
weights and their square roots with the scaling of J and r (13), the
normal equations' 21 + 6 products and sums and the cost (57), and the
candidate's weighted cost (38); per candidate and iteration, ~700 for the
pose, its tangent matrices, the 6x6 solve and the candidate's E. The
median's selection is integer work and is not counted. Bytes: the points,
the mask, the poses and K read once, the poses written once. The bound is
the larger of operations at 67 TFLOP/s (float32 outside the tensor cores)
and bytes at 3.35 TB/s. Neither is the kernel's limit: each iteration
depends on the last, and each is a chain of dependent steps of the
candidate's block (the pose's tangents; the median's radix passes, at
most four, and its scan; the normal equations; the 6x6 solve; the
candidate's cost), after the launch's compaction (two passes over the
slots) and the start's residuals; ``steps`` gives that chain's length at
most for the call, ``barriers`` its block barriers at most (one a median
pass and its scan, one after the sums, one after the cost; a refused step
leaves only the last).

  --ptxas    compiles ``csrc/relpose.cu`` and ``csrc/relpose_hyp.cu`` once
             more with ``-Xptxas -v`` and prints the kernels' registers,
             shared memory and spills.
  --compare  builds another ``relpose.cu`` (an earlier design: the first
             one's C interface, a (B, N) float scratch, is bound too) and
             times both libraries' kernels at the same inputs in turns:
             other, this, this, other; with ``--paths`` also at the first
             calls the odometry, the marker-free bootstrap and two-view
             make (``tools/path_calls.py``), as one launch and as their
             16 essential candidates alone.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import inspect
import math
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from meatmodeler_tpu_torch.geometry import homography, ransac, ransac_cuda, ransac_hyp_cuda, so3
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.tools.clahe_bench import HBM_BYTES_PER_S, time_ms

FP32_FLOPS_PER_S = 67e12  # one H100 SXM, float32 outside the tensor cores
ITERS = 15  # refine_relative_pose's default, which every caller takes
RAY_OPS = 8
POINT_OPS = 35 + 6 * 42 + 13 + 57 + 38  # per point that enters the fit, per candidate and iteration
POSE_OPS = 700  # per candidate and iteration
# The callers' shapes: (label, candidates, points, masked share, outlier
# share). ``estimate_relative_pose`` refines its 16 essential and 8
# homography candidates in one call (24 a launch); the first four rows are
# the two families apart, as the first design launched them, the last two
# one launch of the odometry and of the marker-free bootstrap, whose mask
# holds ~421 of its 8192 track slots.
CALLERS = [
    ("odometry", 16, 128, 0.1, 0.1),
    ("odometry_h", 8, 128, 0.1, 0.1),
    ("bootstrap", 16, 8192, 0.4, 0.2),
    ("two_view", 8, 4096, 0.96, 0.2),
    ("odometry_24", 24, 128, 0.1, 0.1),
    ("bootstrap_421", 24, 8192, 1.0 - 421 / 8192, 0.2),
]
# Edge cases of phase 3c and the CPU tests: the start poses' rvec (the
# so3.exp Taylor branch at 0 and 1e-7, the closed form with cancellation at
# 1e-5), a relative rotation near pi, zero tvec starts (a failed homography
# decomposition's nan_to_num), and a mask with nothing in it.
EDGE_CASES = ("small_angle", "near_pi", "zero_t", "all_masked")
# Padding the compaction must keep (``ransac_cuda.kept_slots``), at the
# bootstrap's 8192 slots with ~421 in the mask: a NaN coordinate in one
# masked-out slot (every step is refused), a 1e20 coordinate in each of
# four (one per coordinate; no sum overflows).
PADDED_CASES = ("nan_padding", "big_padding")
# More slots than a block's shared memory holds beside the residuals (25
# bytes a slot, ~8900 on an H100): the kernel keeps its compacted slots in
# a global scratch instead; ~421 in the mask, as the bootstrap's.
WIDE_CASE = "beyond_shared"


def _scene(rng, n, rv_true, t_true, k):
    """(pts1, pts2) (N, 2) pixels of N points seen by camera 1 at the
    origin and camera 2 at (rv_true, t_true), 0.5 px noise."""
    pts = rng.normal(size=(n, 3)) * [2.0, 1.5, 1.0] + [0.0, 0.0, 8.0]
    th = np.linalg.norm(rv_true)
    kx = np.array([[0, -rv_true[2], rv_true[1]], [rv_true[2], 0, -rv_true[0]], [-rv_true[1], rv_true[0], 0]])
    rot = np.eye(3) + (np.sin(th) / th if th else 1.0) * kx + ((1 - np.cos(th)) / th**2 if th else 0.5) * kx @ kx
    cam2 = pts @ rot.T + t_true

    def project(x):
        return (x[:, :2] / x[:, 2:]) * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]

    return (project(pts) + rng.normal(scale=0.5, size=(n, 2)), project(cam2) + rng.normal(scale=0.5, size=(n, 2)))


def relpose_case(name: str, b: int = 16, n: int = 128, masked: float = 0.1, outliers: float = 0.1, seed: int = 0):
    """Seeded numpy float32 inputs of one refinement call: (rvec (B, 3),
    tvec (B, 3), pts1 (N, 2), pts2 (N, 2), mask (N,) bool, K (3, 3)).
    ``name`` "scene" is a 720p two-view scene with a ``masked`` share of
    slots masked (zeros, as empty track slots) and an ``outliers`` share of
    the rest moved anywhere in image 2; starts scatter around the true pose
    (the last two far off). The edge cases (``EDGE_CASES``) use 256 points
    and 8 starts."""
    rng = np.random.default_rng(seed)
    k = np.array([[1000.0, 0.0, 640.0], [0.0, 1000.0, 360.0], [0.0, 0.0, 1.0]])
    rv_true, t_true = np.array([0.02, 0.15, -0.01]), np.array([-1.0, 0.05, 0.1])
    if name in PADDED_CASES:
        b, n, masked, outliers = 8, 8192, 1.0 - 421 / 8192, 0.2
    elif name == WIDE_CASE:
        b, n, masked, outliers = 8, 12288, 1.0 - 421 / 12288, 0.2
    elif name != "scene":
        b, n, masked, outliers = 8, 256, 0.1, 0.1
    if name == "small_angle":
        rv_true = np.zeros(3)
    if name == "near_pi":
        # Camera 2 faces camera 1 across the points: about y by pi - 1e-3.
        rv_true, t_true = np.array([0.01, math.pi - 1e-3, 0.0]), np.array([0.3, 0.0, 16.0])
    p1, p2 = _scene(rng, n, rv_true, t_true, k)
    out = rng.random(n) < outliers
    p2[out] = rng.uniform([0, 0], [1280, 720], size=(int(out.sum()), 2))
    mask = rng.random(n) >= masked
    if name == "all_masked":
        mask[:] = False
    p1[~mask] = 0.0
    p2[~mask] = 0.0
    t_unit = t_true / np.linalg.norm(t_true)
    rvec = rv_true + rng.normal(scale=0.03, size=(b, 3))
    tvec = t_unit + rng.normal(scale=0.2, size=(b, 3))
    rvec[-2:] = rng.normal(scale=1.0, size=(2, 3))
    tvec[-2:] = rng.normal(size=(2, 3))
    if name == "small_angle":
        u = np.array([0.6, -0.8, 0.0])
        rvec[:4] = [np.zeros(3), 1e-7 * u, 1e-5 * u, -1e-7 * u]
    if name == "near_pi":
        axis = rv_true / np.linalg.norm(rv_true)
        rvec[:3] = [(math.pi - 1e-4) * axis, math.pi * axis, -(math.pi - 2e-3) * axis]
    if name == "zero_t":
        tvec[:3] = 0.0
    f = np.float32
    p1, p2 = p1.astype(f), p2.astype(f)
    if name in PADDED_CASES:
        pad_slots(name[: -len("_padding")], p1, p2, mask)
    return rvec.astype(f), tvec.astype(f), p1, p2, mask, k.astype(f)


def pad_slots(kind: str, p1: np.ndarray, p2: np.ndarray, mask: np.ndarray) -> None:
    """Writes ``kind`` padding into the first masked-out slots of ``p1`` and
    ``p2`` (float32 (N, 2), in place): "nan" a NaN x in pts1 of one slot,
    "big" 1e20 in pts1 x, pts1 y, pts2 x and pts2 y of four slots, one
    each."""
    out = np.flatnonzero(~mask)
    if kind == "nan":
        p1[out[0], 0] = np.nan
    else:
        for j, (pts, c) in enumerate(((p1, 0), (p1, 1), (p2, 0), (p2, 1))):
            pts[out[j], c] = 1e20


def caller_case(label: str, seed: int = 0):
    """The seeded inputs at one caller's shape of ``CALLERS``."""
    _, b, n, masked, outliers = next(c for c in CALLERS if c[0] == label)
    return relpose_case("scene", b, n, masked, outliers, seed)


def to_device(case, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in case)


# A block's dependent steps an iteration, at most: the pose's tangents, four
# radix passes and a scan of the median, the normal equations, the solve and
# the candidate's cost; and a launch's: two compaction passes and the start's
# residuals. Block barriers likewise: five for the median, one after the
# sums, one after the cost; two for the compaction and one for the start.
ITER_STEPS = 1 + 4 + 1 + 1 + 1 + 1
LAUNCH_STEPS = 2 + 1
ITER_BARRIERS = 5 + 1 + 1
LAUNCH_BARRIERS = 2 + 1


def relpose_work(b: int, n: int, n_valid: int, iters: int = ITERS) -> Dict[str, int]:
    """Operations and bytes one call needs (see the module's note), the
    kernel's dependent steps and block barriers at most: ``b``
    candidates, ``n`` point slots, ``n_valid`` of them in the mask."""
    flops = RAY_OPS * n_valid + b * iters * (POINT_OPS * n_valid + POSE_OPS)
    nbytes = n * (2 * 8 + 1) + b * 2 * 12 + 36 + b * 2 * 12
    return {"flops": flops, "bytes": nbytes, "steps": LAUNCH_STEPS + iters * ITER_STEPS,
            "barriers": LAUNCH_BARRIERS + iters * ITER_BARRIERS}


def _spread(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B,) max |a - b| over each candidate's rvec and tvec; entries NaN on
    both sides count 0, on one side inf."""
    per = []
    for x, y in zip(a, b):
        d = (x.double() - y.double()).abs()
        d = torch.where(x.isnan() & y.isnan(), 0.0, torch.nan_to_num(d, nan=torch.inf))
        per.append(d.amax(dim=1))
    return torch.maximum(*per)


def determined(plain32: Sequence[torch.Tensor], plain64: Sequence[torch.Tensor], tol: float = 1e-5) -> torch.Tensor:
    """(B,) the candidates float32 rounding does not decide: the plain
    version's float32 result within ``tol`` of the same call in float64.
    Elsewhere 15 LM iterations amplify a rounding into another accept or
    reject and another path (far-off starts land up to 0.1 apart between
    two float32 summation orders, the JAX package's and the port's
    included), so no bound near rounding holds there."""
    return _spread(plain32, plain64).to(plain32[0].device) <= tol


def relpose_agreement(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor], held: torch.Tensor) -> Dict[str, object]:
    """How (rvec, tvec) ``got`` depart from the plain version's ``ref``:
    equal NaN patterns over every candidate, the max difference over the
    ``held`` candidates (``determined``) and, printed only, over the rest."""
    d = _spread(got, ref).to(held.device)
    return {
        "nan_equal": all(torch.equal(g.isnan(), r.isnan()) for g, r in zip(got, ref)),
        "held": int(held.sum()),
        "candidates": len(held),
        "max_held": float(d[held].max()) if held.any() else 0.0,
        "max_not_held": float(d[~held].max()) if (~held).any() else 0.0,
    }


def relpose_agrees(a: Dict[str, object], tol: float) -> bool:
    """NaN patterns equal, and the held candidates, of which there is at
    least one, within ``tol``."""
    return bool(a["nan_equal"] and a["max_held"] <= tol and a["held"] > 0)


def time_relpose(rvec, tvec, pts1, pts2, mask, k, iters: int = ITERS) -> Dict[str, object]:
    """Kernel and plain times at one input (CUDA tensors), the work and
    bound, the share of the bound reached."""
    args = (rvec, tvec, pts1, pts2, mask, k, iters)
    work = relpose_work(rvec.shape[0], pts1.shape[0], int(mask.sum()), iters)
    by_ops, by_bytes = work["flops"] / FP32_FLOPS_PER_S * 1e3, work["bytes"] / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: ransac.refine_relative_pose(*args))
    plain = time_ms(lambda: ransac.refine_relative_pose_reference(*args), reps=10)
    bound = max(by_ops, by_bytes)
    return {
        "ms": ms, "plain_ms": plain, **work, "bound_ms": bound,
        "bound_by": "operations" if by_ops >= by_bytes else "bytes", "share": bound / ms,
        "candidates": rvec.shape[0], "points": pts1.shape[0], "valid": int(mask.sum()),
    }


def describe(label: str, r: Dict[str, object]) -> str:
    return (f"refine_relpose {label} {r['candidates']} candidates x {r['points']} points ({r['valid']} in the mask): "
            f"{r['ms']:.6f} ms (plain {r['plain_ms']:.6f} ms), {r['flops']} FLOP, {r['bytes']} B, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}, share {r['share']:.5f}; dependent steps at most {r['steps']}, "
            f"block barriers at most {r['barriers']}")


def ptxas() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        return "".join(
            cuda_build.compile_source(mod.SOURCE, Path(tmp) / f"lib{i}.so", (*mod.NVCC_EXTRA, "-Xptxas", "-v"))
            for i, mod in enumerate((ransac_cuda, ransac_hyp_cuda))
        )


def raw_launch(lib: ctypes.CDLL, args) -> Callable[[], None]:
    """One launch of ``lib``'s kernel on (rvec, tvec, pts1, pts2, mask, K)
    with no checks or counting, for timing two builds alike; the first
    design's C interface (no ``refine_relpose_scratch_bytes``, a (B, N)
    float scratch) is bound too."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.refine_relpose.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.refine_relpose.restype = i
    rvec, tvec, pts1, pts2, mask, k = (t.contiguous() for t in args)
    b, n = rvec.shape[0], pts1.shape[0]
    if hasattr(lib, "refine_relpose_scratch_bytes"):
        lib.refine_relpose_scratch_bytes.argtypes = [i, i]
        lib.refine_relpose_scratch_bytes.restype = ctypes.c_size_t
        nbytes = lib.refine_relpose_scratch_bytes(b, n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=rvec.device) if nbytes else None
    else:
        scratch = torch.empty((b, n), dtype=torch.float32, device=rvec.device)
    out_r, out_t = torch.empty_like(rvec), torch.empty_like(tvec)
    ptrs = [t.data_ptr() for t in (rvec, tvec, pts1, pts2, mask, k)]
    stream = torch.cuda.current_stream(rvec.device).cuda_stream

    def run():
        code = lib.refine_relpose(*ptrs, b, n, ITERS, None if scratch is None else scratch.data_ptr(),
                                  out_r.data_ptr(), out_t.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"refine_relpose launch failed: cudaError {code}")

    run.outputs = (out_r, out_t)
    return run


def compare(source: Path, device, paths: bool) -> Dict[str, Dict[str, float]]:
    """Both libraries' kernels at the callers' seeded inputs and, with
    ``paths``, at the paths' first calls (as one launch and as their 16
    essential candidates; the other design's whole call is its two
    launches, 16 then 8, as it ran them), in turns other, this, this,
    other; prints and returns each input's two medians (ms) per turn."""
    inputs = [(label, to_device(caller_case(label), device)) for label, *_ in CALLERS]
    if paths:
        from meatmodeler_tpu_torch.tools.path_calls import record

        for path, args in record(device, ("odometry", "bootstrap", "two_view"))["relpose"].items():
            inputs.append((f"{path} essential", (args[0][:16], args[1][:16], *args[2:])))
            inputs.append((f"{path} call", args))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.compile_source(source, Path(tmp) / "other.so", ransac_cuda.NVCC_EXTRA)
        libs = {"other": ctypes.CDLL(str(Path(tmp) / "other.so")), "this": ransac_cuda.build()}
        for label, args in inputs:
            runs = {name: raw_launch(lib, args) for name, lib in libs.items()}
            if label.endswith(" call") and args[0].shape[0] > 16:
                first = raw_launch(libs["other"], (args[0][:16], args[1][:16], *args[2:]))
                rest = raw_launch(libs["other"], (args[0][16:], args[1][16:], *args[2:]))
                runs["other"] = lambda first=first, rest=rest: (first(), rest())
            times = {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                times[which].append(time_ms(runs[which]))
            out[label] = times
            n_valid = int(args[4].sum())
            bound = max(relpose_work(args[0].shape[0], args[2].shape[0], n_valid)["flops"] / FP32_FLOPS_PER_S,
                        relpose_work(args[0].shape[0], args[2].shape[0], n_valid)["bytes"] / HBM_BYTES_PER_S) * 1e3
            print(f"compare refine_relpose {label} {args[0].shape[0]} candidates x {args[2].shape[0]} points "
                  f"({n_valid} in the mask): other {[round(t * 1e3, 3) for t in times['other']]} us, this "
                  f"{[round(t * 1e3, 3) for t in times['this']]} us, bound {bound * 1e3:.3f} us")
    return out


# ---------------------------------------------------------------------------
# The hypothesis, cheirality and scoring kernels (csrc/relpose_hyp.cu).

HYP_KERNELS = ("essential_hypotheses", "homography_hypotheses", "recover_pose", "score_candidates")
# The dispatch points of one estimate_relative_pose call, in its order, and
# the kernel each launches (the homography kernel twice: its two modes).
HYP_CALLS = {
    "essential_hypotheses": "essential_hypotheses",
    "recover_pose": "recover_pose",
    "homography_hypotheses": "homography_hypotheses",
    "homography_polish": "homography_hypotheses",
    "score_candidates": "score_candidates",
}
# The paths' calls of estimate_relative_pose: (label, hypotheses, slots,
# masked share, outlier share): the odometry's 1024 hypotheses at its 128
# tracked points, the marker-free bootstrap's 2048 at 8192 track slots with
# ~421 in the mask, two-view's 2048 at 4096 match slots with ~149.
HYP_CALLERS = [
    ("odometry", 1024, 128, 0.05, 0.1),
    ("bootstrap", 2048, 8192, 1.0 - 421 / 8192, 0.2),
    ("two_view", 2048, 4096, 1.0 - 149 / 4096, 0.2),
]
# Edge cases of the seeded checks: a NaN coordinate in a slot out of the
# mask (the polish's normal matrix turns NaN, the rest is untouched), and
# refined candidates with a zero t (a failed homography decomposition's
# nan_to_num: E = 0, whose SVD is the identity).
HYP_EDGES = ("nan_padding", "zero_t")
# Operation counts (see hyp_work): a 9x9 Jacobi sweep is 36 rotations of
# ~110 (the angle's 14, seven row pairs of the matrix, nine of the vectors);
# six sweeps reach float32 rounding. A 3x3 SVD: A^T A, six sweeps of three
# rotations, the columns and their norms, the cross product: ~900.
JACOBI_SWEEPS = 6
EIG9_OPS = JACOBI_SWEEPS * 36 * 110
SVD3_OPS = 900
ESSENTIAL_SOLVE_OPS = 8 * 4 * 2 + 8 * 45 * 2 + EIG9_OPS + 2 * SVD3_OPS + 2 * 27 * 2 + 200
HOMOGRAPHY_SOLVE_OPS = 2 * 30 + 8 * 45 * 2 + EIG9_OPS + 2 * 27 * 2 + 9 + 30
SAMPSON_OPS = 28  # F x1 6, F^T x2 4 (of 6), the numerator 5, the denominator 7, floor, divide, compare
TRANSFER_OPS = 50  # two 3x3 products 30, two safe divisions 6, the squared distances 11, compare
POLISH_SLOT_OPS = 2 * TRANSFER_OPS + 2 * 2 * 45 * 2  # per slot: three transfer errors, two normal matrices
DECOMPOSE_OPS = 2000  # K^-1 H K, its SVD, eight (R, t) and their logarithms
MIDPOINT_OPS = 45
DECOMP_OPS = SVD3_OPS + 4 * 27 + 60  # an E's SVD, its two rotations, the sign
SCORE_SLOT_OPS = SAMPSON_OPS + MIDPOINT_OPS + 15 + 12 + 6


def hyp_case(label: str, seed: int = 0, device="cpu"):
    """The seeded inputs of one ``estimate_relative_pose`` call at a path's
    shape (``HYP_CALLERS``, or an edge of ``HYP_EDGES`` at the bootstrap's),
    as {dispatch point: its positional arguments} (``HYP_CALLS``): the
    draws from a generator seeded ``seed`` on ``device``; the later inputs
    (top hypotheses, best homographies, refined candidates) from the plain
    versions on ``device``, the refinement through ``refine_relative_pose``."""
    edge = label if label in HYP_EDGES else None
    _, h, n, masked, outliers = next(c for c in HYP_CALLERS if c[0] == ("bootstrap" if edge else label))
    rng = np.random.default_rng(seed)
    k = np.array([[1000.0, 0.0, 640.0], [0.0, 1000.0, 360.0], [0.0, 0.0, 1.0]])
    p1, p2 = _scene(rng, n, np.array([0.02, 0.15, -0.01]), np.array([-1.0, 0.05, 0.1]), k)
    out = rng.random(n) < outliers
    p2[out] = rng.uniform([0, 0], [1280, 720], size=(int(out.sum()), 2))
    mask = rng.random(n) >= masked
    p1[~mask] = 0.0
    p2[~mask] = 0.0
    f = np.float32
    p1, p2 = p1.astype(f), p2.astype(f)
    if edge == "nan_padding":
        pad_slots("nan", p1, p2, mask)
    pts1, pts2, m, kk = (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (p1, p2, mask, k.astype(f)))
    g = torch.Generator(device=device).manual_seed(seed)
    thr2 = (1.5 / (0.5 * (kk[0, 0] + kk[1, 1]))) ** 2
    idx8 = ransac.sample_subsets(m, h, 8, g)
    es, counts = ransac.essential_hypotheses_reference(pts1, pts2, m, kk, idx8, thr2)
    top = torch.sort(counts, descending=True, stable=True).indices[:16]
    rvs, tvs, _ = ransac.recover_pose_reference(es[top], pts1, pts2, m, kk, thr2)
    idx4 = ransac.sample_subsets(m, 1024, 4, g)
    hs, hcounts = ransac.homography_hypotheses_reference(pts1, pts2, m, idx4, 3.0)
    _, _, _, rv_h, tv_h = ransac.homography_polish_reference(pts1, pts2, m, hs, hcounts, 3.0, kk)
    rv, tv = ransac.refine_relative_pose(torch.cat([rvs, rv_h.nan_to_num()]), torch.cat([tvs, tv_h.nan_to_num()]),
                                         pts1, pts2, m, kk)
    if edge == "zero_t":
        tv = tv.clone()
        tv[16:] = 0.0
    return {
        "essential_hypotheses": (pts1, pts2, m, kk, idx8, thr2),
        "recover_pose": (es[top], pts1, pts2, m, kk, thr2),
        "homography_hypotheses": (pts1, pts2, m, idx4, 3.0),
        "homography_polish": (pts1, pts2, m, hs, hcounts, 3.0, kk),
        "score_candidates": (rv, tv, pts1, pts2, m, kk, thr2),
    }


def hyp_call_case(name: str, call) -> tuple:
    """A recorded call of ``ransac.<name>`` (a dispatch point of
    ``HYP_CALLS``) as the positional arguments of its plain version."""
    bound = inspect.signature(getattr(ransac, f"{name}_reference")).bind(*call[0], **call[1])
    bound.apply_defaults()
    return tuple(bound.arguments.values())


# Where each dispatch point's arguments hold the mask and the stack of
# hypotheses or candidates.
_MASK_ARG = {"essential_hypotheses": 2, "homography_hypotheses": 2, "homography_polish": 2, "recover_pose": 3,
             "score_candidates": 4}
_ITEMS_ARG = {"essential_hypotheses": 4, "homography_hypotheses": 3, "homography_polish": 3, "recover_pose": 0,
              "score_candidates": 0}


def hyp_work(name: str, args) -> Dict[str, int]:
    """Operations and bytes one call of dispatch point ``name`` needs on
    ``args``: the solves per hypothesis (``ESSENTIAL_SOLVE_OPS``,
    ``HOMOGRAPHY_SOLVE_OPS``; the polish two 9x9 eigen-solves and the
    decomposition) and, per slot in the mask, each hypothesis' consensus
    test (``SAMPSON_OPS``, ``TRANSFER_OPS``), the polish's transfer errors
    and normal matrices, a candidate's four midpoint triangulations and
    votes (recover_pose: the Sampson gate too), and a scored candidate's
    Sampson residual, triangulation and reprojection (its vote counted for
    the slots in the mask: the inliers are a data-dependent subset, so this
    is an upper bound within one vote's work a slot). Bytes: inputs read
    once, outputs written once."""
    mask = args[_MASK_ARG[name]]
    n = mask.shape[-1]
    valid = int(mask.sum()) if mask.ndim == 1 else int(mask.sum()) // max(1, mask.shape[0])
    fb = args[0].element_size()
    pts = 2 * n * 2 * fb + n + 9 * fb
    if name == "essential_hypotheses":
        h = args[4].shape[0]
        return {"flops": h * (ESSENTIAL_SOLVE_OPS + SAMPSON_OPS * valid), "bytes": pts + h * 64 + fb + h * (9 * fb + 8)}
    if name == "homography_hypotheses":
        h = args[3].shape[0]
        return {"flops": h * (HOMOGRAPHY_SOLVE_OPS + TRANSFER_OPS * valid), "bytes": pts + h * 32 + h * (9 * fb + 8)}
    if name == "homography_polish":
        h = args[3].shape[0]
        return {"flops": h + POLISH_SLOT_OPS * valid + 2 * EIG9_OPS + DECOMPOSE_OPS,
                "bytes": pts + h * (9 * fb + 8) + 9 * fb + n * (fb + 1) + 48 * fb}
    if name == "recover_pose":
        b = args[0].shape[0]
        return {"flops": b * (DECOMP_OPS + valid * (SAMPSON_OPS + 4 * MIDPOINT_OPS)),
                "bytes": pts + b * 9 * fb + (b - 1) * n * (mask.ndim == 2) + fb + b * (6 * fb + 32)}
    c = args[0].shape[0]
    return {"flops": c * (50 + DECOMP_OPS + 100 + valid * (SCORE_SLOT_OPS + 4 * MIDPOINT_OPS)),
            "bytes": pts + c * 6 * fb + fb + c * (8 + fb + 6 * fb + 9 * fb + n * (fb + 1))}


def _plain_of(name: str):
    return getattr(ransac, f"{name}_reference")


def _kernel_of(name: str):
    return getattr(ransac_hyp_cuda, name)


def time_hyp(name: str, args, plain_reps: int = 5) -> Dict[str, object]:
    """The kernel's and the plain version's times at one call of dispatch
    point ``name`` (CUDA tensors), the work, bound and share reached."""
    work = hyp_work(name, args)
    by_ops, by_bytes = work["flops"] / FP32_FLOPS_PER_S * 1e3, work["bytes"] / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: _kernel_of(name)(*args))
    plain = time_ms(lambda: _plain_of(name)(*args), reps=plain_reps)
    bound = max(by_ops, by_bytes)
    mask = args[_MASK_ARG[name]]
    return {"ms": ms, "plain_ms": plain, **work, "bound_ms": bound,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes", "share": bound / ms,
            "items": args[_ITEMS_ARG[name]].shape[0], "points": mask.shape[-1], "valid": int(mask.reshape(-1, mask.shape[-1])[0].sum())}


def time_eigh_stack(args) -> float:
    """``torch.linalg.eigh`` of the (H, 9, 9) normal matrices the essential
    kernel solves (a yardstick for its eigen part alone), ms."""
    pts1, pts2, mask, k, idx, _ = args
    n1h, _ = ransac._normalize(ransac._rays(pts1, k), mask)
    n2h, _ = ransac._normalize(ransac._rays(pts2, k), mask)
    a = ransac._design_rows(n1h[idx], n2h[idx])
    ata = a.transpose(-1, -2) @ a
    return time_ms(lambda: torch.linalg.eigh(ata), reps=10)


def describe_hyp(label: str, name: str, r: Dict[str, object]) -> str:
    return (f"{name} {label} {r['items']} x {r['points']} slots ({r['valid']} in the mask): {r['ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f} ms), {r['flops']} FLOP, {r['bytes']} B, bound {r['bound_ms']:.6f} ms by "
            f"{r['bound_by']}, share {r['share']:.5f}")


def _as64(args) -> tuple:
    return tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).double()


def _both_nan(a, b):
    return a.isnan().all(1) & b.isnan().all(1)


def sign_spread(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) max |a - b| over each row, up to the row's sign; rows NaN on
    both sides count 0, a NaN on one side inf."""
    a, b = _rows(a), _rows(b.to(a.device))
    d = torch.minimum((a - b).abs().amax(1), (a + b).abs().amax(1)).nan_to_num(nan=torch.inf)
    return torch.where(_both_nan(a, b), 0.0, d)


def rel_spread(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) max |a - b| over each row relative to the row's largest |b|."""
    a, b = _rows(a), _rows(b.to(a.device))
    d = ((a - b).abs().amax(1) / b.abs().amax(1)).nan_to_num(nan=torch.inf)
    return torch.where(_both_nan(a, b), 0.0, d)


def _unique_null(ata: torch.Tensor) -> torch.Tensor:
    """(H,) the (H, 9, 9) normal matrices (float64) whose least eigenvalue
    is alone: the second least above 1e-9 of the largest. A sample with a
    repeated slot has a null space of two or more, where every solver
    returns its own vector of it."""
    w = torch.linalg.eigvalsh(ata)
    return w[:, 1] > 1e-9 * w[:, -1]


def _sampson_normal(args64) -> torch.Tensor:
    pts1, pts2, mask, k, idx, _ = args64
    n1h, _ = ransac._normalize(ransac._rays(pts1, k), mask)
    n2h, _ = ransac._normalize(ransac._rays(pts2, k), mask)
    a = ransac._design_rows(n1h[idx], n2h[idx])
    return a.transpose(-1, -2) @ a


def _dlt_normal(args64) -> torch.Tensor:
    pts1, pts2, _, idx, _ = args64
    src, _ = homography.normalize_points(pts1[idx])
    dst, _ = homography.normalize_points(pts2[idx])
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ru = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    rv = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    d = torch.cat([ru, rv], -2)
    return d.transpose(-1, -2) @ d


def _decided_counts(d: torch.Tensor, mask: torch.Tensor, thr2: float, band: float):
    """(H,) counts of (d < thr2) & mask, and whether each is decided: no
    slot in the mask within ``band`` of thr2, relative."""
    inside = ((d < thr2) & mask).sum(1)
    near = (((d - thr2).abs() <= band * thr2) & mask).any(1)
    return inside, ~near


def essential_agreement(args, got, got64, ref, ref64) -> Dict[str, object]:
    """The essential kernel's (es, counts) in float32 (``got``) and float64
    (``got64``) against the plain version's (``ref``, ``ref64``) at
    ``args``. Held hypotheses: the plain version's float32 es within 1e-5
    of its float64 es (up to sign), and a unique null vector
    (``_unique_null``). On them es up to sign (float32 1e-4, float64 1e-8).
    Counts exactly: each kernel's counts against the float64 count of its
    own es, wherever no slot in the mask lies within 1e-4 (float64: 1e-9)
    of the gate, relative (there rounding decides); the kernel's float32
    counts against the plain version's on the held hypotheses are printed."""
    a64 = _as64(args)
    pts1, pts2, mask, k, idx, thr2 = a64
    held = (sign_spread(ref[0], ref64[0]) <= 1e-5) & _unique_null(_sampson_normal(a64)).to(ref[0].device)
    x1 = ransac._homog(ransac._rays(pts1, k))
    x2 = ransac._homog(ransac._rays(pts2, k))
    wrong = []
    for es, counts, band in ((got[0], got[1], 1e-4), (got64[0], got64[1], 1e-9)):
        recount, decided = _decided_counts(ransac._sampson(es.double(), x1, x2), mask, float(thr2), band)
        wrong.append(int(((recount != counts) & decided).sum()))
    d32, d64 = sign_spread(got[0], ref[0]), sign_spread(got64[0], ref64[0])
    nan_equal = all(torch.equal(g.isnan().any(-1).any(-1), r.isnan().any(-1).any(-1))
                    for g, r in ((got[0], ref[0]), (got64[0], ref64[0])))
    return {
        "hypotheses": len(held), "held": int(held.sum()), "nan_equal": nan_equal,
        "max_held": float(d32[held].max()) if held.any() else 0.0,
        "max_held_f64": float(d64[held].max()) if held.any() else 0.0,
        "counts_wrong": wrong[0], "counts_wrong_f64": wrong[1],
        "counts_equal_plain_held": float((got[1] == ref[1])[held].float().mean()) if held.any() else 1.0,
    }


def homography_agreement(args, got, got64, ref, ref64) -> Dict[str, object]:
    """The homography kernel's hypotheses (hs, counts) against the plain
    version's, as ``essential_agreement``: held where the plain version's
    float32 H lies within 1e-5 of its float64 H relative to its largest
    entry and the 4-point DLT has a unique null vector; H relative (float32
    1e-4, float64 1e-8). Counts exactly against the float64 count of each
    kernel's own H wherever no slot in the mask lies within 1e-3 (float64
    1e-9) of the gate, on the hypotheses whose H has a condition number
    below 1e6: the backward transfer goes through H's inverse, and beyond
    that float32 rounding moves a transfer error near the gate by more than
    1e-3 of it (by up to 40% at 1e7-1e9, the pixel homographies of
    degenerate samples). NaN patterns equal on the samples with a unique
    null vector."""
    a64 = _as64(args)
    pts1, pts2, mask, _, threshold = a64
    unique = _unique_null(_dlt_normal(a64)).to(ref[0].device)
    held = (rel_spread(ref[0], ref64[0]) <= 1e-5) & unique
    wrong, decided_n = [], []
    for hs, counts, band in ((got[0], got[1], 1e-3), (got64[0], got64[1], 1e-9)):
        h64 = hs.double()
        d = ransac._homography_transfer_sq(h64, pts1, pts2)
        recount, decided = _decided_counts(d, mask, threshold * threshold, band)
        decided = decided & (torch.linalg.cond(torch.nan_to_num(h64)) < 1e6)
        wrong.append(int(((recount != counts) & decided).sum()))
        decided_n.append(int(decided.sum()))
    d32, d64 = rel_spread(got[0], ref[0]), rel_spread(got64[0], ref64[0])
    return {
        "hypotheses": len(held), "held": int(held.sum()),
        # A sample with a repeated slot has no unique H: h22 of the null
        # vector a solver picks may be 0, and H / h22 NaN in one solver only.
        "nan_equal": all(torch.equal(g.isnan().any(-1).any(-1)[unique], r.isnan().any(-1).any(-1)[unique])
                         for g, r in ((got[0], ref[0]), (got64[0], ref64[0]))),
        "max_held": float(d32[held].max()) if held.any() else 0.0,
        "max_held_f64": float(d64[held].max()) if held.any() else 0.0,
        "counts_decided": decided_n[0], "counts_wrong": wrong[0], "counts_wrong_f64": wrong[1],
        "counts_equal_plain_held": float((got[1] == ref[1])[held].float().mean()) if held.any() else 1.0,
    }


def _set_spread(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max over the rows of a of the distance to the nearest row of b, and
    the other way round (the 8 decompositions come in an order that
    depends on the SVD's signs)."""
    a, b = _rows(a), _rows(b.to(a.device))
    if torch.equal(a.isnan(), b.isnan()) and a.isnan().all():
        return 0.0
    d = (a[:, None, :] - b[None, :, :]).abs().amax(-1).nan_to_num(nan=torch.inf)
    return float(max(d.amin(1).max(), d.amin(0).max()))


def polish_agreement(args, got, got64, ref, ref64) -> Dict[str, object]:
    """The polish (mode 1) against the plain version's: H by what it does to
    the plain version's inliers (the largest difference of the mapped
    points, px; the DLT in raw pixels leaves H's small entries to
    rounding), inliers and residuals (relative, in the mask), and the 8
    decompositions as sets (rvec and unit t rows). Held when the plain
    version's float32 and float64 H map its inliers within 1e-3 px of each
    other and keep the same inliers: then the kernel's float32 H within
    1e-2 px, the same inliers, residuals within 1e-3 and decompositions
    within 1e-3. The float64 results (within 1e-6 px, 1e-9 and 1e-6) are
    held where the kernel's own float32 and float64 agree so as well: the
    pixel normal matrix's condition (1e12 and beyond) leaves even a float64
    eigenvector to rounding, and then one float64 solver's polish gains
    consensus and is kept where another's is refused (two-view's call:
    2.8 px apart, while both float32 polishes were refused alike)."""
    pts1, mask = args[0], args[2]

    def mapped(h, inl):
        q = torch.cat([pts1.double(), torch.ones_like(pts1[:, :1]).double()], 1)[inl]
        m = q @ h.double().T
        return m[:, :2] / m[:, 2:]

    def stable(a32, a64):
        near = bool((mapped(a32[0], inl) - mapped(a64[0], inl)).abs().max() <= 1e-3) if inl.any() else True
        return near and torch.equal(a32[2], a64[2])

    inl = ref[2]
    held = stable(ref, ref64)
    held64 = held and stable(got, got64)
    out = {"held": held, "held_f64": held64, "inliers": int(inl.sum())}
    for tag, g, r in (("", got, ref), ("_f64", got64, ref64)):
        px = float((mapped(g[0], r[2]) - mapped(r[0], r[2])).abs().max()) if r[2].any() else 0.0
        fin = mask & torch.isfinite(r[1])
        res = float(((g[1].double() - r[1].double()).abs() / r[1].double().abs().clamp(min=1.0))[fin].max()) \
            if fin.any() else 0.0
        dec = max(_set_spread(g[3], r[3]), _set_spread(g[4], r[4])) if g[3] is not None else 0.0
        out.update({f"map_px{tag}": px, f"inliers_differ{tag}": int((g[2] != r[2]).sum()), f"res{tag}": res,
                    f"decompositions{tag}": dec,
                    f"inf_equal{tag}": bool(torch.equal(torch.isinf(g[1]), torch.isinf(r[1])))})
    return out


def _unique_top(votes: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(votes, 2, dim=-1).values
    return top2[..., 0] > top2[..., 1]


def _pose_spread(a, b) -> torch.Tensor:
    """(B,) max |a - b| over the rows of each pair of (B, k) tensors; NaN on
    both sides counts 0, on one side inf."""
    per = [torch.where(x.isnan() & y.to(x.device).isnan(), 0.0,
                       (x.double() - y.to(x.device).double()).abs().nan_to_num(nan=torch.inf)).amax(-1)
           for x, y in zip(a, b)]
    return functools.reduce(torch.maximum, per)


def recover_agreement(args, got, got64, ref, ref64) -> Dict[str, object]:
    """The cheirality kernel's (rv, tv, votes) against the plain version's.
    Held candidates: the plain version's float32 pose within 1e-5 of its
    float64 pose and a single most-voted decomposition (a tie leaves the
    pick to the SVD's signs). On them the pose after the vote, rv and tv,
    within 1e-4 (float64 1e-8). The votes themselves are reported, not
    held: the depth signs of low-parallax points (a near-singular 2x2
    midpoint solve) and Sampson distances at the gate are decided by
    rounding, differently in any two float32 solvers (at the odometry's
    first step, one frame apart, by up to 7 votes between the plain
    version's own float32 and float64); ``votes_off`` counts the held
    candidates whose sorted votes differ by more than 1% of the most (at
    least 1) plus twice that own spread."""
    held = (_pose_spread(ref[:2], ref64[:2]) <= 1e-5) & _unique_top(ref64[2]).to(ref[0].device)
    spread = (torch.sort(ref[2], -1).values - torch.sort(ref64[2].to(ref[2].device), -1).values).abs().amax(-1)
    out = {"candidates": len(held), "held": int(held.sum()), "votes_plain_f32_f64": int(spread.max())}
    for tag, g, r, own in (("", got, ref, spread), ("_f64", got64, ref64, torch.zeros_like(spread))):
        d = _pose_spread(g[:2], r[:2])
        sv = (torch.sort(g[2], -1).values - torch.sort(r[2], -1).values).abs().amax(-1)
        allowed = torch.clamp(r[2].amax(-1) // 100, min=1) + 2 * own.to(sv.device)
        out[f"max_held{tag}"] = float(d[held].max()) if held.any() else 0.0
        out[f"votes_max_diff{tag}"] = int(sv.max())
        out[f"votes_off{tag}"] = int((sv > allowed)[held].sum())
        out[f"nan_equal{tag}"] = all(torch.equal(x.isnan(), y.isnan()) for x, y in zip(g[:2], r[:2]))
    return out


def _reprojection(args, rvd, tvd) -> torch.Tensor:
    """(C, N) score_candidates_reference's rmax of each slot under (rvd,
    tvd), in ``args``' type."""
    _, _, pts1, pts2, _, k, _ = args
    n1, n2 = ransac._rays(pts1, k), ransac._rays(pts2, k)
    rd = so3.exp(rvd.to(pts1.dtype))
    x3, z1, z2 = ransac._triangulate_midpoint(rd, tvd.to(pts1.dtype), n1, n2)
    xc2 = torch.einsum("cij,cnj->cni", rd, x3) + tvd.to(pts1.dtype)[:, None, :]
    safe1 = torch.where(torch.abs(z1) > 1e-9, z1, torch.full_like(z1, 1e-9))
    safe2 = torch.where(torch.abs(z2) > 1e-9, z2, torch.full_like(z2, 1e-9))
    r1 = torch.sum((x3[..., :2] / safe1[..., None] - n1) ** 2, dim=-1)
    r2 = torch.sum((xc2[..., :2] / safe2[..., None] - n2) ** 2, dim=-1)
    return torch.maximum(r1, r2)


def score_agreement(args, got, got64, ref, ref64) -> Dict[str, object]:
    """The scoring kernel's outputs against the plain version's. Held
    candidates: the plain version's float32 (rvd, tvd) within 1e-5 of its
    float64 ones, the same good count in both, a single most-voted
    decomposition in its cheirality vote (recounted in float64), and no
    slot in the mask whose float64 reprojection error lies closer to its
    gate than 1e-3 of it plus four times the plain version's own float32
    error at that slot (there rounding decides ``good``: a midpoint of
    near-parallel rays loses most of its digits in float32). On them rvd, tvd and E
    within 1e-4 (float64 1e-8), good counts equal, the truncated cost within
    1e-2 relative or twice the plain version's own float32 / float64 spread
    at the call, whichever is larger (float64 1e-9: it sums float32 midpoint
    triangulations of narrow-baseline rays, whose 2x2 solves lose digits;
    2e-2 apart in the plain version itself at the odometry's first step).
    On every candidate:
    Sampson residuals within 1e-3 of (the gate + the residual) in the mask
    (float64 1e-9), the same infinities, and inliers equal wherever the
    float64 residual is further than 1e-4 of the gate from it."""
    mask, thr2 = args[4], args[6]
    a64 = _as64(args)
    votes = ransac.recover_pose_reference(ref64[4], a64[2], a64[3], ref64[6], a64[5])[2]
    thr = float(thr2)
    rmax = _reprojection(a64, ref64[2], ref64[3])
    own = (_reprojection(args, ref[2], ref[3]).double() - rmax).abs().nan_to_num(nan=torch.inf)
    near_gate = (((rmax - 4.0 * thr).abs() <= 1e-3 * 4.0 * thr + 4.0 * own) & a64[4]).any(1)
    held = ((_pose_spread(ref[2:4], ref64[2:4]) <= 1e-5) & (ref[0] == ref64[0].to(ref[0].device))
            & _unique_top(votes).to(ref[0].device) & ~near_gate.to(ref[0].device))
    out = {"candidates": len(held), "held": int(held.sum())}
    plain_msac = (ref[1].double() - ref64[1]).abs() / ref64[1].abs().clamp(min=1e-30)
    out["msac_plain_f32_f64"] = float(plain_msac[held].max()) if held.any() else 0.0
    for tag, g, r in (("", got, ref), ("_f64", got64, ref64)):
        d = torch.maximum(_pose_spread(g[2:4], r[2:4]), _pose_spread((g[4].flatten(1),), (r[4].flatten(1),)))
        fin = mask & torch.isfinite(r[5])
        res = (g[5].double() - r[5].double()).abs() / (thr + r[5].double().abs())
        near = (ref64[5] - thr).abs() <= 1e-4 * thr
        msac = (g[1].double() - r[1].double()).abs() / r[1].double().abs().clamp(min=1e-30)
        out.update({
            f"max_held{tag}": float(d[held].max()) if held.any() else 0.0,
            f"good_differ{tag}": int((g[0] != r[0])[held].sum()),
            f"msac{tag}": float(msac[held].max()) if held.any() else 0.0,
            f"res{tag}": float(res[fin].max()) if fin.any() else 0.0,
            f"inf_equal{tag}": bool(torch.equal(torch.isinf(g[5]), torch.isinf(r[5]))),
            f"inliers_differ{tag}": int(((g[6] != r[6]) & ~near.to(g[6].device)).sum()),
        })
    return out


AGREEMENT = {
    "essential_hypotheses": essential_agreement,
    "homography_hypotheses": homography_agreement,
    "homography_polish": polish_agreement,
    "recover_pose": recover_agreement,
    "score_candidates": score_agreement,
}
# Float32 and float64 bounds of each agreement's held figures.
HYP_TOL = {"essential": (1e-4, 1e-8), "homography": (1e-4, 1e-8), "polish_px": (1e-2, 1e-6), "res": (1e-3, 1e-9),
           "decompositions": (1e-3, 1e-6), "pose": (1e-4, 1e-8)}


def hyp_agrees(name: str, a: Dict[str, object], need_held: bool = True) -> bool:
    """Whether agreement ``a`` of dispatch point ``name`` meets its bounds
    (see each ``*_agreement``). With ``need_held`` (the seeded cases) the
    essential and homography hypotheses, the cheirality vote and the scores
    need at least one held item; a path's own call may hold none (at the
    odometry's first step, two frames apart, float32 rounding decides every
    8-point hypothesis), and its counts, NaN patterns and infinities are
    held all the same."""
    held = a["held"] > 0 or not need_held
    t32, t64 = HYP_TOL["pose"]
    if name in ("essential_hypotheses", "homography_hypotheses"):
        t32, t64 = HYP_TOL["essential" if name == "essential_hypotheses" else "homography"]
        return bool(held and a["nan_equal"] and a["max_held"] <= t32 and a["max_held_f64"] <= t64
                    and a["counts_wrong"] == 0 and a["counts_wrong_f64"] == 0)
    if name == "homography_polish":
        ok = bool(a["inf_equal"] and a["inf_equal_f64"])
        for i, tag in enumerate(("", "_f64")):
            if a["held" + tag]:
                ok = ok and a["inliers_differ" + tag] == 0 and all(
                    a[f"{key}{tag}"] <= HYP_TOL[tol][i]
                    for key, tol in (("map_px", "polish_px"), ("res", "res"), ("decompositions", "decompositions")))
        return ok
    if name == "recover_pose":
        return bool(held and a["max_held"] <= t32 and a["max_held_f64"] <= t64 and a["nan_equal"]
                    and a["nan_equal_f64"])
    return bool(held and a["max_held"] <= t32 and a["max_held_f64"] <= t64 and a["good_differ"] == 0
                and a["good_differ_f64"] == 0 and a["msac"] <= max(1e-2, 2.0 * a["msac_plain_f32_f64"])
                and a["msac_f64"] <= 1e-9
                and a["res"] <= HYP_TOL["res"][0] and a["res_f64"] <= HYP_TOL["res"][1] and a["inf_equal"]
                and a["inf_equal_f64"] and a["inliers_differ"] == 0 and a["inliers_differ_f64"] == 0)


def hyp_agreement(name: str, args) -> Dict[str, object]:
    """Dispatch point ``name``'s kernel (one launch of its wrapper, in
    float32 and float64) against its plain version at ``args`` (CUDA
    tensors), by ``AGREEMENT[name]``."""
    kernel, plain = _kernel_of(name), _plain_of(name)
    got, ref = kernel(*args), plain(*args)
    got64, ref64 = kernel(*_as64(args)), plain(*_as64(args))
    return AGREEMENT[name](args, got, got64, ref, ref64)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--compare", type=Path, default=None)
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("relpose_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.ptxas:
        print(ptxas())
    ransac_cuda.build()
    ransac_hyp_cuda.build()
    for label, *_ in CALLERS:
        print(describe(label, time_relpose(*to_device(caller_case(label), dev))))
    for label, *_ in HYP_CALLERS:
        case = hyp_case(label, device=dev)
        for name, call in case.items():
            print(describe_hyp(label, name, time_hyp(name, call)))
        print(f"torch.linalg.eigh of the {label} call's (H, 9, 9) normal matrices (the essential kernel's eigen "
              f"part alone): {time_eigh_stack(case['essential_hypotheses']):.6f} ms")
    if args.compare is not None:
        compare(args.compare, dev, args.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
