"""Time the relative-pose refinement CUDA kernel against its bound on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.relpose_bench [--ptxas]

At the shapes of ``refine_relative_pose``'s three callers, on seeded
two-view scenes (``relpose_case``): the odometry's (16 essential and 8
homography candidates, 128 points), the marker-free bootstrap's (16
candidates, 8192 track slots, 40% of them masked, 20% of the rest
outliers) and two-view's (8 candidates, 4096 match slots, 96% padding):
the kernel's device time, its plain PyTorch version's, the work the call
needs, the bound it sets and the share of it reached. Times are
``clahe_bench.time_ms``'s: medians with a cold L2 and the host's launch
time hidden (25 calls of the kernel, 10 of the plain version, which takes
~100 ms a call).

The work (``relpose_work``) is counted for the points that enter the fit,
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
depends on the last, and one iteration is a chain of 8 block-wide phases
(pose, residuals, four radix passes of the median, normal equations and
solve, candidate cost and accept), 9 where the median of an even count
needs its upper middle from a fifth pass; ``steps`` gives that chain's
length for the call.

  --ptxas  compiles ``csrc/relpose.cu`` once more with ``-Xptxas -v`` and
           prints the kernel's registers, shared memory and spills.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from meatmodeler_tpu_torch.geometry import ransac, ransac_cuda
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.tools.clahe_bench import HBM_BYTES_PER_S, time_ms

FP32_FLOPS_PER_S = 67e12  # one H100 SXM, float32 outside the tensor cores
ITERS = 15  # refine_relative_pose's default, which every caller takes
RAY_OPS = 8
POINT_OPS = 35 + 6 * 42 + 13 + 57 + 38  # per point that enters the fit, per candidate and iteration
POSE_OPS = 700  # per candidate and iteration
# The callers' shapes: (label, candidates, points, masked share, outlier share).
CALLERS = [
    ("odometry", 16, 128, 0.1, 0.1),
    ("odometry_h", 8, 128, 0.1, 0.1),
    ("bootstrap", 16, 8192, 0.4, 0.2),
    ("two_view", 8, 4096, 0.96, 0.2),
]
# Edge cases of phase 3c and the CPU tests: the start poses' rvec (the
# so3.exp Taylor branch at 0 and 1e-7, the closed form with cancellation at
# 1e-5), a relative rotation near pi, zero tvec starts (a failed homography
# decomposition's nan_to_num), and a mask with nothing in it.
EDGE_CASES = ("small_angle", "near_pi", "zero_t", "all_masked")


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
    if name != "scene":
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
    return rvec.astype(f), tvec.astype(f), p1.astype(f), p2.astype(f), mask, k.astype(f)


def caller_case(label: str, seed: int = 0):
    """The seeded inputs at one caller's shape of ``CALLERS``."""
    _, b, n, masked, outliers = next(c for c in CALLERS if c[0] == label)
    return relpose_case("scene", b, n, masked, outliers, seed)


def to_device(case, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in case)


def relpose_work(b: int, n: int, n_valid: int, iters: int = ITERS) -> Dict[str, int]:
    """Operations and bytes one call needs (see the module's note), and the
    dependent steps: ``b`` candidates, ``n`` point slots, ``n_valid`` of
    them in the mask."""
    flops = RAY_OPS * n_valid + b * iters * (POINT_OPS * n_valid + POSE_OPS)
    nbytes = n * (2 * 8 + 1) + b * 2 * 12 + 36 + b * 2 * 12
    phases = 8 + (1 if n_valid % 2 == 0 and n_valid > 0 else 0)
    return {"flops": flops, "bytes": nbytes, "steps": iters * phases}


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
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}, share {r['share']:.5f}; dependent steps {r['steps']}")


def ptxas() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        return cuda_build.compile_source(
            ransac_cuda.SOURCE, Path(tmp) / "lib.so", (*ransac_cuda.NVCC_EXTRA, "-Xptxas", "-v")
        )


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("relpose_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.ptxas:
        print(ptxas())
    ransac_cuda.build()
    for label, *_ in CALLERS:
        print(describe(label, time_relpose(*to_device(caller_case(label), dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
