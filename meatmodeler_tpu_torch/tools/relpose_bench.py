"""Time the relative-pose refinement CUDA kernel against its bound on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.relpose_bench [--ptxas] [--compare SOURCE [--paths]]

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
depends on the last, and each is a chain of dependent steps of the
candidate's block (the pose's tangents; the median's radix passes, at
most four, and its scan; the normal equations; the 6x6 solve; the
candidate's cost), after the launch's compaction (two passes over the
slots) and the start's residuals; ``steps`` gives that chain's length at
most for the call, ``barriers`` its block barriers at most (one a median
pass and its scan, one after the sums, one after the cost; a refused step
leaves only the last).

  --ptxas    compiles ``csrc/relpose.cu`` once more with ``-Xptxas -v``
             and prints the kernel's registers, shared memory and spills.
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
import math
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

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
        return cuda_build.compile_source(
            ransac_cuda.SOURCE, Path(tmp) / "lib.so", (*ransac_cuda.NVCC_EXTRA, "-Xptxas", "-v")
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
    for label, *_ in CALLERS:
        print(describe(label, time_relpose(*to_device(caller_case(label), dev))))
    if args.compare is not None:
        compare(args.compare, dev, args.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
