"""Time the board geometry's three CUDA kernels against their bounds on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.geometry_bench [--ptxas] [--launches] [--compare OTHER_DIR [--paths]]

The kernels: ``obs_jacobians`` (``csrc/ba_jac.cu``, one launch per BA LM
iteration), ``pnp_refine`` (``csrc/pnp.cu``, one launch per
``solve_pnp_batch``) and ``calib_lm`` (``csrc/calib.cu``, one launch per
calibration LM run). At seeded inputs of their callers' shapes (the known
path's 22 keyframes of a (4, 3) board at the pass-2 resolution 960x540,
its pose-only and global BA problems, a batch of 8 lanes; the PnP cases
``pnp_refine_case`` builds): each
kernel's device time, its plain PyTorch version's, the work the call needs,
the bound it sets and the share of it reached. Times are
``clahe_bench.time_ms``'s: medians with a cold L2 and the host's launch
time hidden (25 calls of a kernel, 5 of a plain version).

Work is what the function needs, not what the kernels' code does: each
arithmetic operation, comparison, sqrt, sin or cos one; one branch of each
choice (the rotation's closed form; its Taylor branch costs less); nothing
for a tangent that is zero; K upper triangular with last row (0, 0, 1), as
every caller's is; each sum over a point's two residual rows 2 products and
2 additions. The pieces:

- ``ROT_VALUE_OPS``: R from one rvec (theta^2 5, theta, sin, cos 3, the two
  coefficients 3, K^2 as r r^T - theta^2 I 9, R = I + aK + bK^2 24);
  ``ROT_OPS`` adds its three derivatives dR/drvec_k (the coefficients'
  derivatives 15, then 9 entries of 6 operations per k), once per camera
  or start and iteration, never per point;
- ``POINT_OPS``: R p + t (18) and the divide (1/z and two products);
  ``PIN_OPS``: the K product (u 4, v 2); ``PIN_DPC_OPS``: d(u, v)/dp_c (7);
  ``ROT_COL_OPS``: the three rotation columns, dp_c/drvec (45) through
  d(u, v)/dp_c (30); ``POINT_COL_OPS``: d(u, v)/dp_c R, the point columns
  (30); the translation's columns are d(u, v)/dp_c itself;
- ``obs_jacobians``: ``ROT_OPS`` per camera; per observation in the mask
  ``BA_OBS_OPS`` (the above and mask * weight times the 18 entries). Bytes:
  the cameras, points and K read once, the indices, mask and weight, and
  the (2, 6) + (2, 3) rows of every observation written;
- ``pnp_refine``: per start and iteration ``ROT_OPS``, per point
  ``PNP_POINT_OPS`` (the projection, its residual, d(u, v)/dp_c, the rotation
  columns and the 27 sums of J^T J and J^T r), and the damped 6x6 solve and
  update ``PNP_SOLVE_OPS`` (Cholesky with its roots, two triangular solves);
  then the final cost. Bytes: the starts, the board, the pixels and K read
  once; poses and costs written once;
- ``calib_lm``: per iteration and view in the mask ``ROT_OPS`` and the rows
  of its points (``calib_row_ops``: the projection with the ``num_dist``
  distortion terms of the call's layout, the residual, the distortion's 2x2
  Jacobian, d(u, v)/dp_c, the rotation columns, ``num_dist`` distortion
  columns, the focal and centre columns free, and the sums of the view's
  6x6 block, its 6 x n_intr cross block, the intrinsics' block and both
  right-hand sides); per damping trial and view the damped 6x6 block's
  Cholesky, n_intr + 1 solves, its Schur terms, the back-substitution, the
  candidate and its cost; per trial the intrinsics' Schur solve; the accept
  rule; counted for the iterations the call ran (the kernel reports them),
  plus the starting cost. Bytes: theta0, the pixels and the board read once;
  theta and the cost written once.

The bound is the larger of operations at 67 TFLOP/s (float32 outside the
tensor cores) and bytes at 3.35 TB/s. None of the three reaches it: each
is a chain of dependent steps (``steps``: for the LM, 4 stretches an
iteration and the start, ``barriers`` the block barriers among them), which
sets its time.

  --ptxas    compiles the three sources once more with ``-Xptxas -v`` and
             prints each kernel's registers, shared memory and spills.
  --compare  builds another design's ``ba_jac.cu``, ``calib.cu`` and
             ``pnp.cu`` from OTHER_DIR (an earlier tree's ``csrc``, its own
             ``pinhole_jet.cuh`` beside them) and times both designs at the
             same inputs in turns (this, other, other, this): the cases of
             ``COMPARE_BA``, ``COMPARE_CALIB`` and ``COMPARE_PNP`` in both
             dtypes, and with ``--paths`` also at the known path's first
             calls (its two LM runs, its two PnP refinements, its first
             pose-only and global BA Jacobians, recorded from one
             ``process`` of the headline clip with its corners). Both
             designs' outputs must agree: the Jacobians bit for bit, or
             within ``JAC_TOL``; the LM runs in iterations and by
             ``calib_agrees``; the PnP poses and costs bit for bit, or by
             ``pnp_agrees`` on the starts ``pnp_held`` keeps. Exits 1
             where they do not.
  --launches counts ``obs_jacobians`` launches by caller over one
             marker-free run (``markerless_clip``, ``markerless_config``:
             the pose chain's ``pose_only_refine`` and in-chain
             ``adjust_points``, then the global BA) and one run of the
             batch row (``batch_clips``, ``batch_config``).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import math
import sys
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from meatmodeler_tpu_torch.geometry import calibration, calibration_cuda, pnp, pnp_cuda, projection, so3
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.solvers import bundle_adjust, bundle_adjust_cuda
from meatmodeler_tpu_torch.tools.clahe_bench import HBM_BYTES_PER_S, time_ms

FP32_FLOPS_PER_S = 67e12  # one H100 SXM, float32 outside the tensor cores
ROT_VALUE_OPS = 44
ROT_OPS = ROT_VALUE_OPS + 15 + 3 * 9 * 6
POINT_OPS = 18 + 3
PIN_OPS = 6
PIN_DPC_OPS = 7
ROT_COL_OPS = 45 + 30
POINT_COL_OPS = 30
SUM_OPS = 4  # one entry of J^T J or J^T r summed over a point's two rows
BA_OBS_OPS = POINT_OPS + PIN_OPS + PIN_DPC_OPS + ROT_COL_OPS + POINT_COL_OPS + 1 + 18
PNP_POINT_OPS = POINT_OPS + PIN_OPS + 2 + PIN_DPC_OPS + ROT_COL_OPS + 27 * SUM_OPS
PNP_COST_OPS = POINT_OPS + PIN_OPS + 2 + SUM_OPS
CHOL6_OPS = 72 + 6  # Cholesky of a 6x6 block and its roots
TRSV6_OPS = 72  # a forward and a back substitution at 6x6
PNP_SOLVE_OPS = 6 + CHOL6_OPS + TRSV6_OPS + 6
# distort_normalized's value and its 2x2 Jacobian d(x_d, y_d)/d(x, y) with
# the first num_dist = 0..5 coefficients (k1, k2, p1, p2, k3).
DIST_OPS = (0, 7, 9, 18, 26, 28)
DIST_JAC_OPS = (0, 10, 13, 23, 33, 37)
DIST_COL_OPS = 4  # per distortion coefficient: its two entries, scaled by the focal
LM_RULE_OPS = 20  # use1, improved, the costs' selects, rel, done and the damping
JAC_TOL = 1e-5  # elementwise, relative to max(1, |J|) of the observation's block
POSE_TOL = 1e-4  # PnP poses, calibrate's poses and distortion, where float32 does not decide
CALIB_RTOL = 1e-4  # calibrate's focal(s), principal point and rms, where float32 does not decide
DETERMINED_TOL = 1e-5  # the plain float32 result within this (relative) of float64

# The known path's geometry: 1920x1080 at focal 1500, pass 2 at half size;
# a (4, 3) board with 2-unit squares in the X-Z plane for the poses, unit
# squares on z = 0 for calibrate; 22 keyframes.
IMAGE_SIZE = (960, 540)
K_HEADLINE = np.array([[750.0, 0.0, 480.0], [0.0, 750.0, 270.0], [0.0, 0.0, 1.0]])
PATTERN = (4, 3)
FRAMES = 22
BA_EDGES = ("rvec0", "rvec1e-7", "rvec1e-3", "near_pi")
BA_CASES = ("ba_pose", "ba_global", "ba_lanes", *BA_EDGES)
# Past the Jacobian kernel's shared coefficient table: 8 lanes of
# max_keyframes (128) cameras, few observations a lane.
BA_WIDE = "ba_wide"
# num_dist 0-5 with two focals, a free centre and a masked view.
CALIB_DIST_CASES = tuple(f"calibrate_dist{k}" for k in range(6))
# max_keyframes views, and three times that: past the LM kernel's shared-memory
# budget (its views' terms then go to the global workspace).
CALIB_WIDE = "calibrate_128"
CALIB_WIDER = "calibrate_384"
# ``pnp_refine``'s calls: the known path's (both twins of 22 frames), a
# batch-row clip's (11 keyframes, as the batch row's calls have) and
# ``refine_pose``'s single start; 54 corners of a 9x6 board (past one
# warp's lanes) on max_keyframes (128) frames; starts at the rotation's
# branches (rvec 0, 1e-7: the Taylor branch; 1e-3: the closed form under
# cancellation; near pi); NaN pixels in two frames.
PNP_CASES = ("pnp", "pnp_batch", "pnp_single")
PNP_WIDE = "pnp_wide"
PNP_EDGES = ("pnp_rvec0", "pnp_rvec1e-7", "pnp_rvec1e-3", "pnp_near_pi")
PNP_NAN = "pnp_nan"
PNP_NAN_FRAMES = (5, 9)  # all of frame 5's pixels NaN, one coordinate of frame 9's


def _rodrigues(rv: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rv)
    k = np.array([[0, -rv[2], rv[1]], [rv[2], 0, -rv[0]], [-rv[1], rv[0], 0]])
    if th < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th**2 * k @ k


def _log(rot: np.ndarray) -> np.ndarray:
    return so3.log(torch.from_numpy(rot)).numpy()


def board_poses(frames: int, seed: int, xz: bool = False, pattern: Tuple[int, int] = PATTERN) -> np.ndarray:
    """(F, 6) poses seeing a board of ``pattern`` inner corners from 14-22
    units, aimed at its centre and tilted up to ~35 degrees: the z = 0 unit
    board, or (``xz``) the X-Z board with 2-unit squares (the pipeline's)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(frames):
        rv = np.array([0.5 * np.sin(0.7 * i), 0.5 * np.cos(0.5 * i), 0.2 * rng.normal()])
        rv = rv * rng.uniform(0.3, 1.2)
        r0 = _rodrigues(rv)
        center = np.array([(pattern[0] - 1) / 2, (pattern[1] - 1) / 2, 0.0]) * (2.0 if xz else 1.0)
        t = -r0 @ center + np.array([rng.normal() * 0.5, rng.normal() * 0.5, rng.uniform(14, 22) * (2 if xz else 1)])
        if xz:  # p_z0 = M^T p_xz with M (x, y, z) -> (x, -z, y)
            m = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
            r0 = r0 @ m.T
        out.append(np.concatenate([_log(r0), t]))
    return np.stack(out)


def _project(obj: np.ndarray, poses: np.ndarray, k: np.ndarray) -> np.ndarray:
    return projection.project_points(torch.from_numpy(obj)[None], torch.from_numpy(poses)[:, None],
                                     torch.from_numpy(k)).numpy()


def calib_case(name: str = "calibrate", seed: int = 0) -> Dict[str, object]:
    """Seeded inputs of one ``calibrate`` call (numpy, float32): ``img``
    (F, N, 2), ``obj`` (N, 3), ``image_size``, the layout keywords and
    ``view_mask`` (or None). 0.3 px noise. ``calibrate`` is the known
    path's layout at its 22 views; ``calibrate_dist<k>`` (k = 0-5) adds
    distortion to the pixels, fits k coefficients with two focals and a
    free centre, and masks the last view; ``calibrate_128`` and
    ``calibrate_384`` are ``calibrate_dist5`` at 128 and 384 views."""
    from meatmodeler_tpu_torch.geometry import distortion

    wide = {CALIB_WIDE: 128, CALIB_WIDER: 384}
    frames = wide.get(name, FRAMES)
    obj = calibration.chessboard_object_points(PATTERN, torch.float64).numpy()
    poses = board_poses(frames, seed)
    rng = np.random.default_rng(seed + 100)
    k = K_HEADLINE.copy()
    kw = dict(num_dist=0, fix_principal_point=True, single_focal=True)
    img = _project(obj, poses, k)
    mask = None
    if name in CALIB_DIST_CASES or name in wide:
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 760.0, 745.0, 476.0, 272.0
        img = _project(obj, poses, k)
        dist = torch.tensor([-0.08, 0.05, 1e-3, -5e-4, 0.0], dtype=torch.float64)
        img = distortion.distort_pixels(torch.from_numpy(img), torch.from_numpy(k), dist).numpy()
        kw = dict(num_dist=int(name[-1]) if name in CALIB_DIST_CASES else 5, fix_principal_point=False,
                  single_focal=False)
        mask = np.ones(frames, bool)
        mask[-1] = False
    elif name != "calibrate":
        raise ValueError(f"unknown calibration case {name!r}")
    img = img + rng.normal(scale=0.3, size=img.shape)
    f = np.float32
    return dict(img=img.astype(f), obj=obj.astype(f), image_size=IMAGE_SIZE, view_mask=mask, **kw)


def lm_args(case: Dict[str, object], device, dtype=torch.float32) -> tuple:
    """``calibration.run_lm``'s positional arguments at ``case``: theta0
    from ``calibration.initial_theta``, 30 iterations."""
    img = torch.from_numpy(case["img"]).to(device, dtype)
    obj = torch.from_numpy(case["obj"]).to(device, dtype)
    mask = None if case["view_mask"] is None else torch.from_numpy(case["view_mask"]).to(device)
    layout = dict(image_size=case["image_size"], num_dist=case["num_dist"],
                  fix_principal_point=case["fix_principal_point"], single_focal=case["single_focal"])
    theta0 = calibration.initial_theta(img, obj, view_mask=mask, **layout)
    return (theta0, img, obj, case["image_size"], case["num_dist"], 30, case["fix_principal_point"],
            case["single_focal"], mask)


def pnp_case(seed: int = 0, frames: int = FRAMES) -> Tuple[np.ndarray, ...]:
    """Seeded inputs of the known path's ``solve_pnp_batch`` (float32 numpy):
    (plane_uv (N, 2), obj_pts (N, 3) on the X-Z board, img (F, N, 2), K);
    obj_cols is (0, 2). 0.3 px noise."""
    gx, gy = np.meshgrid(np.arange(PATTERN[0]), np.arange(PATTERN[1]), indexing="xy")
    obj = np.stack([gx.reshape(-1) * 2.0, np.zeros(gx.size), gy.reshape(-1) * 2.0], axis=-1)
    img = _project(obj, board_poses(frames, seed, xz=True), K_HEADLINE)
    img = img + np.random.default_rng(seed + 200).normal(scale=0.3, size=img.shape)
    f = np.float32
    return obj[:, [0, 2]].astype(f), obj.astype(f), img.astype(f), K_HEADLINE.astype(f)


def pnp_args(case, device, dtype=torch.float32, iters: int = 10) -> tuple:
    """``pnp_cuda.pnp_refine``'s arguments at a ``pnp_case``: both planar
    twins of every frame from ``pnp.solve_pnp_planar``."""
    plane, obj, img, k = (torch.from_numpy(x).to(device, dtype) for x in case)
    init_a, init_b = pnp.solve_pnp_planar(plane, (0, 2), img, k)
    return torch.stack([init_a, init_b]), obj, img, k, iters, 1e-8


def pnp_refine_case(name: str, device="cpu", dtype=torch.float32, seed: int = 0) -> tuple:
    """``pnp_cuda.pnp_refine``'s arguments at one of ``PNP_CASES``,
    ``PNP_WIDE``, ``PNP_EDGES`` or ``PNP_NAN`` (see there): the planar twins
    of ``pnp_case``'s frames as the starts; ``pnp_wide`` on the z = 0 unit
    board (as ``calib_case``'s) with its planar twins; at an edge, the z = 0
    unit (4, 3) board seen from poses whose rvec is the edge's, twin 0
    starting at that pose exactly and twin 1 at its planar twin; at
    ``pnp_nan`` the known path's starts with NaN written into the pixels of
    ``PNP_NAN_FRAMES``."""
    if name in ("pnp", PNP_NAN):
        args = pnp_args(pnp_case(seed), device, dtype)
        if name == PNP_NAN:
            img = args[2].clone()
            img[PNP_NAN_FRAMES[0]] = math.nan
            img[PNP_NAN_FRAMES[1], 3, 0] = math.nan
            args = (args[0], args[1], img, *args[3:])
        return args
    if name == "pnp_batch":
        return pnp_args(pnp_case(seed, frames=11), device, dtype)
    if name == "pnp_single":
        poses, obj, img, *rest = pnp_args(pnp_case(seed), device, dtype)
        return (poses[:1, :1].contiguous(), obj, img[:1].contiguous(), *rest)
    if name != PNP_WIDE and name not in PNP_EDGES:
        raise ValueError(f"unknown PnP case {name!r}")
    rng = np.random.default_rng(seed + 300)
    pattern, frames = ((9, 6), 128) if name == PNP_WIDE else (PATTERN, FRAMES)
    obj = calibration.chessboard_object_points(pattern, torch.float64).numpy()
    poses = board_poses(frames, seed, pattern=pattern)
    if name in PNP_EDGES:
        u = np.array([0.6, -0.8, 0.0])
        if name == "pnp_rvec0":
            rv = np.zeros((FRAMES, 3))
        elif name == "pnp_rvec1e-7":
            rv = 1e-7 * u * rng.uniform(0.5, 1.5, size=(FRAMES, 1))
        elif name == "pnp_rvec1e-3":
            rv = 1e-3 * u * rng.uniform(0.5, 1.5, size=(FRAMES, 1))
        else:
            axis = np.array([0.0, 1.0, 0.1]) / np.linalg.norm([0.0, 1.0, 0.1])
            rv = (math.pi - np.logspace(-4, -1, FRAMES))[:, None] * axis
        center = np.array([1.5, 1.0, 0.0])
        for f in range(frames):
            poses[f, 3:] = -_rodrigues(rv[f]) @ center + [0.0, 0.0, poses[f, 5]]
        poses[:, :3] = rv
    img = _project(obj, poses, K_HEADLINE) + rng.normal(scale=0.3, size=(frames, obj.shape[0], 2))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device, dtype)

    obj_t, img_t, k_t = t(obj), t(img), t(K_HEADLINE)
    init, twin = pnp.solve_pnp_planar(obj_t[:, :2], (0, 1), img_t, k_t)
    return torch.stack([init if name == PNP_WIDE else t(poses), twin]), obj_t, img_t, k_t, 10, 1e-8


class BACase(NamedTuple):
    cam: torch.Tensor
    pts: torch.Tensor
    intrinsics: torch.Tensor
    fidx: torch.Tensor
    pidx: torch.Tensor
    mask: torch.Tensor
    weight: Optional[torch.Tensor]


def ba_case(name: str, device="cpu", dtype=torch.float32, seed: int = 0) -> BACase:
    """Seeded inputs of one ``obs_jacobians`` call: ``ba_pose`` (the known
    path's pose-only BA: 22 cameras, 12 board points, 264 observations),
    ``ba_global`` (a global BA at its size: 2000 points, 12000
    observations, weighted, 3% masked), ``ba_lanes`` (``solve_ba_batch``'s:
    8 lanes of 11 cameras, 400 points, 3000 observation slots, the tails
    masked), ``ba_wide`` (8 lanes of 128 cameras, 60 points and 40
    observation slots, the tails masked: past the kernel's shared
    coefficient table) or one of ``BA_EDGES``: the pose-only problem with
    every camera's rvec set to 0, to 1e-7 or 1e-3 (the Taylor branch, its
    edge, the closed form under cancellation) or near pi."""
    rng = np.random.default_rng(seed)
    weight = None
    if name in ("ba_pose", *BA_EDGES):
        pts = pnp_case(seed)[1].astype(np.float64)
        cams = board_poses(FRAMES, seed, xz=True)
        f, p = len(cams), len(pts)
        fidx, pidx = np.repeat(np.arange(f), p), np.tile(np.arange(p), f)
        mask = np.ones(f * p, bool)
        u = np.array([0.6, -0.8, 0.0])
        if name == "rvec0":
            cams[:, :3] = 0.0
        elif name == "rvec1e-7":
            cams[:, :3] = 1e-7 * u * rng.uniform(0.5, 1.5, size=(f, 1))
        elif name == "rvec1e-3":
            cams[:, :3] = 1e-3 * u * rng.uniform(0.5, 1.5, size=(f, 1))
        elif name == "near_pi":
            axis = np.array([0.0, 1.0, 0.1]) / np.linalg.norm([0.0, 1.0, 0.1])
            cams[:, :3] = (math.pi - np.logspace(-4, -1, f))[:, None] * axis
            cams[:, 5] = -cams[:, 5]
        k = K_HEADLINE
        lanes = None
    elif name == "ba_global":
        cams = board_poses(FRAMES, seed, xz=True)
        pts = rng.normal(size=(2000, 3)) * [3.0, 2.0, 3.0] + [3.0, 2.0, 2.0]
        n = 12000
        fidx, pidx = rng.integers(0, FRAMES, n), rng.integers(0, 2000, n)
        mask = rng.random(n) < 0.97
        weight = 1.2 ** -rng.integers(0, 4, n).astype(np.float64)
        k = K_HEADLINE
        lanes = None
    elif name in ("ba_lanes", BA_WIDE):
        lanes, f, p, n = (8, 11, 400, 3000) if name == "ba_lanes" else (8, 128, 60, 40)
        cams = np.stack([board_poses(f, seed + v, xz=True) for v in range(lanes)])
        pts = rng.normal(size=(lanes, p, 3)) * [3.0, 2.0, 3.0] + [3.0, 2.0, 2.0]
        fidx, pidx = rng.integers(0, f, (lanes, n)), rng.integers(0, p, (lanes, n))
        mask = np.arange(n)[None, :] < rng.integers(n // 2, n, lanes)[:, None]
        weight = np.ones((lanes, n))
        k = np.broadcast_to(K_HEADLINE, (lanes, 3, 3))
    else:
        raise ValueError(f"unknown BA case {name!r}")

    def t(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return BACase(t(cams), t(pts), t(k), t(fidx, torch.int64), t(pidx, torch.int64), t(mask, torch.bool),
                  None if weight is None else t(weight))


def ba_plain(cam, pts, intrinsics, fidx, pidx, mask, weight=None):
    """The plain version of ``obs_jacobians`` at the wrapper's arguments
    (``bundle_adjust._obs_jacobians_reference``, vmapped over lanes)."""
    obs = torch.zeros(fidx.shape + (2,), dtype=cam.dtype, device=cam.device)
    extra = () if weight is None else (weight,)
    fn = bundle_adjust._obs_jacobians_reference
    return (vmap(fn) if cam.ndim == 3 else fn)(cam, pts, intrinsics, obs, fidx, pidx, mask, *extra)


def pnp_plain(poses, obj, img, k, iters: int = 10, damping: float = 1e-8):
    """The plain version of ``pnp_refine``: ``pnp.refine_pose_reference`` on
    every start, and its cost."""
    t = poses.shape[0]
    flat = pnp.refine_pose_reference(poses.reshape(-1, 6), obj, img.repeat(t, 1, 1), k, iters, damping)
    cost = pnp._cost(flat, obj, img.repeat(t, 1, 1), k)
    return flat.reshape(poses.shape), cost.reshape(poses.shape[:2])


def jacobian_agreement(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> Dict[str, object]:
    """Equal NaN patterns, and the largest |got - ref| over the finite
    entries of each observation's Jacobian, relative to max(1, |J|) with
    |J| the largest |entry| of the plain version's (2, 9) block [jc | jp]
    of that observation: a rotation column's entry can be small by
    cancellation between terms of the block's size, and float32 rounds
    it at that scale in either version."""
    g = torch.cat([got[0], got[1]], dim=-1).double()
    r = torch.cat([ref[0], ref[1]], dim=-1).double().to(g.device)
    nan_equal = torch.equal(g.isnan(), r.isnan())
    scale = torch.nan_to_num(r, nan=0.0).abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1.0)
    d = torch.where(g.isnan() | r.isnan(), 0.0, (g - r).abs() / scale)
    return {"nan_equal": bool(nan_equal), "max_rel": float(d.max()) if d.numel() else 0.0}


def jacobians_agree(a: Dict[str, object], tol: float = JAC_TOL) -> bool:
    return bool(a["nan_equal"] and a["max_rel"] <= tol)


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / max(1, |b|); NaN on both sides 0, on one side inf."""
    a, b = a.double(), b.to(a.device).double()
    d = (a - b).abs() / b.abs().clamp(min=1.0)
    return torch.where(a.isnan() & b.isnan(), 0.0, torch.nan_to_num(d, nan=math.inf))


def pnp_determined(plain32: torch.Tensor, plain64: torch.Tensor, tol: float = DETERMINED_TOL) -> torch.Tensor:
    """(..., F) the starts float32 rounding does not decide: the plain
    version's float32 pose within ``tol`` (relative) of the same call in
    float64. Elsewhere ten Gauss-Newton steps from a start far off (a
    twin in the wrong basin) amplify a rounding into another path."""
    return _rel(plain32, plain64).amax(dim=-1) <= tol


def pnp_agreement(got, ref, held: torch.Tensor) -> Dict[str, object]:
    """How the kernel's (poses, costs) depart from the plain version's:
    equal NaN patterns everywhere, the largest pose difference over the
    ``held`` starts and, printed only, over the rest."""
    d = (got[0].double() - ref[0].double()).abs()
    d = torch.where(got[0].isnan() & ref[0].isnan(), 0.0, torch.nan_to_num(d, nan=math.inf)).amax(dim=-1)
    held = held.to(d.device)
    return {
        "nan_equal": all(torch.equal(g.isnan(), r.isnan()) for g, r in zip(got, ref)),
        "held": int(held.sum()), "starts": held.numel(),
        "max_held": float(d[held].max()) if held.any() else 0.0,
        "max_not_held": float(d[~held].max()) if (~held).any() else 0.0,
    }


def pnp_agrees(a: Dict[str, object], tol: float = POSE_TOL) -> bool:
    return bool(a["nan_equal"] and a["held"] > 0 and a["max_held"] <= tol)


def calib_determined(plain32, plain64, tol: float = DETERMINED_TOL) -> bool:
    """Whether float32 rounding does not decide a calibration LM run: every
    parameter and the cost of the plain float32 run within ``tol``
    (relative, to max(1, |x|)) of the same run in float64."""
    return bool(_rel(plain32[0], plain64[0]).max() <= tol and _rel(plain32[1], plain64[1]).max() <= tol)


def calib_agreement(got, ref, n_intr: int, n_focal_pp: int, points: int, held: bool) -> Dict[str, object]:
    """How the kernel's (theta, cost) depart from the plain version's: the
    focal(s) and principal point and the rms sqrt(2 cost / points) by
    relative difference, the distortion and poses by absolute."""
    tg, tr = got[0].double(), ref[0].double().to(got[0].device)
    rms_g, rms_r = (torch.sqrt(2.0 * c.double() / points) for c in (got[1], ref[1].to(got[1].device)))
    rel = ((tg[:n_focal_pp] - tr[:n_focal_pp]).abs() / tr[:n_focal_pp].abs()).max()
    return {
        "held": held, "nan_equal": torch.equal(tg.isnan(), tr.isnan()) and bool(rms_g.isnan() == rms_r.isnan()),
        "k_rel": float(rel), "rms_rel": float((rms_g - rms_r).abs() / rms_r.abs()),
        "rest_abs": float((tg[n_focal_pp:] - tr[n_focal_pp:]).abs().max()),
    }


def calib_agrees(a: Dict[str, object]) -> bool:
    """NaN patterns equal; where held, K and rms within ``CALIB_RTOL`` and
    the distortion and poses within ``POSE_TOL``."""
    if not a["nan_equal"]:
        return False
    return (not a["held"]) or (a["k_rel"] <= CALIB_RTOL and a["rms_rel"] <= CALIB_RTOL and a["rest_abs"] <= POSE_TOL)


def _bound(flops: float, nbytes: float) -> Tuple[float, str]:
    by_ops, by_bytes = flops / FP32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


def ba_work(lanes: int, n_cam: int, n_pts: int, n_obs: int, itemsize: int = 4, weighted: bool = True,
            active: Optional[int] = None) -> Dict[str, int]:
    """Operations and bytes of one ``obs_jacobians`` launch with ``active``
    observations in the mask over all lanes (all by default; see the
    module's note)."""
    active = lanes * n_obs if active is None else active
    flops = lanes * n_cam * ROT_OPS + active * BA_OBS_OPS
    nbytes = lanes * ((6 * n_cam + 3 * n_pts + 9) * itemsize + n_obs * (8 + 8 + 1 + (itemsize if weighted else 0))
                      + n_obs * 18 * itemsize)
    return {"flops": flops, "bytes": nbytes, "steps": 1}


def pnp_work(twins: int, frames: int, n: int, iters: int = 10, itemsize: int = 4) -> Dict[str, int]:
    """Operations and bytes of one ``pnp_refine`` launch."""
    starts = twins * frames
    flops = starts * (iters * (ROT_OPS + n * PNP_POINT_OPS + PNP_SOLVE_OPS) + ROT_VALUE_OPS + n * PNP_COST_OPS)
    nbytes = (2 * starts * 6 + n * 3 + frames * n * 2 + 9 + starts) * itemsize
    return {"flops": flops, "bytes": nbytes, "steps": 2 * iters + 1}


def calib_cost_ops(num_dist: int) -> int:
    """One point's share of a calibration cost: the distorted projection,
    its residual and its square summed."""
    return POINT_OPS + DIST_OPS[num_dist] + 4 + 2 + SUM_OPS


def calib_row_ops(n_intr: int, num_dist: int) -> int:
    """One point's rows of the calibration Jacobian and their sums (see the
    module's note): d(u, v)/dp_c costs 6 without distortion, 18 with."""
    entries = 27 + 7 * n_intr + n_intr * (n_intr + 1) // 2
    dpc = 6 if num_dist == 0 else 18
    return (POINT_OPS + DIST_OPS[num_dist] + 4 + 2 + DIST_JAC_OPS[num_dist] + dpc + ROT_COL_OPS
            + DIST_COL_OPS * num_dist + SUM_OPS * entries)


def calib_work(f: int, n: int, n_intr: int, num_dist: int, iterations: int, itemsize: int = 4,
               views: Optional[int] = None) -> Dict[str, int]:
    """Operations and bytes of one ``calib_lm`` launch over ``f`` views of
    ``n`` points, ``views`` of them in the mask (all by default), that ran
    ``iterations`` iterations."""
    views = f if views is None else views
    cost = views * (ROT_VALUE_OPS + n * calib_cost_ops(num_dist))
    rows = views * (ROT_OPS + n * calib_row_ops(n_intr, num_dist))
    schur_terms = 12 * (n_intr * (n_intr + 1) // 2 + n_intr)
    per_view = 18 + CHOL6_OPS + (n_intr + 1) * TRSV6_OPS + schur_terms + 12 * n_intr + 6
    intr = 3 * n_intr + n_intr**3 // 3 + n_intr + 2 * n_intr * n_intr + n_intr
    trial = views * per_view + intr + cost
    per_iter = rows + 2 * trial + LM_RULE_OPS
    n_params = n_intr + 6 * f
    nbytes = (2 * n_params + f * n * 2 + n * 3 + f + 1) * itemsize
    return {"flops": cost + iterations * per_iter, "bytes": nbytes, "steps": 4 * iterations + 1,
            "barriers": 3 * iterations + 1}


def _timed(kernel, plain, work) -> Dict[str, object]:
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=5)
    bound, by = _bound(work["flops"], work["bytes"])
    return {"ms": ms, "plain_ms": plain_ms, **work, "bound_ms": bound, "bound_by": by, "share": bound / ms}


def time_ba(cam, pts, intrinsics, fidx, pidx, mask, weight=None) -> Dict[str, object]:
    """Kernel and plain times of one ``obs_jacobians`` call (CUDA tensors)."""
    args = (cam, pts, intrinsics, fidx, pidx, mask, weight)
    lanes = cam.shape[0] if cam.ndim == 3 else 1
    work = ba_work(lanes, cam.shape[-2], pts.shape[-2], fidx.shape[-1], cam.element_size(), weight is not None,
                   int(mask.sum()))
    out = _timed(lambda: bundle_adjust_cuda.obs_jacobians(*args), lambda: ba_plain(*args), work)
    return dict(out, lanes=lanes, cameras=cam.shape[-2], points=pts.shape[-2], observations=fidx.shape[-1])


def time_pnp(poses, obj, img, k, iters: int = 10, damping: float = 1e-8) -> Dict[str, object]:
    """Kernel and plain times of one ``pnp_refine`` call (CUDA tensors)."""
    args = (poses, obj, img, k, iters, damping)
    work = pnp_work(poses.shape[0], poses.shape[1], obj.shape[0], iters, poses.element_size())
    out = _timed(lambda: pnp_cuda.pnp_refine(*args), lambda: pnp_plain(*args), work)
    return dict(out, twins=poses.shape[0], frames=poses.shape[1], points=obj.shape[0])


def time_calib(*args) -> Dict[str, object]:
    """Kernel and plain times of one ``calib_lm`` call (CUDA tensors, the
    arguments of ``calibration.run_lm``), counted for the iterations it
    ran."""
    theta0, img, num_dist, mask = args[0], args[1], args[4], args[8]
    _, _, iterations = calibration_cuda.calib_lm(*args)
    n_intr = theta0.shape[0] - 6 * img.shape[0]
    views = img.shape[0] if mask is None else int(mask.sum())
    work = calib_work(img.shape[0], img.shape[1], n_intr, num_dist, int(iterations), img.element_size(), views)
    out = _timed(lambda: calibration_cuda.calib_lm(*args), lambda: calibration.run_lm_reference(*args), work)
    return dict(out, views=img.shape[0], points=img.shape[1], n_intr=n_intr, iterations=int(iterations))


def describe(name: str, label: str, r: Dict[str, object]) -> str:
    shape = {k: r[k] for k in ("lanes", "cameras", "points", "observations", "twins", "frames", "views", "n_intr",
                               "iterations") if k in r}
    barriers = f", block barriers {r['barriers']}" if "barriers" in r else ""
    return (f"{name} {label} {shape}: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f} ms), {r['flops']} FLOP, "
            f"{r['bytes']} B, bound {r['bound_ms']:.6f} ms by {r['bound_by']}, share {r['share']:.5f}; dependent "
            f"steps {r['steps']}{barriers}")


def ptxas() -> str:
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for mod in (bundle_adjust_cuda, pnp_cuda, calibration_cuda):
            out.append(cuda_build.compile_source(mod.SOURCE, Path(tmp) / "lib.so", (*mod.NVCC_EXTRA, "-Xptxas", "-v")))
    return "\n".join(out)


def raw_ba(lib: ctypes.CDLL, args) -> Callable[[], None]:
    """One launch of ``lib``'s ``obs_jacobians`` on ``obs_jacobians``'
    arguments with no checks or counting, for timing two builds alike; the
    outputs are ``run.outputs``."""
    cam, pts, k, fidx, pidx, mask, weight = args
    lead = tuple(cam.shape[:1]) if cam.ndim == 3 else ()
    n = fidx.shape[-1]
    jc = torch.empty(lead + (n, 2, 6), dtype=cam.dtype, device=cam.device)
    jp = torch.empty(lead + (n, 2, 3), dtype=cam.dtype, device=cam.device)
    tensors = [t.contiguous() for t in (cam, pts, k, fidx, pidx, mask)] + [weight]
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    fn = getattr(lib, bundle_adjust_cuda._ENTRY[cam.dtype])
    stream = torch.cuda.current_stream(cam.device).cuda_stream

    def run():
        code = fn(*ptrs, lead[0] if lead else 1, cam.shape[-2], pts.shape[-2], n, jc.data_ptr(), jp.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"obs_jacobians launch failed: cudaError {code}")

    run.outputs, run.tensors = (jc, jp), tensors
    return run


def raw_calib(lib: ctypes.CDLL, args) -> Callable[[], None]:
    """One launch of ``lib``'s ``calib_lm`` on ``calibration.run_lm``'s
    arguments (its own workspace), as ``raw_ba``; outputs (theta, cost,
    iterations)."""
    theta0, img, obj, image_size, num_dist, max_iters, fix_pp, single_focal, mask = args
    f, n = img.shape[:2]
    n_focal, n_pp = (1 if single_focal else 2), (0 if fix_pp else 2)
    work = torch.empty(int(lib.calib_lm_workspace(f, n, n_focal + n_pp + num_dist, img.element_size())),
                       dtype=torch.uint8, device=img.device)
    theta, cost = torch.empty_like(theta0), torch.empty((), dtype=img.dtype, device=img.device)
    iters = torch.empty((), dtype=torch.int32, device=img.device)
    tensors = [t.contiguous() for t in (theta0, img, obj)] + [mask]
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    fn = getattr(lib, calibration_cuda._ENTRY[img.dtype])
    stream = torch.cuda.current_stream(img.device).cuda_stream

    def run():
        code = fn(*ptrs, f, n, n_focal, n_pp, num_dist, 0.5 * float(image_size[0]), 0.5 * float(image_size[1]),
                  max_iters, work.data_ptr() if work.numel() else None, theta.data_ptr(), cost.data_ptr(),
                  iters.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"calib_lm launch failed: cudaError {code}")

    run.outputs, run.tensors = (theta, cost, iters), tensors
    return run


def raw_pnp(lib: ctypes.CDLL, args) -> Callable[[], None]:
    """One launch of ``lib``'s ``pnp_refine`` on ``pnp_cuda.pnp_refine``'s
    arguments, as ``raw_ba``; outputs (poses, costs)."""
    poses, obj, img, k, iters, damping = args
    t, f = poses.shape[:2]
    out = torch.empty_like(poses)
    cost = torch.empty((t, f), dtype=poses.dtype, device=poses.device)
    tensors = [x.contiguous() for x in (poses, obj, img, k)]
    ptrs = [x.data_ptr() for x in tensors]
    fn = getattr(lib, pnp_cuda._ENTRY[poses.dtype])
    stream = torch.cuda.current_stream(poses.device).cuda_stream

    def run():
        code = fn(*ptrs, t, f, obj.shape[0], iters, float(damping), out.data_ptr(), cost.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"pnp_refine launch failed: cudaError {code}")

    run.outputs, run.tensors = (out, cost), tensors
    return run


def known_path_calls(device) -> Dict[str, tuple]:
    """The known path's first calls of the three kernels: {"calib_lm call
    1", "calib_lm call 2": ``run_lm`` arguments, "pnp_refine call 1",
    "pnp_refine call 2": ``pnp_refine`` arguments, "pose-only BA", "global
    BA": ``obs_jacobians`` arguments}, from one ``process`` of the headline
    clip with its corners."""
    from meatmodeler_tpu_torch.pipeline import process
    from meatmodeler_tpu_torch.tools.profile_headline import headline_clip, headline_config, recording

    _, frames, corners = headline_clip(device)
    first, inside = {}, threading.local()
    real_ba = bundle_adjust_cuda.obs_jacobians

    def within(fn, label):
        def run(*a, **k):
            inside.label = label
            try:
                return fn(*a, **k)
            finally:
                inside.label = None

        return run

    def ba(*a, **k):
        label = getattr(inside, "label", None)
        if label is not None and label not in first:
            bound = inspect.signature(real_ba).bind(*a, **k)
            bound.apply_defaults()
            first[label] = tuple(bound.arguments.values())
        return real_ba(*a, **k)

    real = (bundle_adjust.adjust_pose, bundle_adjust.adjust_points)
    bundle_adjust.adjust_pose, bundle_adjust.adjust_points = within(real[0], "pose-only BA"), within(real[1], "global BA")
    bundle_adjust_cuda.obs_jacobians = ba
    try:
        with recording(calibration_cuda, "calib_lm") as calib_calls, recording(pnp_cuda, "pnp_refine") as pnp_calls:
            process(frames, config=headline_config(), known_corners=corners, device=device.type)
    finally:
        bundle_adjust.adjust_pose, bundle_adjust.adjust_points = real
        bundle_adjust_cuda.obs_jacobians = real_ba
    out = {}
    for i, call in enumerate(calib_calls[:2]):
        bound = inspect.signature(calibration.run_lm).bind(*call[0], **call[1])
        bound.apply_defaults()
        out[f"calib_lm call {i + 1}"] = tuple(bound.arguments.values())
    for i, call in enumerate(pnp_calls[:2]):
        bound = inspect.signature(pnp_cuda.pnp_refine).bind(*call[0], **call[1])
        bound.apply_defaults()
        out[f"pnp_refine call {i + 1}"] = tuple(bound.arguments.values())
    for label in ("pose-only BA", "global BA"):
        out[label] = first[label]
    return out


# The BA callers ``launches_by_caller`` tells apart, innermost first.
BA_CALLERS = ("pose_only_refine", "adjust_points", "adjust_pose", "solve_ba_batch")


def launches_by_caller(run: Callable[[], object]) -> Dict[str, int]:
    """``obs_jacobians`` launches of one ``run()``, by the innermost BA
    caller (``BA_CALLERS``), those inside the marker-free pose chain
    (``pipeline._chain_keyframe_poses``) as "pose chain: <caller>"; from
    any host thread."""
    from meatmodeler_tpu_torch import pipeline

    counts: Dict[str, int] = {}
    local, lock = threading.local(), threading.Lock()

    def within(fn, label):
        def call(*a, **k):
            stack = local.__dict__.setdefault("stack", [])
            stack.append(label)
            try:
                return fn(*a, **k)
            finally:
                stack.pop()

        return call

    real_ba = bundle_adjust_cuda.obs_jacobians

    def ba(*a, **k):
        stack = getattr(local, "stack", [])
        callers = [x for x in stack if x in BA_CALLERS]
        label = callers[-1] if callers else "other"
        if "pose chain" in stack:
            label = f"pose chain: {label}"
        with lock:
            counts[label] = counts.get(label, 0) + 1
        return real_ba(*a, **k)

    patches = [(bundle_adjust, name) for name in BA_CALLERS] + [(pipeline, "_chain_keyframe_poses")]
    saved = [getattr(m, n) for m, n in patches]
    for (m, n), fn in zip(patches, saved):
        setattr(m, n, within(fn, "pose chain" if n == "_chain_keyframe_poses" else n))
    bundle_adjust_cuda.obs_jacobians = ba
    try:
        run()
    finally:
        bundle_adjust_cuda.obs_jacobians = real_ba
        for (m, n), fn in zip(patches, saved):
            setattr(m, n, fn)
    return counts


QUOTIENT_SOURCE = r"""
#include "pinhole_jet.cuh"
__global__ void quotients_kernel(const float* a, const float* b, float* fast, float* ieee, unsigned char* safe, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fast[i] = pinhole::quotient(a[i], pinhole::divisor(b[i]));
  ieee[i] = a[i] / b[i];
  safe[i] = pinhole::divisor_safe(b[i]) && pinhole::numerator_safe(a[i]);
}
extern "C" int quotients(const void* a, const void* b, void* fast, void* ieee, void* safe, int n, void* stream) {
  quotients_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(fast), static_cast<float*>(ieee),
      static_cast<unsigned char*>(safe), n);
  return (int)cudaGetLastError();
}
"""


def _floats(gen: torch.Generator, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """n float32 with random signs and mantissas, exponents in [lo, hi]."""
    bits = torch.randint(0, 1 << 23, (n,), generator=gen, device=device, dtype=torch.int64)
    bits |= (torch.randint(lo, hi + 1, (n,), generator=gen, device=device, dtype=torch.int64) + 127) << 23
    bits |= torch.randint(0, 2, (n,), generator=gen, device=device, dtype=torch.int64) << 31
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)


def quotient_check(device, n: int = 1 << 24, seed: int = 0) -> Dict[str, int]:
    """``pinhole_jet.cuh``'s float division by a shared reciprocal
    (``divisor`` / ``quotient``, which ``pnp.cu`` divides with) against
    IEEE division (``/`` in the same build), bit for bit wherever
    ``divisor_safe`` and ``numerator_safe`` hold: ``n`` random pairs over
    the whole safe range, ``n`` pairs whose quotient lies within an ulp of
    a rounding midpoint, exact quotients, zeros of both signs, powers of
    two and the range's ends; NaN, infinities, denormals and pairs beyond
    the range must not be safe (callers divide those with ``/``). Returns
    the counts {"pairs", "safe", "mismatches", "unsafe_specials_marked_safe"}."""
    import ctypes as ct

    gen = torch.Generator(device=device).manual_seed(seed)
    a = _floats(gen, n, -48, 48, device)
    b = _floats(gen, n, -48, 48, device)
    # Next to a rounding midpoint: a = RN(b (q + ulp(q) / 2)).
    q = _floats(gen, n, -20, 20, device)
    bm = _floats(gen, n, -20, 20, device)
    half_ulp = torch.ldexp(torch.ones_like(q, dtype=torch.float64), torch.frexp(q.double())[1] - 25)
    am = (bm.double() * (q.double() + half_ulp)).float()
    # Exact quotients: 10-bit mantissas times integers under 1024 fit 24 bits.
    exact_b = (_floats(gen, 4096, -20, 20, device).view(torch.int32) & ~((1 << 13) - 1)).view(torch.float32)
    exact_a = (exact_b.double() * torch.randint(-1023, 1024, (4096,), generator=gen, device=device)).float()
    ends = torch.tensor([2.0**-48, 2.0**48 * 1.9999999, -(2.0**-48), 1.0, -1.0, 3.0, 0.5], device=device)
    zeros = torch.tensor([0.0, -0.0], device=device)
    special = torch.tensor([math.nan, math.inf, -math.inf, 1e-40, -1e-40, 2.0**-49, 2.0**49, 3e38, 0.0],
                           device=device)
    a_all = torch.cat([a, am, exact_a, ends.repeat_interleave(len(ends)), zeros.repeat(len(ends)),
                       special.repeat_interleave(len(ends)), ends.repeat(len(special))])
    b_all = torch.cat([b, bm, exact_b, ends.repeat(len(ends)), ends.repeat_interleave(2),
                       ends.repeat(len(special)), special.repeat_interleave(len(ends))])
    a_all, b_all = a_all.float().contiguous(), b_all.float().contiguous()
    n_all = a_all.numel()
    fast, ieee = torch.empty_like(a_all), torch.empty_like(a_all)
    safe = torch.empty(n_all, dtype=torch.uint8, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "quotients.cu"
        src.write_text(QUOTIENT_SOURCE)
        cuda_build.compile_source(src, Path(tmp) / "libquotients.so", ("-fmad=false", "-I", str(cuda_build.CSRC)))
        lib = ct.CDLL(str(Path(tmp) / "libquotients.so"))
    p = ct.c_void_p
    lib.quotients.argtypes = [p, p, p, p, p, ct.c_int, p]
    lib.quotients.restype = ct.c_int
    code = lib.quotients(a_all.data_ptr(), b_all.data_ptr(), fast.data_ptr(), ieee.data_ptr(), safe.data_ptr(), n_all,
                         torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"quotients launch failed: cudaError {code}")
    torch.cuda.synchronize(device)
    held = safe.bool()
    differ = fast.view(torch.int32) != ieee.view(torch.int32)
    specials = (~torch.isfinite(a_all) | ~torch.isfinite(b_all) | (b_all == 0)
                | ((a_all != 0) & (a_all.abs() < 2.0**-48)) | (b_all.abs() < 2.0**-48)
                | (a_all.abs() >= 2.0**49) | (b_all.abs() >= 2.0**49))
    return {"pairs": n_all, "safe": int(held.sum()), "mismatches": int((held & differ).sum()),
            "unsafe_specials_marked_safe": int((held & specials).sum())}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


COMPARE_BA = ("ba_pose", "ba_global", "ba_lanes", BA_WIDE)
COMPARE_CALIB = ("calibrate", "calibrate_dist5", CALIB_WIDE, CALIB_WIDER)
COMPARE_PNP = (*PNP_CASES, PNP_WIDE, *PNP_EDGES, PNP_NAN)


def pnp_held(args) -> torch.Tensor:
    """(T, F) the starts of a ``pnp_refine`` call that float32 rounding
    does not decide (``pnp_determined`` of its plain version; every start
    in float64)."""
    poses = args[0]
    if poses.dtype == torch.float64:
        return torch.ones(poses.shape[:2], dtype=torch.bool, device=poses.device)
    f64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
    return pnp_determined(pnp_plain(*args)[0], pnp_plain(*f64)[0])


def compare(other: Path, device, paths: bool) -> bool:
    """Both designs of the three kernels at the same inputs, in turns this,
    other, other, this (see ``--compare``); prints each input's medians (us)
    and the designs' agreement, returns whether every input agreed."""
    inputs = [(f"obs_jacobians {name} {str(dt)[6:]}", "ba", tuple(ba_case(name, device, dt)))
              for dt in (torch.float32, torch.float64) for name in (*COMPARE_BA, *BA_EDGES)]
    inputs += [(f"calib_lm {name} {str(dt)[6:]}", "calib", lm_args(calib_case(name), device, dt))
               for dt in (torch.float32, torch.float64) for name in COMPARE_CALIB]
    inputs += [(f"pnp_refine {name} {str(dt)[6:]}", "pnp", pnp_refine_case(name, device, dt))
               for dt in (torch.float32, torch.float64) for name in COMPARE_PNP]
    if paths:
        for label, args in known_path_calls(device).items():
            kind = "calib" if label.startswith("calib") else ("pnp" if label.startswith("pnp") else "ba")
            inputs.append((f"known path {label}", kind, args))
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for kind, mod, name in (("ba", bundle_adjust_cuda, "ba_jac"), ("calib", calibration_cuda, "calib"),
                                ("pnp", pnp_cuda, "pnp")):
            path = Path(tmp) / f"{name}.so"
            cuda_build.compile_source(other / f"{name}.cu", path, mod.NVCC_EXTRA)
            lib = ctypes.CDLL(str(path))
            mod._bind(lib)
            libs[kind] = {"this": mod.build(), "other": lib}
        for label, kind, args in inputs:
            raw = {"ba": raw_ba, "calib": raw_calib, "pnp": raw_pnp}[kind]
            runs = {which: raw(lib, args) for which, lib in libs[kind].items()}
            times = {"this": [], "other": []}
            for which in ("this", "other", "other", "this"):
                times[which].append(time_ms(runs[which]) * 1e3)
            got, ref = runs["this"].outputs, runs["other"].outputs
            if kind == "ba":
                bit = all(_same(a, b) for a, b in zip(got, ref))
                a = jacobian_agreement(got, ref)
                agrees = bit or jacobians_agree(a, JAC_TOL if args[0].dtype == torch.float32 else 1e-12)
                verdict = "bit for bit" if bit else f"not bit for bit: {a}"
            elif kind == "pnp":
                bit = all(_same(a, b) for a, b in zip(got, ref))
                a = None if bit else pnp_agreement(got, ref, pnp_held(args))
                agrees = bit or pnp_agrees(a)
                verdict = "bit for bit" if bit else f"not bit for bit: {a}"
            else:
                theta0, img, mask = args[0], args[1], args[8]
                n_intr = theta0.shape[0] - 6 * img.shape[0]
                n_fp = (1 if args[7] else 2) + (0 if args[6] else 2)
                points = int(img.shape[0] if mask is None else mask.sum()) * img.shape[1]
                a = calib_agreement(got, ref, n_intr, n_fp, points, True)
                same_iters = int(got[2]) == int(ref[2])
                agrees = same_iters and calib_agrees(a)
                verdict = (f"iterations {int(got[2])} / {int(ref[2])}, theta bit for bit {_same(got[0], ref[0])}, "
                           f"cost {float(got[1])!r} / {float(ref[1])!r}, {a}")
            ok = ok and agrees
            print(f"compare {label}: this {[round(t, 3) for t in times['this']]} us, other "
                  f"{[round(t, 3) for t in times['other']]} us; {verdict}{'' if agrees else ' DISAGREE'}", flush=True)
    return ok


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--compare", type=Path, default=None, metavar="OTHER_DIR")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--launches", action="store_true")
    args = ap.parse_args(argv)
    if args.paths and args.compare is None:
        ap.error("--paths needs --compare")
    if not torch.cuda.is_available():
        print("geometry_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.ptxas:
        print(ptxas())
    for name in ("ba_pose", "ba_global", "ba_lanes"):
        print(describe("obs_jacobians", name, time_ba(*ba_case(name, dev))))
    print(describe("pnp_refine", "pnp", time_pnp(*pnp_args(pnp_case(), dev))))
    for name in ("calibrate", "calibrate_dist5"):
        print(describe("calib_lm", name, time_calib(*lm_args(calib_case(name), dev))))
    if args.launches:
        from meatmodeler_tpu_torch.parallel.batch import process_batch
        from meatmodeler_tpu_torch.pipeline import process
        from meatmodeler_tpu_torch.tools.profile_headline import (
            batch_clips, batch_config, markerless_clip, markerless_config,
        )

        _, frames, _ = markerless_clip(dev)
        counts = launches_by_caller(lambda: process(frames, config=markerless_config(), device="cuda"))
        print(f"obs_jacobians launches, one marker-free run: {counts}, in all {sum(counts.values())}")
        del frames
        _, clips = batch_clips(dev)
        counts = launches_by_caller(lambda: process_batch(clips, config=batch_config(), device="cuda"))
        print(f"obs_jacobians launches, one batch-row run: {counts}, in all {sum(counts.values())}")
    if args.compare is not None and not compare(args.compare, dev, args.paths):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
