"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``meatmodeler_tpu_torch/csrc`` (nvcc, one
     process per source, all started together), removing any library left
     from an earlier build first;
  3. hold each CLAHE kernel against its plain PyTorch version on the card
     (the LUT bit-exact, apply within 1e-4) on seeded images, a flat image,
     an unaligned width under two tile grids and a two-tone board;
  3b. hold the Lucas-Kanade kernel against its plain version (status and
     NaN patterns equal, the held points within eps = 0.01 px with the
     median within 1e-4, errors within 1e-4 where the points agree; held
     are all entries, and where a call is seeded with offsets the live
     ones, ``tools/klt_bench.held_entries`` says why, and such a call's
     plain version on the CPU is printed against it on the card) on
     seeded textures at the three callers' settings: the scan's (180, 320)
     and the odometry's (720, 1280), 128 points, win 21, 4 levels, 10
     iterations, and two_view's (540, 960, win 15, one level, seeded at the
     match offset); then a flat image, masked points, points on, beyond
     and far outside the border and NaN, 129 points, and the edge points
     at win 31 through 8 levels;
  3c. hold the relative-pose refinement kernel against its plain version
     (NaN patterns equal; within 1e-4 on the candidates float32 rounding
     does not decide, those where the plain version lies within 1e-5 of
     itself in float64, at least one a call and a quarter of all; the rest
     differ as any two float32 summation orders do, printed,
     ``tools/relpose_bench.determined`` says why) on seeded two-view scenes
     at the callers' shapes: 16 and 8 candidates at 128 points (odometry),
     16 at 8192 slots with 40% masked and 20% outliers (the marker-free
     bootstrap), 8 at 4096 with 96% padding (two-view), 24 at 128 and 24 at
     8192 slots with ~421 in the mask (one launch of the odometry and of
     the bootstrap); then starts at rvec 0, 1e-7 and 1e-5, near pi, zero
     tvec, an empty mask, 8192 slots (~421 in the mask) with a NaN or
     1e20 coordinates in masked-out slots, and 12288 slots (the compacted
     points in global scratch, beyond shared memory);
  3d. hold the board geometry's three kernels against their plain versions
     on seeded boards and BA problems (``tools/geometry_bench``), float32
     and float64: the BA Jacobians elementwise within 1e-5 (float64 1e-12)
     of max(1, |J|) of each observation's block at the known path's
     pose-only and global problems, 8 lanes, 8 lanes of 128 cameras (past
     the kernel's shared coefficient table), and rvec 0, 1e-7, 1e-3 and
     near pi; PnP poses within 1e-4 on the starts float32 rounding does
     not decide (all in float64) at the known path's call, a batch-row
     clip's (11 frames), one start, a 9x6 board on 128 frames (54 corners,
     past one warp's lanes), starts at rvec 0, 1e-7, 1e-3 and near pi, and
     NaN pixels in two frames (those NaN, the others the clean call's bit
     for bit), and the float division it uses (by a shared reciprocal)
     bit for bit IEEE division's on ~3.4e7 pairs
     (``geometry_bench.quotient_check``); the calibration LM's K and rms within
     1e-4 relative and poses within 1e-4 (float64, and float32 where it does
     not decide) at the known path's layout, with 5 distortion terms and a
     masked view, and at 128 and 384 such views (the last past the
     kernel's shared-memory budget); NaN patterns equal everywhere;
  3e. hold the relative pose's hypothesis, cheirality and scoring kernels
     (``csrc/relpose_hyp.cu``) against their plain versions in float32 and
     float64 (``tools/relpose_bench.hyp_agreement``: essential matrices up
     to sign and homographies within 1e-4, float64 1e-8, on the hypotheses
     float32 rounding does not decide and whose sample has a unique null
     vector; consensus counts exactly against the float64 count of the
     kernel's own matrices wherever no slot lies within rounding of the
     gate; the polish by what its H does to the inliers; poses after the
     cheirality vote within 1e-4 where one decomposition has the most
     votes (the votes printed); scores' good counts exact, truncated costs
     within 1e-2 or twice the plain version's own float32 / float64 spread;
     NaN patterns and infinities equal) at seeded calls of the paths'
     shapes (1024 hypotheses at 128 points, 2048 at 8192 slots with ~421
     in the mask, 2048 at 4096 with ~149) and at two edges (a NaN in a
     slot out of the mask; zero-t candidates); each dispatch point must
     give bit for bit what one launch of its wrapper gives; then render
     the headline clip (300 frames, 1080p) on the card;
  4. run ``process`` on the clip with ``headline_config()`` and the
     renderer's board corners twice, with the launch counts reset just
     before; check the
     repo's accuracy bounds and that every kernel ran on this path, the
     geometry's as the design gives: ``calib_lm`` twice per ``calibrate``,
     ``pnp_refine`` once per ``solve_pnp_batch``, ``obs_jacobians`` once
     per LM iteration (half the normal-equation solves); then compare the
     kernels once more at the path's own CLAHE input (all keyframes, grey
     at 540x960) and time them there, and the geometry kernels at the
     calls the first run made (both LM runs, both PnP calls, the pose-only
     and the global BA's first Jacobians); then the clip once more with the
     geometry's plain versions on the card: its ``calibration_rms_px`` and
     ``pose_ba_rmse_px`` within 1e-3 of the kernel run's, no geometry
     kernel launched;
  5. the board-finding default path: the same clip through ``process`` with
     ``detector_config(headline_config())`` (device pass 1, ``bgr_lab``
     enhance, device chessboard detector) and NO known corners, twice, with
     the launch counts reset just before; the same checks, exactly one
     ``lk_track`` launch per frame the keyframe scan took, and the
     geometry kernels' counts, their comparisons at the first run's calls
     and the plain-geometry run as in 4; then the clip
     once more with the plain Lucas-Kanade in place of the kernel: its scan
     flags and keyframe indices must be the kernel runs'; then the
     Lucas-Kanade kernel compared as in 3b at the scan's first call between
     two frames in the kernel runs (recorded: the clip's first two CLAHE'd
     pass-1 greys, 128 Shi-Tomasi points, the headline config's win 15, 4
     levels, 10 iterations) and timed there (device medians, cold L2) beside the
     bound from the work this run's data needed; then compare
     the kernels at this path's two CLAHE inputs, the first pass-1 chunk
     (32, 180, 320) and the keyframes' LAB lightness (n_kf, 540, 960), and
     time them there too;
  6. the marker-free path, at the width of the JAX package's marker-free
     bench variant: its board-free clip (120 grey frames, 1280x720, seed 1)
     rendered on the card, through ``process`` with ``markerless_config()``
     twice (launch counts reset just before); each run must come out
     marker-free with >= 3 keyframes, >= 100 finite points, a finite rmse
     within the bound and a finite hull volume, and both kernels must have
     launched; its pose and surface accuracy (Umeyama-aligned to the
     renderer's poses) and ``pose_chain`` seconds are printed beside the JAX
     package's record on this clip; ``obs_jacobians`` launches once per LM
     iteration of its pose-only refinements and in-chain BA, and neither
     ``calib_lm`` nor ``pnp_refine`` runs; the Jacobian kernel is compared
     as in 3d at the first run's first pose-only refinement and first
     in-chain BA; each run's bootstrap launches
     ``refine_relpose`` exactly once (its essential and homography
     candidates together) and each relative-pose kernel of 3e once (the
     homography's twice), and the kernels are compared as in 3c and 3e at
     the first run's calls and timed there; then the automatic fallback, the
     same clip once through ``detector_config(headline_config())`` with no
     corners: the device hunt must give up (``board_probe_exhausted`` >=
     ``board_probe_frames``), the run come out marker-free and launch
     ``refine_relpose`` and 3e's kernels once (the homography's twice),
     the Jacobian kernel compared at its chain's calls as before, the
     Lucas-Kanade kernel at its scan's first call between two frames and
     the relative pose's kernels at its bootstrap's calls; last,
     the CLAHE kernels at this path's
     keyframe input (n_kf, 360, 640), compared and timed;
  7. the multi-video batch, the JAX package's batch row: 8 clips of 60
     frames, 1080p, seeds 100-107, rendered on the card, through
     ``process_batch`` with ``batch_config()`` and no corners, twice (launch
     counts reset just before), the second time with ``mesh=make_mesh()``
     over every visible GPU; every clip must take the batch prepass and
     meet the rmse and volume bounds, each CLAHE kernel must launch once
     per clip, the geometry kernels as in 4 (counted, then compared at the
     first two LM runs and PnP calls and at the first Jacobians of the
     pose-only BA and of the lanes, without and with the mesh), and the mesh
     run's BA problems, solved in float64 with and
     without the mesh, must take the same iterations and rmse (rtol 1e-4;
     the whole runs' difference is printed);
     per-clip rmse and volume error are printed beside the JAX package's
     record;
  8. the pipelined schedule: the headline clip and a seed-7 render (300
     frames each, with their corners) through ``process_batch_pipelined``
     with ``headline_config()`` (launch counts reset just before), the same
     checks per clip, the geometry kernels counted and compared at its calls
     as in 4, then the same two through ``process`` one after the
     other; seconds and rmse of both are printed;
  9. odometry: ``chain_poses`` over the board-free clip of phase 6 with the
     scene's K (launch counts reset just before), one ``lk_track`` and one
     ``refine_relpose`` launch per step, and one of each of 3e's kernels
     (two of the homography's): more than 50 points
     tracked in every step and a chained-rotation error under 6 degrees
     over the first 10 steps (the JAX package's test bound); the drift over
     the clip is printed; its first 20 steps once more with the plain
     relative pose (refinement, hypotheses, vote, scores) on the card, and
     each step's rotation difference against the kernel run printed; then
     ``two_view.reconstruct_two_view`` on two of its frames (launch counts
     reset just before): one ``lk_track``, one ``refine_relpose`` and one
     of each of 3e's kernels (two of the homography's), at least 50
     inliers, finite points; the Lucas-Kanade, refinement and 3e's kernels
     compared and timed at both paths' own inputs (the odometry's first
     step, the two-view's matches); the synchronizing operations (sync
     debug mode) and kernel launches (profiler) of one warm
     ``estimate_relative_pose`` at the odometry's first step printed; then
     the CLAHE kernels compared
     and timed at the odometry's input (one 720x1280 frame) and at a batch
     clip's keyframes (none of phase 9's paths runs a board geometry
     kernel, and none launches); last, the command line as a subprocess, ``python3 -m meatmodeler_tpu_torch.cli``
     on one batch clip saved as ``.npy`` with ``--detector device --json``,
     then on two with ``--schedule mesh``: exit 0 and the JSON payload's keys;
 10. the mesh (``parallel.sharded``), first on four virtual shards of
     ``cuda:0``: (b) ``solve_ba_point_sharded`` on the known path's BA
     problem (recorded in phase 4) and on the JAX package's 12-frame,
     10240-point sharding-test problem, each against the unsharded
     ``solve_ba``: in float64 to the JAX package's bounds (rmse rtol 1e-4,
     equal iterations, cameras atol 1e-4, points atol 1e-3), in float32 the
     rmse (rtol 1e-4), its parameter differences printed beside the
     unsharded solve's own under a permutation of its observations (in
     float32 the known path's problem moves further than those bounds under
     any change of summation order), both timed, and the Jacobian kernel
     compared as in 3d at each problem's first shard call; (c)
     ``match_descriptors_tp`` over ``model`` on the known path's first
     keyframe pair (4096 x 256-bit descriptors, recorded in phase 4) against
     ``match_descriptors(cross_check=False)``: the same good mask and
     indices; (d) ``preprocess_sharded`` over ``data`` on 32 headline frames
     (launch counts reset just before) against ``enhanced_grey`` on one
     device (atol 1e-3), then the kernels compared and timed at one shard's
     CLAHE input; (e) the memory band: ``adjust_points`` with a budget half
     the known path's strip raises on one GPU and shards on several; (f)
     with more than one GPU, (b)-(d) again over the distinct GPUs, through
     NCCL, and the kernels compared on ``cuda:1``;
 11. the volume tools: ``tools/ideal_visual_hull`` at its defaults gives its
     decision record (truth 22.619, hull 36.360); ``tools/volume_validation``
     captures its ``e2e_400`` scene (400x300, 40 frames) through ``process``
     on the card, video alone, into a fresh directory (launch counts reset
     just before; the path's kernels counted as in 4), and its shipped
     variant's hull on the capture lies within 1e-4 relative of the hull the
     captured run computed, hull and carve finite; the error against the
     scene's truth is printed.
Kernel times are device medians with a cold L2 and the host's launch time
hidden (``tools/clahe_bench.time_ms``), each printed beside its bound and
the share of it reached: for CLAHE the bytes it must move at the card's
memory rate; for Lucas-Kanade the larger of the bytes its windows read
and its operations at the card's float32 rate, counted from the
iterations this run's points ran and where they sampled
(``tools/klt_bench``); for the refinement its operations on the points in
the mask at the float32 rate, for the relative pose's other kernels
their solves and consensus tests at the float32 rate
(``tools/relpose_bench.hyp_work``). The last two
lines are a JSON record of the kernels (launches summed over all paths;
CLAHE's times, bound and share at the known path's keyframes,
Lucas-Kanade's at the scan's input, the relative pose's kernels at the
odometry's first step (the homography kernel's two launches summed), the
geometry kernels' at the known path's own calls: its first
calibration LM run, its pose stage's PnP, its global BA's first Jacobians,
bounds from ``tools/geometry_bench``'s counts) and the device line.
Per-stage attribution, device busy share and the e2e spread come from
``python3 -m meatmodeler_tpu_torch.tools.profile_headline``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from meatmodeler_tpu_torch import pipeline
from meatmodeler_tpu_torch.config import SolverConfig
from meatmodeler_tpu_torch.geometry import (
    calibration, calibration_cuda, pnp, pnp_cuda, projection, ransac, ransac_cuda, ransac_hyp_cuda, so3,
)
from meatmodeler_tpu_torch.io import native_ops
from meatmodeler_tpu_torch.io.synthetic import TurntableScene
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.ops import clahe as clahe_mod
from meatmodeler_tpu_torch.ops import clahe_cuda, color, cuda_build, klt, klt_cuda, matching
from meatmodeler_tpu_torch.parallel import sharded
from meatmodeler_tpu_torch.parallel.batch import process_batch
from meatmodeler_tpu_torch.parallel.pipelined import process_batch_pipelined
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.solvers import bundle_adjust, bundle_adjust_cuda
from meatmodeler_tpu_torch.tools import geometry_bench as gb
from meatmodeler_tpu_torch.tools import ideal_visual_hull, volume_validation
from meatmodeler_tpu_torch.tools.clahe_bench import time_kernels
from meatmodeler_tpu_torch.tools.klt_bench import (
    describe,
    held_entries,
    lk_agreement,
    lk_agrees,
    lk_case,
    lk_kernel,
    time_lk,
)
from meatmodeler_tpu_torch.tools.path_calls import lk_call_case, relpose_call_case
from meatmodeler_tpu_torch.tools.relpose_bench import (
    CALLERS as RELPOSE_CALLERS,
    EDGE_CASES as RELPOSE_EDGES,
    HYP_CALLERS,
    HYP_CALLS,
    HYP_EDGES,
    PADDED_CASES as RELPOSE_PADDED,
    WIDE_CASE as RELPOSE_WIDE,
    caller_case,
    describe_hyp,
    determined,
    hyp_agreement,
    hyp_agrees,
    hyp_call_case,
    hyp_case,
    relpose_agreement,
    relpose_agrees,
    relpose_case,
    time_hyp,
    time_relpose,
    to_device,
)
from meatmodeler_tpu_torch.tools.relpose_bench import describe as describe_relpose
from meatmodeler_tpu_torch.tools.profile_headline import (
    HEADLINE_FRAMES,
    PP_SEED,
    SHARDED_PROBLEM,
    batch_clips,
    batch_config,
    detector_config,
    headline_clip,
    headline_config,
    markerless_accuracy,
    markerless_clip,
    markerless_config,
    odometry_accuracy,
    point_sharded_check,
    recording,
    synthetic_ba_problem,
    with_dtype,
)
from meatmodeler_tpu_torch.two_view import reconstruct_two_view

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
APPLY_TOL = 1e-4  # the LUT must match exactly
# The repo's own accuracy bounds for the headline clip (BENCH_r05.json,
# robustness.bounds).
RMSE_MAX_PX = 1.094
VOLUME_ERR_MAX = 0.35
# The JAX package's own record of its marker-free variant on the same clip
# (BENCH_LAST_GOOD.json, "markerless"): accuracy, no times.
JAX_MARKERLESS = {"keyframes": 6, "points": 565, "rmse_px": 0.6232, "aligned_pose_rmse_vs_ring": 0.2466,
                  "point_surface_residual_median": 3.8924, "board_probe_exhausted": 64}
# The JAX package's record of its batch row (BENCH_r05.json, quoted in
# VERDICT.md): |volume error| per clip, accuracy only.
JAX_BATCH_VOLUME_ERR = [0.023, 0.239, 0.237, 0.262, 0.178, 0.238, 0.215, 0.304]
ODOMETRY_ROT_ERR_MAX_DEG = 6.0  # over the first 10 steps (tests/test_odometry.py)
CLI_PAYLOAD_KEYS = {"video", "points", "keyframes", "volume", "volume_carved", "reprojection_rmse", "ply", "timings",
                    "counters"}
# name -> (what it replaces, its source)
KERNELS = {
    "clahe_lut": ("meatmodeler_tpu/ops/clahe_pallas.py:192", "meatmodeler_tpu_torch/csrc/clahe.cu"),
    "clahe_apply": ("meatmodeler_tpu/ops/clahe_pallas.py:208", "meatmodeler_tpu_torch/csrc/clahe.cu"),
    # An XLA fusion (jit of a vmap over points), not a pallas_call.
    "lk_track": ("meatmodeler_tpu/ops/klt.py:131", "meatmodeler_tpu_torch/csrc/klt.cu"),
    # An XLA program (a fori_loop vmapped over the candidates), not a pallas_call.
    "refine_relpose": ("meatmodeler_tpu/geometry/ransac.py:372", "meatmodeler_tpu_torch/csrc/relpose.cu"),
    # XLA programs around jax.jacfwd (a vmap over observations; a fori_loop
    # vmapped over frames; a while_loop), not pallas_calls.
    "obs_jacobians": ("meatmodeler_tpu/solvers/bundle_adjust.py:94", "meatmodeler_tpu_torch/csrc/ba_jac.cu"),
    "pnp_refine": ("meatmodeler_tpu/geometry/pnp.py:108", "meatmodeler_tpu_torch/csrc/pnp.cu"),
    "calib_lm": ("meatmodeler_tpu/geometry/calibration.py:158", "meatmodeler_tpu_torch/csrc/calib.cu"),
    # The rest of the jitted estimate_relative_pose (XLA, not pallas_calls):
    # vmap(solve_one) and the Sampson counts; find_homography_ransac (and
    # _decompose_homography, :600); recover_pose; the candidates' score.
    "essential_hypotheses": ("meatmodeler_tpu/geometry/ransac.py:502", "meatmodeler_tpu_torch/csrc/relpose_hyp.cu"),
    "homography_hypotheses": ("meatmodeler_tpu/geometry/ransac.py:665", "meatmodeler_tpu_torch/csrc/relpose_hyp.cu"),
    "recover_pose": ("meatmodeler_tpu/geometry/ransac.py:329", "meatmodeler_tpu_torch/csrc/relpose_hyp.cu"),
    "score_candidates": ("meatmodeler_tpu/geometry/ransac.py:544", "meatmodeler_tpu_torch/csrc/relpose_hyp.cu"),
}
HYP = ("essential_hypotheses", "homography_hypotheses", "recover_pose", "score_candidates")
GEOMETRY = ("obs_jacobians", "pnp_refine", "calib_lm")
# What each geometry kernel's launches are counted against: the calls of
# these functions in the same window.
GEOMETRY_CALLS = ((calibration, "calibrate"), (pnp, "solve_pnp_batch"), (bundle_adjust, "_solve_normal_equations"),
                  (bundle_adjust, "_solve_normal_equations_batch"))
# The BA callers at whose first Jacobians each path holds the kernel:
# the board paths' pose-only BA and global BA, the batch's pose-only BA and
# its lanes (without and with a mesh), the marker-free chain's pose-only
# refinements and in-chain BA, the point-sharded solve's shards.
OBS_JACOBIANS = (bundle_adjust_cuda, "obs_jacobians")
BOARD_BA = ((bundle_adjust, "adjust_pose"), (bundle_adjust, "adjust_points"))
BATCH_BA = ((bundle_adjust, "adjust_pose"), (bundle_adjust, "solve_ba_batch"), (sharded, "solve_ba_batch"))
CHAIN_BA = ((bundle_adjust, "pose_only_refine"), (bundle_adjust, "adjust_points"))
SHARDED_BA = ((sharded, "solve_ba_point_sharded"),)
GEOMETRY_RMSE_RTOL = 1e-3  # a path's calibration and pose-BA rms, kernels against plain versions
CLAHE = ("clahe_lut", "clahe_apply")
# Phase 3b's seeded Lucas-Kanade cases (``tools/klt_bench.lk_case``).
LK_CASES = ("scan", "odometry", "two_view", "flat", "masked", "scan_edges", "two_view_edges", "ragged", "deep_edges")
RELPOSE_TOL = 1e-4  # on the candidates float32 rounding does not decide
ODOMETRY_PLAIN_STEPS = 20


LIBRARIES = (clahe_cuda, klt_cuda, ransac_cuda, ransac_hyp_cuda, bundle_adjust_cuda, pnp_cuda, calibration_cuda)


def reset_counts() -> None:
    for lib in LIBRARIES:
        lib.reset_launches()


def counts() -> dict:
    return {k: v for lib in LIBRARIES for k, v in lib.LAUNCHES.items()}


@contextlib.contextmanager
def geometry_counts():
    """Within the block, the calls of each of ``GEOMETRY_CALLS`` (from any
    thread), one entry a call; yields {name: list}."""
    with contextlib.ExitStack() as stack:
        yield {name: stack.enter_context(recording(module, name, keep=False)) for module, name in GEOMETRY_CALLS}


@contextlib.contextmanager
def first_calls_within(target, *callers):
    """Within the block, the (args, kwargs) of the first call of ``target``
    ((module, name)) that each of ``callers`` ((module, name), ...) makes,
    on whichever host thread it runs, as {"module.name" of the caller:
    (args, kwargs)}."""
    first, local = {}, threading.local()
    module, name = target
    real = getattr(module, name)

    def call(*args, **kwargs):
        inside = getattr(local, "inside", None)
        if inside and inside[-1] not in first:
            first[inside[-1]] = (args, kwargs)
        return real(*args, **kwargs)

    def within(caller, key):
        def run(*args, **kwargs):
            local.__dict__.setdefault("inside", []).append(key)
            try:
                return caller(*args, **kwargs)
            finally:
                local.inside.pop()

        return run

    patches = [(module, name, real, call)]
    for m, n in callers:
        patches.append((m, n, getattr(m, n), within(getattr(m, n), f"{m.__name__.rsplit('.', 1)[-1]}.{n}")))
    for m, n, _, fn in patches:
        setattr(m, n, fn)
    try:
        yield first
    finally:
        for m, n, orig, _ in reversed(patches):
            setattr(m, n, orig)


def check_geometry(label, launches, calls, board: bool, chain: bool = True) -> None:
    """The geometry kernels' launches against the design: ``calib_lm`` twice
    per ``calibrate``, ``pnp_refine`` once per ``solve_pnp_batch``,
    ``obs_jacobians`` once per LM iteration (two normal-equation solves an
    iteration); on a board path all three ran, on the marker-free chain
    (``chain``) the Jacobians did, elsewhere none. ``calls`` is
    ``geometry_counts``'."""
    n = {k: len(v) for k, v in calls.items()}
    solves = n["_solve_normal_equations"] + n["_solve_normal_equations_batch"]
    print(f"[{label}] geometry launches {({k: launches[k] for k in GEOMETRY})} for {n['calibrate']} calibrate, "
          f"{n['solve_pnp_batch']} solve_pnp_batch, {solves} normal-equation solves")
    if launches["calib_lm"] != 2 * n["calibrate"] or launches["pnp_refine"] != n["solve_pnp_batch"]:
        raise AssertionError(f"calib_lm or pnp_refine did not launch as the design gives on the {label} path")
    if 2 * launches["obs_jacobians"] != solves:
        raise AssertionError(f"obs_jacobians did not launch once per LM iteration on the {label} path")
    if board and min(launches[k] for k in GEOMETRY) <= 0:
        raise AssertionError(f"a geometry kernel of the {label} path never launched: {launches}")
    if not board and (launches["calib_lm"] or launches["pnp_refine"] or bool(launches["obs_jacobians"]) != chain):
        raise AssertionError(f"the geometry kernels of the {label} path launched against the design: {launches}")


@contextlib.contextmanager
def plain_geometry():
    """The board geometry's dispatch points on their plain versions on the
    card, for comparison."""
    real = cuda_build.on_card
    cuda_build.on_card = lambda t: False
    try:
        yield
    finally:
        cuda_build.on_card = real


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] += v


@contextlib.contextmanager
def scan_recorder():
    """Records the flags of every keyframe-scan chunk the pipeline runs
    (one (frames,) bool tensor per call) by wrapping the scan it builds."""
    real = pipeline._make_keyframe_scan
    record = []

    def make(config):
        init, scan_chunk = real(config)

        def chunk(carry, greys, width_scale=1):
            carry, flags = scan_chunk(carry, greys, width_scale=width_scale)
            record.append(flags)
            return carry, flags

        return init, chunk

    pipeline._make_keyframe_scan = make
    try:
        yield record
    finally:
        pipeline._make_keyframe_scan = real


@contextlib.contextmanager
def plain_lk():
    """Lucas-Kanade through its plain version on the card, for comparison."""
    real = klt.lucas_kanade
    klt.lucas_kanade = klt.lucas_kanade_reference
    try:
        yield
    finally:
        klt.lucas_kanade = real


@contextlib.contextmanager
def plain_relpose():
    """``estimate_relative_pose``'s dispatch points (the refinement, the
    hypotheses, the cheirality vote and the scores) on their plain versions
    on the card, for comparison."""
    names = ("refine_relative_pose", *HYP_CALLS)
    real = {name: getattr(ransac, name) for name in names}
    for name in names:
        setattr(ransac, name, getattr(ransac, f"{name}_reference"))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ransac, name, fn)


@contextlib.contextmanager
def first_hyp_calls():
    """Within the block, the first call of each of ``HYP_CALLS``' dispatch
    points (from any thread), as {name: its plain version's positional
    arguments}."""
    first, real = {}, {name: getattr(ransac, name) for name in HYP_CALLS}

    def wrap(name, fn):
        def call(*args, **kwargs):
            if name not in first:
                first[name] = hyp_call_case(name, (args, kwargs))
            return fn(*args, **kwargs)

        return call

    for name, fn in real.items():
        setattr(ransac, name, wrap(name, fn))
    try:
        yield first
    finally:
        for name, fn in real.items():
            setattr(ransac, name, fn)


def check_hyp_launches(label, launches, estimates: int) -> None:
    """Each of the hypothesis, cheirality and scoring kernels once per
    ``estimate_relative_pose`` (the homography kernel twice: hypotheses,
    then polish and decomposition)."""
    want = {name: estimates * (2 if name == "homography_hypotheses" else 1) for name in HYP}
    got = {name: launches[name] for name in HYP}
    print(f"[{label}] relative-pose kernel launches {got} for {estimates} estimate_relative_pose")
    if got != want:
        raise AssertionError(f"the relative-pose kernels did not launch as the design gives on the {label} path: "
                             f"{got}, expected {want}")


def compare_hyp(cases, err, seeded: bool = False):
    """The hypothesis, cheirality and scoring kernels against their plain
    versions at each (label, {dispatch point: arguments on the card}):
    ``ransac.<name>`` must give bit for bit what one launch of the wrapper
    gives, and that must agree with the plain version, float32 and float64
    (``tools/relpose_bench.hyp_agreement``; ``seeded`` cases must hold at
    least one item of each kind); raises on disagreement, folds the largest
    held difference into ``err``."""
    for label, calls in cases:
        for name, args in calls.items():
            kernel = HYP_CALLS[name]
            got = getattr(ransac, name)(*args)
            once = getattr(ransac_hyp_cuda, name)(*args)
            a = hyp_agreement(name, args)
            torch.cuda.synchronize()
            print(f"kernel check {kernel} ({name}) {label}: {json.dumps(a)}")
            for x, y in zip(got, once):
                if x is not None:
                    torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                               msg=f"ransac.{name} and one {kernel} launch differ at {label}")
            if not hyp_agrees(name, a, need_held=seeded):
                raise AssertionError(f"{kernel} ({name}) disagrees with its plain version at {label}")
            worst = a.get("max_held", 0.0) if name != "homography_polish" else a["decompositions"] if a["held"] else 0.0
            err[kernel] = max(err[kernel], worst)


def time_hyp_at(label, calls, timings):
    """Times of the four kernels (the homography's two modes apart) at a
    path's calls, kept in ``timings[label]``."""
    rows = timings[label] = {name: time_hyp(name, args) for name, args in calls.items()}
    for name, r in rows.items():
        print("time " + describe_hyp(label, name, r))


def count_estimate_syncs(call):
    """One warm ``estimate_relative_pose`` at a recorded call's arguments:
    the synchronizing CUDA operations torch's sync debug mode reports
    (which misses some), and the kernels the profiler sees launched."""
    args, kwargs = call
    kwargs = dict(kwargs, generator=torch.Generator(device="cuda").manual_seed(0))
    ransac.estimate_relative_pose(*args, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ransac.estimate_relative_pose(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ransac.estimate_relative_pose(*args, **kwargs)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[odometry] one warm estimate_relative_pose at step 1's call: {len(syncs)} synchronizing operations "
          f"(sync debug mode) {syncs[:5]}; {launches} kernel launch calls and {kernels} device activities (profiler)")
    return len(syncs), launches


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare_kernels(dev, cases, err):
    """Each kernel against its plain version; raises on disagreement, folds
    the max errors into ``err``. A case is (label, float32 image stack on
    the card, tiles)."""
    for label, img, tiles in cases:
        lut_k = clahe_cuda.clahe_lut(img, 3.5, tiles)
        lut_p = clahe_mod.lut_reference(img, 3.5, tiles)
        out_k = clahe_cuda.clahe_apply(img, lut_p, tiles)
        out_p = clahe_mod.apply_reference(img, lut_p, tiles)
        whole = (clahe_mod.clahe(img, tiles=tiles) - clahe_mod.clahe_reference(img, tiles=tiles)).abs().max()
        torch.cuda.synchronize()
        e_lut = float((lut_k - lut_p).abs().max())
        e_app = max(float((out_k - out_p).abs().max()), float(whole))
        print(f"kernel check {label} {tuple(img.shape)} tiles={tiles}: lut max|d|={e_lut:.3g} apply max|d|={e_app:.3g}")
        if not (e_lut == 0.0 and e_app <= APPLY_TOL):
            raise AssertionError(f"CLAHE kernel disagrees with its plain version at {label}")
        err["clahe_lut"] = max(err["clahe_lut"], e_lut)
        err["clahe_apply"] = max(err["clahe_apply"], e_app)


def seeded_cases(dev):
    """Seeded uint8-valued images and the kernels' edge cases."""
    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.float32)).to(dev)

    yy, xx = torch.meshgrid(torch.arange(540, device=dev), torch.arange(960, device=dev), indexing="ij")
    board = torch.where((yy // 60 + xx // 60) % 2 == 0, 235.0, 20.0).expand(2, 540, 960).contiguous()
    return [
        ("seeded", rand((4, 540, 960)), (8, 8)),
        ("seeded", rand((2, 67, 120)), (8, 8)),
        ("seeded", rand((1, 64, 80)), (4, 4)),
        ("flat", torch.full((3, 180, 320), 135.0, device=dev), (8, 8)),
        ("unaligned", rand((2, 67, 121)), (8, 8)),
        ("unaligned", rand((2, 67, 121)), (4, 4)),
        ("two-tone board", board, (8, 8)),
    ]


def time_at(label, img, timings):
    """Times of both kernels at ``img``, printed beside their bounds, kept
    in ``timings[label]``."""
    rows = timings[label] = time_kernels(img)
    rows["shape"] = list(img.shape)
    for name in CLAHE:
        r = rows[name]
        print(f"time {label} {tuple(img.shape)} {name}: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f} ms), "
              f"{r['bytes']} B, bound {r['bound_ms']:.6f} ms, share of bound {r['share']:.3f}")


def compare_lk(cases, err):
    """The Lucas-Kanade kernel against its plain version at each (label,
    case): ``klt.lucas_kanade`` must give bit for bit what one launch of
    the wrapper gives, and that must agree with the plain version
    (``tools/klt_bench.lk_agreement``); raises on disagreement, folds the
    max point difference into ``err``."""
    for label, (prev, curr, pts, mask, flow, s) in cases:
        got = klt.lucas_kanade(prev, curr, pts, point_mask=mask, initial_flow=flow, **s)
        res, iterations, _ = lk_kernel(prev, curr, pts, mask, flow, s)
        ref = klt.lucas_kanade_reference(prev, curr, pts, point_mask=mask, initial_flow=flow, **s)
        torch.cuda.synchronize()
        held = held_entries(pts, mask, flow)
        a = lk_agreement(res, ref, held)
        print(f"kernel check lk_track {label} {tuple(prev[0].shape)} x {len(pts)} points {s}: tracked "
              f"{int(res.status.sum())}, {json.dumps(a)}; padding entries that converged: "
              f"{int(((iterations < s['max_iters']).all(dim=1) & ~held).sum())}")
        if flow is not None:
            cpu = klt.lucas_kanade_reference([p.cpu() for p in prev], [p.cpu() for p in curr], pts.cpu(),
                                             point_mask=None if mask is None else mask.cpu(),
                                             initial_flow=flow.cpu(), **s)
            spread = lk_agreement(klt.FlowResult(*(t.to(pts.device) for t in cpu)), ref, held)
            print(f"  the plain version on the CPU against it on the card: {json.dumps(spread)}")
        for x, y in zip(got, res):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"lucas_kanade and one lk_track launch differ at {label}")
        if not lk_agrees(a, s["eps"]):
            raise AssertionError(f"lk_track disagrees with its plain version at {label}")
        err["lk_track"] = max(err["lk_track"], a["max_point"])


def time_lk_at(label, case, timings):
    timings[label] = time_lk(*case)
    print("time " + describe(label, timings[label]))


def compare_relpose(cases, err):
    """The refinement kernel against its plain version at each (label,
    (rvec, tvec, pts1, pts2, mask, K) on the card): ``ransac.
    refine_relative_pose`` must give bit for bit what one launch of the
    wrapper gives, and that must agree with the plain version (``tools/
    relpose_bench.relpose_agreement``, held candidates from the plain
    version in float32 against float64), and over all ``cases`` at least a
    quarter of the candidates must be held; raises on disagreement, folds
    the max held difference into ``err``."""
    held = total = 0
    for label, args in cases:
        got = ransac.refine_relative_pose(*args)
        once = ransac_cuda.refine_relpose(*args)
        ref = ransac.refine_relative_pose_reference(*args)
        ref64 = ransac.refine_relative_pose_reference(*(a.double() if a.is_floating_point() else a for a in args))
        torch.cuda.synchronize()
        a = relpose_agreement(got, ref, determined(ref, ref64))
        print(f"kernel check refine_relpose {label} {args[0].shape[0]} candidates x {args[2].shape[0]} points "
              f"({int(args[4].sum())} in the mask): {json.dumps(a)}")
        for x, y in zip(got, once):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"refine_relative_pose and one refine_relpose launch differ at {label}")
        if not relpose_agrees(a, RELPOSE_TOL):
            raise AssertionError(f"refine_relpose disagrees with its plain version at {label}")
        err["refine_relpose"] = max(err["refine_relpose"], a["max_held"])
        held, total = held + a["held"], total + a["candidates"]
    if 4 * held < total:
        raise AssertionError(f"only {held} of {total} refinement candidates were held: the check says too little")


def time_relpose_at(label, args, timings):
    timings[label] = time_relpose(*args)
    print("time " + describe_relpose(label, timings[label]))


def _f64(args):
    return tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args)


def compare_obs_jacobians(label, args, err):
    """The BA Jacobian kernel against its plain version at one call's
    (cam, pts, K, fidx, pidx, mask, weight): ``_obs_jacobians`` must give bit
    for bit what one launch of the wrapper gives, and that must lie within
    1e-5 (float64: 1e-12) of the plain version relative to max(1, |J|) of
    each observation's block (``geometry_bench.jacobian_agreement``)."""
    cam, pts, k, fidx, pidx, mask, weight = args
    got = bundle_adjust._obs_jacobians(cam, pts, k, None, fidx, pidx, mask, weight)
    once = bundle_adjust_cuda.obs_jacobians(*args)
    ref = gb.ba_plain(*args)
    torch.cuda.synchronize()
    a = gb.jacobian_agreement(got, ref)
    tol = gb.JAC_TOL if cam.dtype == torch.float32 else 1e-12
    print(f"kernel check obs_jacobians {label} {str(cam.dtype)[6:]} {tuple(cam.shape)} cameras, {tuple(pts.shape)} "
          f"points, {tuple(fidx.shape)} observations: {json.dumps(a)}")
    for x, y in zip(got, once):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=f"_obs_jacobians and one obs_jacobians launch differ at {label}")
    if not gb.jacobians_agree(a, tol):
        raise AssertionError(f"obs_jacobians disagrees with its plain version at {label}")
    if cam.dtype == torch.float32:
        err["obs_jacobians"] = max(err["obs_jacobians"], a["max_rel"])


def compare_pnp(label, args, err):
    """The PnP kernel against its plain version at one call's (starts (T, F,
    6), board, pixels, K, iterations, damping): poses within 1e-4 on the
    starts whose plain float32 result lies within 1e-5 of float64 (all in
    float64), NaN patterns equal everywhere, the rest printed."""
    got = pnp_cuda.pnp_refine(*args)
    ref = gb.pnp_plain(*args)
    if args[0].dtype == torch.float32:
        held = gb.pnp_determined(ref[0], gb.pnp_plain(*_f64(args))[0])
    else:
        held = torch.ones(ref[0].shape[:2], dtype=torch.bool, device=ref[0].device)
    torch.cuda.synchronize()
    a = gb.pnp_agreement(got, ref, held)
    print(f"kernel check pnp_refine {label} {str(args[0].dtype)[6:]} {tuple(args[0].shape[:2])} starts x "
          f"{args[1].shape[0]} points: {json.dumps(a)}")
    if not gb.pnp_agrees(a):
        raise AssertionError(f"pnp_refine disagrees with its plain version at {label}")
    if args[0].dtype == torch.float32:
        err["pnp_refine"] = max(err["pnp_refine"], a["max_held"])


def compare_calib(label, args, err):
    """The calibration LM kernel against its plain version at one
    ``run_lm`` call's arguments, in float64 (K and rms within 1e-4
    relative, distortion and poses within 1e-4) and, where the plain
    float32 run lies within 1e-5 of float64, in float32 the same; NaN
    patterns equal everywhere, the gap printed. Returns the kernel's
    float32 iterations."""
    theta0, img = args[0], args[1]
    n_intr = theta0.shape[0] - 6 * img.shape[0]
    mask = args[8]
    n_fp = (1 if args[7] else 2) + (0 if args[6] else 2)
    points = int(img.shape[0] if mask is None else mask.sum()) * img.shape[1]
    ref32, ref64 = calibration.run_lm_reference(*args), calibration.run_lm_reference(*_f64(args))
    got32, got64 = calibration_cuda.calib_lm(*args), calibration_cuda.calib_lm(*_f64(args))
    torch.cuda.synchronize()
    a64 = gb.calib_agreement(got64, ref64, n_intr, n_fp, points, True)
    a32 = gb.calib_agreement(got32, ref32, n_intr, n_fp, points, gb.calib_determined(ref32, ref64))
    print(f"kernel check calib_lm {label} {tuple(img.shape)} n_intr {n_intr}: float64 {json.dumps(a64)}; float32 "
          f"{json.dumps(a32)} (iterations kernel {int(got32[2])}); K kernel / plain / float64 "
          f"{got32[0][:n_intr].tolist()} / {ref32[0][:n_intr].tolist()} / {ref64[0][:n_intr].tolist()}")
    if not (gb.calib_agrees(a64) and gb.calib_agrees(a32)):
        raise AssertionError(f"calib_lm disagrees with its plain version at {label}")
    err["calib_lm"] = max(err["calib_lm"], a32["k_rel"] if a32["held"] else 0.0)
    return int(got32[2])


def check_pnp_nan(dev, dtype):
    """The PnP kernel with NaN pixels in two frames (``geometry_bench.
    PNP_NAN``): those frames' poses and costs NaN, every other frame's bit
    for bit the clean call's."""
    nan = pnp_cuda.pnp_refine(*gb.pnp_refine_case(gb.PNP_NAN, dev, dtype))
    clean = pnp_cuda.pnp_refine(*gb.pnp_refine_case("pnp", dev, dtype))
    bad = list(gb.PNP_NAN_FRAMES)
    keep = [f for f in range(clean[0].shape[1]) if f not in bad]
    torch.cuda.synchronize()
    if not (bool(nan[0][:, bad].isnan().all()) and bool(nan[1][:, bad].isnan().all())):
        raise AssertionError("pnp_refine gave a finite pose or cost for a frame with NaN pixels")
    if not (torch.equal(nan[0][:, keep], clean[0][:, keep]) and torch.equal(nan[1][:, keep], clean[1][:, keep])):
        raise AssertionError("NaN pixels in one frame changed pnp_refine's other frames")
    print(f"kernel check pnp_refine NaN frames {bad} {str(dtype)[6:]}: NaN there, the other frames the clean call's")


def compare_geometry_seeded(dev, err):
    """Phase 3d: the three geometry kernels on seeded boards and BA problems."""
    for dtype in (torch.float32, torch.float64):
        for name in (*gb.BA_CASES, gb.BA_WIDE):
            compare_obs_jacobians(f"seeded {name}", tuple(gb.ba_case(name, dev, dtype)), err)
        for name in gb.COMPARE_PNP:
            compare_pnp(f"seeded {name}", gb.pnp_refine_case(name, dev, dtype), err)
        check_pnp_nan(dev, dtype)
    q = gb.quotient_check(dev)
    print(f"kernel check pnp_refine's float division by a shared reciprocal against IEEE division: {json.dumps(q)}")
    if q["mismatches"] or q["unsafe_specials_marked_safe"]:
        raise AssertionError("the shared-reciprocal division differs from IEEE division")
    for name in ("calibrate", "calibrate_dist5", gb.CALIB_WIDE, gb.CALIB_WIDER):
        compare_calib(f"seeded {name}", gb.lm_args(gb.calib_case(name), dev), err)


def call_args(fn, call):
    """A recorded call of ``fn`` as its positional arguments, defaults
    filled in."""
    bound = inspect.signature(fn).bind(*call[0], **call[1])
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def compare_first_jacobians(label, callers, first, err):
    """The BA Jacobian kernel at the first call each of ``callers`` made
    (``first``, from ``first_calls_within``); raises if one made none.
    Returns {"module.name": the call's arguments}."""
    keys = [f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m, n in callers]
    missing = [k for k in keys if k not in first]
    if missing:
        raise AssertionError(f"no obs_jacobians call within {missing} on the {label} path")
    bas = {k: call_args(bundle_adjust_cuda.obs_jacobians, first[k]) for k in keys}
    for k, args in bas.items():
        compare_obs_jacobians(f"{label} {k}'s first", args, err)
    return bas


def geometry_at_path(label, calib_calls, pnp_calls, ba_first, ba_callers, err, timings=None):
    """The geometry kernels compared at a path's own calls: its first two
    calibration LM runs and PnP calls (on one host thread: one calibrate's
    two runs, its rescue pass and the pose stage; with two, possibly two
    clips'), and the first Jacobians of each of ``ba_callers``
    (``compare_first_jacobians``). With ``timings``, times them at the first
    LM run, the second PnP call and the first Jacobians of the pose-only
    and the global BA."""
    calib = [call_args(calibration_cuda.calib_lm, c) for c in calib_calls[:2]]
    pnps = [call_args(pnp_cuda.pnp_refine, c) for c in pnp_calls[:2]]
    if len(calib) < 2 or len(pnps) < 2:
        raise AssertionError(f"the {label} path made {len(calib)} calib_lm and {len(pnps)} pnp_refine calls, not 2")
    for i, args in enumerate(calib):
        compare_calib(f"{label} calib_lm call {i + 1}", args, err)
    for i, args in enumerate(pnps):
        compare_pnp(f"{label} pnp_refine call {i + 1}", args, err)
    bas = compare_first_jacobians(label, ba_callers, ba_first, err)
    if timings is None:
        return
    rows = {
        "calib_lm": gb.time_calib(*calib[0]),
        "pnp_refine": gb.time_pnp(*pnps[1]),
        "obs_jacobians": gb.time_ba(*bas["bundle_adjust.adjust_points"]),
        "obs_jacobians pose-only": gb.time_ba(*bas["bundle_adjust.adjust_pose"]),
    }
    for name, r in rows.items():
        print("time " + gb.describe(name, label, r))
    timings[label] = rows


@contextlib.contextmanager
def geometry_recorded(ba_callers):
    """Within the block, the geometry kernels' calls, recorded: yields
    (calib_lm calls, pnp_refine calls, first Jacobians within each of
    ``ba_callers``, ``geometry_counts``')."""
    with recording(calibration_cuda, "calib_lm") as calib_calls, recording(pnp_cuda, "pnp_refine") as pnp_calls, \
            first_calls_within(OBS_JACOBIANS, *ba_callers) as ba_first, geometry_counts() as calls:
        yield calib_calls, pnp_calls, ba_first, calls


def run_plain_geometry(label, scene, frames, corners, config, c):
    """The clip once more with the geometry's plain versions on the card:
    the bounds hold, no geometry kernel launches, and its calibration and
    pose-BA rms lie within 1e-3 of the kernel run's (counters ``c``)."""
    before = {k: counts()[k] for k in GEOMETRY}
    with plain_geometry():
        t0 = time.perf_counter()
        res = process(frames, config=config, known_corners=corners, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    p = res.metrics["counters"]
    print(f"[{label}] plain geometry on the card: wall {wall:.3f} s, stages "
          f"{json.dumps({k: round(res.metrics['timings'][k], 4) for k in ('calibration', 'pose_estimation', 'pose_ba')})}"
          f"; calibration_rms_px {p['calibration_rms_px']:.6f} (kernels {c['calibration_rms_px']:.6f}), "
          f"pose_ba_rmse_px {p['pose_ba_rmse_px']:.6f} (kernels {c['pose_ba_rmse_px']:.6f}), rmse "
          f"{res.reprojection_rmse:.4f}")
    check_clip(res, scene)
    if {k: counts()[k] for k in GEOMETRY} != before:
        raise AssertionError(f"the plain-geometry run launched a geometry kernel: {counts()}")
    for name in ("calibration_rms_px", "pose_ba_rmse_px"):
        if not abs(p[name] - c[name]) <= GEOMETRY_RMSE_RTOL * abs(p[name]):
            raise AssertionError(f"{name} with the kernels differs from the plain versions' on the {label} path")


def run_path(label, scene, frames, corners, config, err, timings=None):
    """One path through ``process`` on the headline clip, twice, with the
    launch counts reset just before and read just after. With the device
    pass 1 the keyframe scan must launch ``lk_track`` exactly once per
    frame it takes. Then the geometry kernels at the first run's calls
    (``geometry_at_path``). Returns (launches, counters of the last run,
    that run's scan flags or None)."""
    reset_counts()
    with geometry_recorded(BOARD_BA) as (calib_calls, pnp_calls, ba_first, calls):
        c, records = _run_twice(label, scene, frames, corners, config)
    scanned = sum(len(f) for record in records for f in record)
    launches = counts()
    if min(launches[k] for k in CLAHE) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    check_geometry(label, launches, calls, board=True)
    if config.pass1_backend == "device":
        print(f"[{label}] lk_track launches {launches['lk_track']} for {scanned} frames scanned in two runs")
        if scanned == 0 or launches["lk_track"] != scanned:
            raise AssertionError(f"the keyframe scan did not launch lk_track once per frame: {launches}, {scanned}")
    geometry_at_path(f"{label} path", calib_calls, pnp_calls, ba_first, BOARD_BA, err, timings)
    return launches, c, (torch.cat(records[-1]).cpu() if records[-1] else None)


def _run_twice(label, scene, frames, corners, config):
    """``run_path``'s two runs, each held to the repo's bounds; returns the
    last run's counters and each run's recorded scan flags."""
    records = []
    for run in range(2):
        with scan_recorder() as record:
            t0 = time.perf_counter()
            res = process(frames, path=str(OUT / f"{label}{run}"), config=config, known_corners=corners, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        records.append(record)
        c = res.metrics["counters"]
        vol_err = (res.volume - scene.volume) / scene.volume
        low = res.volume_confidence["low_confidence"]
        print(f"[{label}] run {run}: wall {wall:.3f} s ({HEADLINE_FRAMES / wall:.2f} fps)")
        print("  stages:", json.dumps({k: round(v, 4) for k, v in res.metrics["timings"].items()}))
        print(f"  keyframes {c['keyframes']} of {c['keyframes_selected']} selected, points {len(res.points)} "
              f"rmse {res.reprojection_rmse:.4f} volume {res.volume:.4f} carved {res.volume_carved:.4f} "
              f"truth {scene.volume:.4f} err {vol_err:+.4f} confidence {json.dumps(res.volume_confidence)}")
        print(f"  keyframe indices {c['keyframe_indices']}")
        print(f"  pass1_keyframes {res.metrics['timings']['pass1_keyframes']:.4f} s (unsynced), frames scanned "
              f"{sum(len(f) for f in record)}, launches so far {counts()}")
        if c["keyframes"] < 3 or len(res.points) < 500:
            raise AssertionError("too few keyframes or points")
        if not (np.isfinite(res.reprojection_rmse) and res.reprojection_rmse <= RMSE_MAX_PX):
            raise AssertionError(f"rmse {res.reprojection_rmse} outside {RMSE_MAX_PX}")
        if not np.isfinite(res.points).all() or res.points.shape[1] != 3:
            raise AssertionError("non-finite or misshapen cloud")
        if not low and not abs(vol_err) <= VOLUME_ERR_MAX:
            raise AssertionError(f"hull volume error {vol_err} outside {VOLUME_ERR_MAX}")
    return c, records


def check_scan_plain(frames, config, flags, kf_indices):
    """Phase 5: the clip once more with the plain Lucas-Kanade on the card:
    its scan flags and keyframe indices must be the kernel run's."""
    before = klt_cuda.LAUNCHES["lk_track"]
    with scan_recorder() as record, plain_lk():
        t0 = time.perf_counter()
        res = process(frames, config=config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    plain = torch.cat(record).cpu()
    kf = res.metrics["counters"]["keyframe_indices"]
    same = torch.equal(plain, flags) and kf == kf_indices
    print(f"[detector] plain Lucas-Kanade on the card: wall {wall:.3f} s, pass1_keyframes "
          f"{res.metrics['timings']['pass1_keyframes']:.4f} s (unsynced), {len(plain)} frames scanned, "
          f"{int(plain.sum())} flagged; keyframe indices {kf}; same as the kernel's: {same}")
    if klt_cuda.LAUNCHES["lk_track"] != before:
        raise AssertionError("the plain run launched lk_track")
    if not same:
        raise AssertionError("the scan's keyframes with lk_track differ from the plain version's")


def run_markerless(scene, frames, poses, err):
    """Phase 6's two ``markerless_config()`` runs, with the launch counts
    reset just before and read just after, the geometry's as the design
    gives; the BA Jacobian kernel at the first pose-only refinement and the
    first in-chain BA. Returns (launches, counters)."""
    config = markerless_config()
    reset_counts()
    with first_calls_within(OBS_JACOBIANS, *CHAIN_BA) as ba_first, geometry_counts() as calls:
        c = _run_markerless_twice(scene, frames, poses, config)
    launches = counts()
    if min(launches[k] for k in CLAHE) <= 0:
        raise AssertionError(f"a kernel of the markerless path never launched: {launches}")
    if launches["refine_relpose"] != 2:
        raise AssertionError(f"the bootstrap did not launch refine_relpose once a run: {launches}")
    check_hyp_launches("markerless", launches, 2)
    check_geometry("markerless", launches, calls, board=False)
    compare_first_jacobians("markerless", CHAIN_BA, ba_first, err)
    return launches, c


def _run_markerless_twice(scene, frames, poses, config):
    """``run_markerless``'s two runs, each held to the bounds; returns the
    last run's counters."""
    for run in range(2):
        t0 = time.perf_counter()
        res = process(frames, path=str(OUT / f"markerless{run}"), config=config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = res.metrics["counters"]
        acc = markerless_accuracy(res, poses, scene)
        print(f"[markerless] run {run}: wall {wall:.3f} s ({len(frames) / wall:.2f} fps)")
        print("  stages:", json.dumps({k: round(v, 4) for k, v in res.metrics["timings"].items()}))
        print(f"  keyframes {c['keyframes']} indices {c['keyframe_indices']} points {len(res.points)} "
              f"rmse {res.reprojection_rmse:.4f} hull volume {res.volume:.6g} (gauge units) chain support "
              f"{c['pose_chain_inliers']}")
        print(f"  pose_chain {res.metrics['timings']['pose_chain']:.4f} s")
        print(f"  aligned pose RMSE / ring {acc['aligned_pose_rmse_vs_ring']:.4f} (JAX package's record "
              f"{JAX_MARKERLESS['aligned_pose_rmse_vs_ring']}; gauge scale {acc['gauge_scale']:.4f})")
        print(f"  point-surface residual median {acc['point_surface_residual_median']:.4f} (JAX package's record "
              f"{JAX_MARKERLESS['point_surface_residual_median']})")
        print(f"  JAX package's record on this clip: {json.dumps(JAX_MARKERLESS)}")
        print(f"  launches so far {counts()}")
        if c.get("markerless") is not True:
            raise AssertionError("the marker-free path did not engage")
        if c["keyframes"] < 3 or len(res.points) < 100:
            raise AssertionError("too few keyframes or points")
        if not np.isfinite(res.points).all() or res.points.shape[1] != 3:
            raise AssertionError("non-finite or misshapen cloud")
        if not (np.isfinite(res.reprojection_rmse) and res.reprojection_rmse <= RMSE_MAX_PX):
            raise AssertionError(f"rmse {res.reprojection_rmse} outside {RMSE_MAX_PX}")
        if not np.isfinite(res.volume):
            raise AssertionError("non-finite hull volume")
    return c


def run_fallback(frames):
    """The automatic fallback on the device pass 1: no board anywhere, so
    the hunt gives up and pass 1 runs again without the board gate."""
    config = detector_config(headline_config())
    t0 = time.perf_counter()
    res = process(frames, config=config, device="cuda")
    torch.cuda.synchronize()
    c = res.metrics["counters"]
    print(f"[fallback] wall {time.perf_counter() - t0:.3f} s, board_probe_exhausted "
          f"{c.get('board_probe_exhausted')} (JAX package: {JAX_MARKERLESS['board_probe_exhausted']}: it counts "
          f"whole {config.frame_chunk}-frame chunks), keyframes {c['keyframes']}, points {len(res.points)}, "
          f"rmse {res.reprojection_rmse:.4f}")
    if c.get("markerless") is not True:
        raise AssertionError("the fallback did not engage")
    if not c.get("board_probe_exhausted", 0) >= config.board_probe_frames:
        raise AssertionError(f"board hunt stopped early: {c.get('board_probe_exhausted')}")
    if not np.isfinite(res.reprojection_rmse):
        raise AssertionError("fallback rmse is not finite")
    if ransac_cuda.LAUNCHES["refine_relpose"] != 1:
        raise AssertionError(f"the fallback's bootstrap did not launch refine_relpose once: {counts()}")
    check_hyp_launches("fallback", counts(), 1)


def check_clip(res, scene):
    """The repo's bounds on one board clip; returns its volume error."""
    vol_err = (res.volume - scene.volume) / scene.volume
    if not np.isfinite(res.points).all() or res.points.shape[1] != 3 or len(res.points) < 100:
        raise AssertionError("non-finite, misshapen or too small cloud")
    if not (np.isfinite(res.reprojection_rmse) and res.reprojection_rmse <= RMSE_MAX_PX):
        raise AssertionError(f"rmse {res.reprojection_rmse} outside {RMSE_MAX_PX}")
    if not res.volume_confidence["low_confidence"] and not abs(vol_err) <= VOLUME_ERR_MAX:
        raise AssertionError(f"hull volume error {vol_err} outside {VOLUME_ERR_MAX}")
    return vol_err


def run_batch(scene, clips):
    """Phase 7: ``process_batch`` twice, each clip held to the bounds and to
    the batch prepass, each kernel launched once per clip. Returns
    (launches, the first clip's counters)."""
    config = batch_config()
    n_frames = sum(len(c) for c in clips)
    reset_counts()
    rmse = []
    for run, mesh in enumerate((None, sharded.make_mesh())):
        before = dict(clahe_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with recording(sharded, "solve_ba_batch") as solves:
            results = process_batch(clips, config=config, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: clahe_cuda.LAUNCHES[k] - before[k] for k in CLAHE}
        rmse.append(np.array([r.reprojection_rmse for r in results]))
        on = "no mesh" if mesh is None else f"mesh {mesh.shape} over {[str(r[0]) for r in mesh.devices]}"
        print(f"[batch] run {run} ({on}): wall {wall:.3f} s for {len(clips)} clips ({n_frames / wall:.2f} fps "
              f"aggregate), batch solve {results[0].metrics['counters']['batch_solve_s']:.4f} s, launches {launched}")
        for i, res in enumerate(results):
            c = res.metrics["counters"]
            vol_err = check_clip(res, scene)
            print(f"  clip {i}: keyframes {c['keyframes']} points {len(res.points)} rmse {res.reprojection_rmse:.4f} "
                  f"BA iterations {c['ba_iterations']} volume err {vol_err:+.4f} low_confidence "
                  f"{res.volume_confidence['low_confidence']} (JAX package's record |err| {JAX_BATCH_VOLUME_ERR[i]}, "
                  f"accuracy only)")
            if c.get("batch_fast_prepass") is not True:
                raise AssertionError(f"clip {i} did not take the batch prepass")
        if min(launched.values()) < len(clips):
            raise AssertionError(f"a kernel did not launch for every clip of the batch: {launched}")
    # Two runs' BA problems differ by the card's unordered scatter-adds
    # upstream of the solve, and in float32 such rounding can move where
    # an LM lane stops: the mesh run's own problems, solved again with and
    # without the mesh in float64, isolate what the mesh changes.
    mesh, problem = solves[-1][0][:2]
    problem = with_dtype(problem, torch.float64)
    with_mesh = sharded.solve_ba_batch(mesh, problem, config=config.solver)
    without = bundle_adjust.solve_ba_batch(problem, config=config.solver)
    diff = float(((with_mesh.rmse - without.rmse).abs() / without.rmse).max())
    print(f"[batch] per-clip rmse: its BA problems in float64, with the mesh / without: max relative difference "
          f"{diff:.3g}, iterations {with_mesh.iterations.tolist()} / {without.iterations.tolist()}; mesh run / run "
          f"without (whole runs, float32): {float(np.max(np.abs(rmse[1] - rmse[0]) / rmse[0])):.3g}")
    if not (diff <= 1e-4 and torch.equal(with_mesh.iterations, without.iterations)):
        raise AssertionError("the batch solve over a mesh disagrees with the solve without")
    return counts(), results[0].metrics["counters"]


def run_pipelined(scene, clips, corners, err):
    """Phase 8: ``process_batch_pipelined`` on two 300-frame clips, the
    geometry kernels at its calls (``geometry_at_path``), then the same two
    through ``process``. Returns the pipelined run's launches."""
    config = headline_config()
    reset_counts()
    t0 = time.perf_counter()
    with geometry_recorded(BOARD_BA) as (calib_calls, pnp_calls, ba_first, calls):
        piped = process_batch_pipelined(clips, config=config, known_corners=corners)
        torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = counts()
    check_geometry("pipelined", launches, calls, board=True)
    geometry_at_path("pipelined", calib_calls, pnp_calls, ba_first, BOARD_BA, err)
    del calib_calls, pnp_calls, ba_first
    t0 = time.perf_counter()
    seq = [process(v, config=config, known_corners=c, device="cuda") for v, c in zip(clips, corners)]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    n_frames = sum(len(c) for c in clips)
    print(f"[pipelined] pipelined {t_pipe:.3f} s ({n_frames / t_pipe:.2f} fps), one after the other {t_seq:.3f} s "
          f"({n_frames / t_seq:.2f} fps), launches {launches}")
    for i, (p, q) in enumerate(zip(piped, seq)):
        vol_err = check_clip(p, scene)
        print(f"  clip {i}: keyframes {p.metrics['counters']['keyframes']} points {len(p.points)} rmse "
              f"{p.reprojection_rmse:.4f} (one after the other {q.reprojection_rmse:.4f}) volume err {vol_err:+.4f}")
    if min(launches[k] for k in CLAHE) <= 0:
        raise AssertionError(f"a kernel of the pipelined path never launched: {launches}")
    return launches


def run_odometry(scene, frames, poses):
    """Phase 9a: ``chain_poses`` over the board-free clip, one ``lk_track``
    and one ``refine_relpose`` launch per step. Returns (its launches,
    its result)."""
    reset_counts()
    t0 = time.perf_counter()
    res = chain_poses(frames, scene.intrinsics, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    acc = odometry_accuracy(res, poses)
    print(f"[odometry] wall {wall:.3f} s ({wall / len(frames):.4f} s per frame), launches {launches}")
    print(f"  tracked per step min {acc['min_tracked']}, inliers per step min {int(res.num_inliers[1:].min())}; "
          f"rotation error over the first 10 steps max {acc['rot_err_first_deg']:.4f} deg (bound "
          f"{ODOMETRY_ROT_ERR_MAX_DEG}); over the clip max {acc['rot_err_max_deg']:.4f} deg, drift at the last "
          f"frame {acc['drift_deg']:.4f} deg of a {acc['orbit_deg']:.2f}-deg orbit")
    if acc["min_tracked"] <= 50:
        raise AssertionError(f"odometry tracked too few points: {res.num_tracked}")
    if not acc["rot_err_first_deg"] < ODOMETRY_ROT_ERR_MAX_DEG:
        raise AssertionError(f"odometry rotation error {acc['rot_err_first_deg']} deg over the first 10 steps")
    if min(launches[k] for k in CLAHE) < len(frames):
        raise AssertionError(f"a kernel did not launch for every frame of the odometry: {launches}")
    if launches["lk_track"] != len(frames) - 1:
        raise AssertionError(f"lk_track did not launch once per odometry step: {launches}")
    if launches["refine_relpose"] != len(frames) - 1:
        raise AssertionError(f"refine_relpose did not launch once per odometry step: {launches}")
    check_hyp_launches("odometry", launches, len(frames) - 1)
    return launches, res


def odometry_plain(scene, frames, res):
    """Phase 9a': the first steps of the odometry once more with the plain
    refinement on the card; prints each step's rotation difference (deg)
    against the kernel run. The draws are the same (one seeded generator
    per run), so only the refinement's rounding differs."""
    before = (ransac_cuda.LAUNCHES["refine_relpose"], dict(ransac_hyp_cuda.LAUNCHES))
    t0 = time.perf_counter()
    with plain_relpose():
        plain = chain_poses(frames[: ODOMETRY_PLAIN_STEPS + 1], scene.intrinsics, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (ransac_cuda.LAUNCHES["refine_relpose"], ransac_hyp_cuda.LAUNCHES) != before:
        raise AssertionError("the plain run launched a relative-pose kernel")

    def rot(poses):
        return so3.exp(torch.from_numpy(np.asarray(poses, np.float64)[:, :3]))

    r_k, r_p = rot(res.poses[: ODOMETRY_PLAIN_STEPS + 1]), rot(plain.poses)
    cos = (torch.einsum("tij,tij->t", r_k, r_p) - 1.0) / 2.0
    diff = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))[1:]
    print(f"[odometry] first {ODOMETRY_PLAIN_STEPS} steps with the plain relative pose on the card: {wall:.3f} s; "
          f"rotation difference against the kernel run per step (deg) {[round(float(d), 6) for d in diff]}, max "
          f"{float(diff.max()):.6f}; inliers per step kernel {res.num_inliers[1:ODOMETRY_PLAIN_STEPS + 1].tolist()} "
          f"plain {plain.num_inliers[1:].tolist()}")


def run_two_view(scene, frames):
    """Phase 9b: ``two_view.reconstruct_two_view`` on two frames of the
    board-free clip (launch counts reset just before): one ``lk_track``
    launch polishes its matches. Returns its launches."""
    reset_counts()
    t0 = time.perf_counter()
    res = reconstruct_two_view(frames[0], frames[4], scene.intrinsics, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    n_in = int(res.num_inliers)
    print(f"[two_view] frames 0 and 4: {wall:.3f} s, {n_in} inliers of {len(res.pts1)} matches, launches {launches}")
    if n_in < 50 or not torch.isfinite(res.points[res.inliers]).all():
        raise AssertionError(f"two-view reconstruction failed: {n_in} inliers")
    if launches["lk_track"] != 1:
        raise AssertionError(f"lk_track did not launch once in reconstruct_two_view: {launches}")
    if launches["refine_relpose"] != 1:
        raise AssertionError(f"refine_relpose did not launch once in reconstruct_two_view: {launches}")
    check_hyp_launches("two-view", launches, 1)
    return launches


def run_cli(clips):
    """Phase 9c: the command line as a subprocess, on one batch clip saved
    as ``.npy`` and then on two with ``--schedule mesh``."""
    paths = []
    for i, clip in enumerate(clips[:2]):
        paths.append(str(OUT / f"cli_clip{i}.npy"))
        np.save(paths[-1], clip)
    # 0.05 of the width is the headline config's keyframe budget (threshold_abs 96 at 1920 px).
    flags = ["-o", str(OUT / "cli"), "--detector", "device", "--keyframe-threshold", "0.05", "--json"]
    for label, args, n in (("one clip", paths[:1], 1), ("two clips, --schedule mesh", [*paths, "--schedule", "mesh"], 2)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "meatmodeler_tpu_torch.cli", *args, *flags],
            capture_output=True, text=True, cwd=REPO, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"the command line exited {proc.returncode} on {label}:\n{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        payloads = out if isinstance(out, list) else [out]
        print(f"[cli] {label}: exit 0 in {time.perf_counter() - t0:.2f} s; "
              + "; ".join(f"keyframes {p['keyframes']} points {p['points']} rmse {p['reprojection_rmse']:.4f}"
                          for p in payloads))
        if len(payloads) != n or any(set(p) != CLI_PAYLOAD_KEYS for p in payloads):
            raise AssertionError(f"unexpected command-line payload on {label}: {[sorted(p) for p in payloads]}")
    for p in paths:
        Path(p).unlink()


def check_tp_matching(devices, pair):
    """(c): ``match_descriptors_tp`` over ``model`` against the one-device
    matcher without cross-check: the same good mask and indices."""
    q, t, qm, tm = pair
    m = 1 << (min(len(devices), t.shape[0]).bit_length() - 1)  # a power of two divides the 4096 train rows
    mesh = sharded.make_mesh(data=1, model=m, devices=devices[:m])
    t0 = time.perf_counter()
    idx, _, good = sharded.match_descriptors_tp(mesh, q, t, qm, tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = matching.match_descriptors(q, t, qm, tm, cross_check=False, max_matches=q.shape[0])
    ref_idx = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    ref_good = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    ref_idx[ref.query_idx[ref.mask]] = ref.train_idx[ref.mask]
    ref_good[ref.query_idx[ref.mask]] = True
    good = good.to(q.device)
    same = torch.equal(good, ref_good) and torch.equal(idx.to(q.device)[good], ref_idx[good])
    print(f"[mesh] match_descriptors_tp over {m} ({mesh.devices[0][0]}...): {tuple(q.shape)} x {tuple(t.shape)}, "
          f"{int(good.sum())} good, {wall * 1e3:.3f} ms; same as one device: {same}")
    if not same:
        raise AssertionError("match_descriptors_tp disagrees with match_descriptors")


def check_preprocess(devices, frames):
    """(d): ``preprocess_sharded`` over ``data`` against ``enhanced_grey`` on
    one device; returns the launches of the sharded run."""
    mesh = sharded.make_mesh(data=len(devices), devices=devices)
    frames = frames[: len(frames) - len(frames) % len(devices)]
    reset_counts()
    t0 = time.perf_counter()
    out = sharded.preprocess_sharded(mesh, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    err = float((out - clahe_mod.enhanced_grey(frames.to(out.device))).abs().max())
    print(f"[mesh] preprocess_sharded over {len(devices)} ({devices[0]}...): {tuple(frames.shape)} in {wall:.4f} s, "
          f"max|d| against one device {err:.3g}, launches {launches}")
    if not err <= 1e-3:
        raise AssertionError(f"preprocess_sharded disagrees with enhanced_grey: {err}")
    if min(launches[k] for k in CLAHE) < len(devices):
        raise AssertionError(f"a kernel did not launch on every shard of preprocess_sharded: {launches}")
    return launches


def check_band(problem):
    """(e): ``adjust_points`` with a budget half the problem's bucket-padded
    strip: it raises on one GPU, and on several shards over two of them and
    matches the unsharded solve (rmse rtol 1e-4, points atol 5e-3: the JAX
    package's bounds for a banded ``adjust_points``), in float64 (see
    ``point_sharded_check``)."""
    problem = with_dtype(problem, torch.float64)
    n_f, n_p = problem.cam_params.shape[0], problem.points.shape[0]
    cfg = SolverConfig()
    strip = 2 * bundle_adjust._ceil_to(n_p, cfg.bucket[1]) * bundle_adjust._ceil_to(n_f, cfg.bucket[0]) * 18 * 8
    args = (projection.extrinsics_from_params(problem.cam_params), problem.intrinsics, problem.points, problem.obs,
            problem.frame_idx, problem.point_idx)
    banded = SolverConfig(hbm_strip_budget_bytes=strip // 2 + 1)
    if torch.cuda.device_count() == 1:
        try:
            bundle_adjust.adjust_points(*args, weights=problem.weight, config=banded)
        except ValueError as e:
            if "memory band" not in str(e):
                raise
            print(f"[mesh] band at {strip // 2 + 1} B (strip {strip} B), one GPU: refused: {e}")
            return
        raise AssertionError("the memory band did not refuse a problem that needs two GPUs on one")
    pts_b, _, res_b = bundle_adjust.adjust_points(*args, weights=problem.weight, config=banded)
    pts_1, _, res_1 = bundle_adjust.adjust_points(*args, weights=problem.weight)
    d_pts = float((pts_b - pts_1).abs().max())
    print(f"[mesh] band at {strip // 2 + 1} B (strip {strip} B) over {torch.cuda.device_count()} GPUs: rmse "
          f"{float(res_b.rmse):.6f} against {float(res_1.rmse):.6f} unsharded, points max|d| {d_pts:.3g}")
    if not (abs(float(res_b.rmse) - float(res_1.rmse)) <= 1e-4 * float(res_1.rmse) and d_pts <= 5e-3):
        raise AssertionError("the banded adjust_points disagrees with the unsharded one")


def run_mesh(dev, problem, pair, frames, err, timings):
    """Phase 10. Returns the launches of its ``preprocess_sharded`` runs."""
    n_gpus = torch.cuda.device_count()
    print(f"[mesh] {n_gpus} visible GPU(s)")
    synthetic = synthetic_ba_problem(dev, **SHARDED_PROBLEM)
    meshes = [["cuda:0"] * 4] + ([[f"cuda:{i}" for i in range(n_gpus)]] if n_gpus > 1 else [])
    launches = {k: 0 for k in KERNELS}
    for devices in meshes:
        devices = [torch.device(d) for d in devices]
        for name, pr in (("known-path BA problem", problem), ("JAX sharding-test problem", synthetic)):
            with first_calls_within(OBS_JACOBIANS, *SHARDED_BA) as ba_first:
                out = point_sharded_check(pr, devices)
            print(f"[mesh] solve_ba_point_sharded, {name} ({out['frames']} frames, {out['points']} points, "
                  f"{out['observations']} observations) over {out['devices']}: {out['sharded_s']:.4f} s against "
                  f"{out['unsharded_s']:.4f} s unsharded (float32)")
            for label, key in (("float32, sharded / unsharded", "float32"),
                               ("float32, unsharded / itself with its observations permuted", "float32_unsharded_permuted"),
                               ("float64, sharded / unsharded", "float64")):
                c = out[key]
                print(f"  {label}: iterations {c['iterations']}, rmse {c['rmse']}, cameras max|d| "
                      f"{c['cam_max_abs_diff']:.3g}, points max|d| {c['points_max_abs_diff']:.3g}")
            compare_first_jacobians(f"mesh over {len(devices)} shards, {name}:", SHARDED_BA, ba_first, err)
        check_tp_matching(devices, pair)
        for k, v in check_preprocess(devices, frames).items():
            launches[k] += v
    # One shard's CLAHE input: the LAB lightness of 8 frames at full size.
    shard = color.bgr_to_lab(frames[: len(frames) // 4].to(dev))[..., 0].contiguous()
    compare_kernels(dev, [("preprocess_sharded shard", shard, (8, 8))], err)
    time_at("preprocess_sharded shard", shard, timings)
    check_band(problem)
    if n_gpus > 1:
        compare_kernels(torch.device("cuda:1"), [(f"on cuda:1 {label}", img.to("cuda:1"), tiles)
                                                for label, img, tiles in seeded_cases(dev)[:2]], err)
    return launches


def run_volume_tools():
    """Phase 11: the volume tools. ``ideal_visual_hull`` at its defaults
    must give its docstring's record (truth 22.619, hull 36.360); then
    ``volume_validation`` captures its ``e2e_400`` scene through
    ``process`` on the card into a fresh directory (launch counts reset
    just before, read just after: the video-alone path's kernels) and
    evaluates the shipped variant (gated, trim 5, trim_ref 1500, inflate
    0) on the capture: finite, and its hull within 1e-4 relative of the
    hull the captured run computed (the same function on the same inputs).
    Returns the launches."""
    t0 = time.perf_counter()
    scene = TurntableScene(image_size=(1920, 1080), focal=1500.0, arc_degrees=50.0)
    hull_ideal = ideal_visual_hull.ideal_visual_hull(scene, 20, 96)
    print(f"[volume] ideal_visual_hull: truth {scene.volume:.3f}, hull {hull_ideal:.3f}, ratio "
          f"{hull_ideal / scene.volume:.3f} ({time.perf_counter() - t0:.2f} s)")
    if (round(scene.volume, 3), round(hull_ideal, 3)) != (22.619, 36.360):
        raise AssertionError("ideal_visual_hull does not give its decision record")
    vscene, n_frames, vconfig = volume_validation.validation_scenes()["e2e_400"]
    reset_counts()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp, geometry_counts() as calls:
        t0 = time.perf_counter()
        cap = volume_validation.capture_scene("e2e_400", vscene, n_frames, vconfig, "cuda", Path(tmp))
        wall = time.perf_counter() - t0
        if not (Path(tmp) / "volval_torch_e2e_400.npz").exists():
            raise AssertionError("volume_validation wrote no capture")
    launches = counts()
    check_geometry("volume", launches, calls, board=True)
    if min(launches[k] for k in (*CLAHE, "lk_track")) <= 0:
        raise AssertionError(f"a kernel of the volume path never launched: {launches}")
    hull, carve = volume_validation.eval_variant(cap, volume_validation.cfg_of(cap), "gated", 5, trim_ref=1500)
    run_hull, truth = float(cap["run_hull"]), float(cap["truth"])
    rel = abs(hull - run_hull) / abs(run_hull)
    print(f"[volume] e2e_400 captured on the card in {wall:.2f} s ({int(cap['n_kf'])} keyframes, "
          f"{len(cap['pts'])} points), launches {launches}; shipped variant hull {hull:.4f} carve {carve:.4f} "
          f"(the run's hull {run_hull:.4f}, |d| {rel:.3g} relative), truth {truth:.4f}, error "
          f"{hull / truth - 1.0:+.4f}")
    if not (np.isfinite(hull) and np.isfinite(carve) and rel <= 1e-4):
        raise AssertionError("the volume harness disagrees with the captured run's hull")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = _gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    for lib in LIBRARIES:
        lib.LIBRARY.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda lib: lib.build(), LIBRARIES))
    print(f"built {', '.join(str(lib.LIBRARY) for lib in LIBRARIES)} in {time.perf_counter() - t0:.2f} s")

    err = {name: 0.0 for name in KERNELS}
    compare_kernels(dev, seeded_cases(dev), err)
    # Phase 3b: the Lucas-Kanade kernel against its plain version on seeded inputs.
    compare_lk([(c, lk_case(c, dev)) for c in LK_CASES], err)
    # Phase 3c: the refinement kernel against its plain version on seeded scenes.
    compare_relpose([(c[0], to_device(caller_case(c[0]), dev)) for c in RELPOSE_CALLERS]
                    + [(c, to_device(relpose_case(c), dev)) for c in (*RELPOSE_EDGES, *RELPOSE_PADDED, RELPOSE_WIDE)],
                    err)
    # Phase 3d: the board geometry's kernels against their plain versions.
    compare_geometry_seeded(dev, err)
    # Phase 3e: the relative pose's hypothesis, cheirality and scoring
    # kernels against their plain versions at the paths' shapes and edges.
    compare_hyp([(label, hyp_case(label, device=dev)) for label in (*(c[0] for c in HYP_CALLERS), *HYP_EDGES)], err,
                seeded=True)

    t0 = time.perf_counter()
    scene, frames, corners = headline_clip(dev)
    torch.cuda.synchronize()
    print(f"rendered {frames.shape} in {time.perf_counter() - t0:.2f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    config = headline_config()
    timings, lk_timings, relpose_timings, geometry_timings, hyp_timings = {}, {}, {}, {}, {}

    # Phase 4: known corners, host pass 1, grey enhance; its BA problem and
    # keyframe descriptors are recorded for phase 10.
    with recording(bundle_adjust, "solve_ba") as solves, recording(matching, "match_descriptors") as matches:
        launches, c, _ = run_path("known", scene, frames, corners, config, err, geometry_timings)
    # The path with the geometry's plain versions.
    run_plain_geometry("known", scene, frames, corners, config, c)
    ba_problem = [args[0] for args, kwargs in solves if not kwargs.get("fix_points")][-1]
    q, t, qm, tm = matches[-1][0][:4]
    kf_pair = (q[0], t[0], qm[0], tm[0])
    del solves, matches
    # Its CLAHE input: every keyframe, grey at half resolution.
    p2s = config.pass2_downscale
    keyframes = np.ascontiguousarray(frames[c["keyframe_indices"]])
    grey = torch.from_numpy(native_ops.bgr_to_grey_down(keyframes, p2s)).to(dev).float()
    compare_kernels(dev, [("known-path keyframes", grey, (8, 8))], err)
    time_at("known-path keyframes", grey, timings)

    # Phase 5: the board-finding default path, video alone; its scan's
    # Lucas-Kanade calls are recorded to compare and time the kernel at the
    # first between two frames.
    dconfig = detector_config(config)
    with recording(klt, "lucas_kanade") as calls:
        launches_d, c, flags = run_path("detector", scene, frames, None, dconfig, err)
    # The scan's first call tracks its start frame against itself.
    scan_lk = next(case for case in map(lk_call_case, calls) if not torch.equal(case[0][0], case[1][0]))
    del calls
    add_counts(launches, launches_d)
    run_plain_geometry("detector", scene, frames, None, dconfig, c)
    check_scan_plain(frames, dconfig, flags, c["keyframe_indices"])
    compare_lk([("headline scan input", scan_lk)], err)
    time_lk_at("headline scan input", scan_lk, lk_timings)
    del scan_lk
    # Its two CLAHE inputs, rebuilt from the clip as the path builds them.
    p1s, p2s = dconfig.pass1_downscale, dconfig.pass2_downscale
    chunk = torch.from_numpy(native_ops.bgr_to_grey_down(frames[: dconfig.frame_chunk], p1s)).to(dev).float()
    keyframes = np.ascontiguousarray(frames[c["keyframe_indices"]][:, ::p2s, ::p2s])
    lab_l = color.bgr_to_lab(torch.from_numpy(keyframes).to(dev))[..., 0].contiguous()
    compare_kernels(dev, [("pass-1 chunk", chunk, (8, 8)), ("pass-2 LAB L", lab_l, (8, 8))], err)
    time_at("pass-1 chunk", chunk, timings)
    time_at("pass-2 LAB L", lab_l, timings)
    del chunk, lab_l, keyframes, grey

    # Phase 6: the marker-free path, and the automatic fallback.
    t0 = time.perf_counter()
    mscene, mframes, mposes = markerless_clip(dev)
    print(f"rendered {mframes.shape} in {time.perf_counter() - t0:.2f} s")
    with recording(ransac, "refine_relative_pose") as calls, first_hyp_calls() as hyp_first:
        launches_m, c = run_markerless(mscene, mframes, mposes, err)
    add_counts(launches, launches_m)
    # The first run's bootstrap: its essential and homography candidates in one call.
    bootstrap = relpose_call_case(calls[0])
    del calls
    compare_relpose([("bootstrap", bootstrap)], err)
    time_relpose_at("bootstrap", bootstrap, relpose_timings)
    compare_hyp([("bootstrap", hyp_first)], err)
    time_hyp_at("bootstrap", hyp_first, hyp_timings)
    del bootstrap, hyp_first
    mconfig = markerless_config()
    p2s = mconfig.pass2_downscale
    kf_grey = np.ascontiguousarray(mframes[c["keyframe_indices"]])
    kf_grey = torch.from_numpy(native_ops.bgr_to_grey_down(np.repeat(kf_grey[..., None], 3, axis=-1), p2s)).to(dev).float()
    compare_kernels(dev, [("marker-free keyframes", kf_grey, (8, 8))], err)
    time_at("marker-free keyframes", kf_grey, timings)
    reset_counts()
    with first_calls_within(OBS_JACOBIANS, *CHAIN_BA) as ba_first, geometry_counts() as geometry_calls, \
            recording(klt, "lucas_kanade") as calls, recording(ransac, "refine_relative_pose") as refines, \
            first_hyp_calls() as hyp_first:
        run_fallback(mframes)
    launches_f = counts()
    # Its scan's first call between two frames, and its bootstrap's relative pose.
    fallback_lk = next(case for case in map(lk_call_case, calls) if not torch.equal(case[0][0], case[1][0]))
    compare_lk([("fallback scan input", fallback_lk)], err)
    compare_relpose([("fallback bootstrap", relpose_call_case(refines[0]))], err)
    compare_hyp([("fallback bootstrap", hyp_first)], err)
    del calls, refines, fallback_lk, hyp_first
    check_geometry("fallback", launches_f, geometry_calls, board=False)
    if min(launches_f[k] for k in KERNELS if k not in ("pnp_refine", "calib_lm")) <= 0:
        raise AssertionError(f"a kernel of the fallback path never launched: {launches_f}")
    add_counts(launches, launches_f)
    compare_first_jacobians("fallback", CHAIN_BA, ba_first, err)
    del ba_first

    # Phase 7: the multi-video batch.
    t0 = time.perf_counter()
    bscene, bclips = batch_clips(dev)
    print(f"rendered {len(bclips)} x {bclips[0].shape} in {time.perf_counter() - t0:.2f} s")
    with geometry_recorded(BATCH_BA) as (calib_calls, pnp_calls, ba_first, geometry_calls):
        launches_b, c = run_batch(bscene, bclips)
    check_geometry("batch", launches_b, geometry_calls, board=True)
    add_counts(launches, launches_b)
    geometry_at_path("batch", calib_calls, pnp_calls, ba_first, BATCH_BA, err)
    del calib_calls, pnp_calls, ba_first
    batch_kf = torch.from_numpy(
        native_ops.bgr_to_grey_down(np.ascontiguousarray(bclips[0][c["keyframe_indices"]]), c["kf_scale"])
    ).to(dev).float()

    # Phase 8: the pipelined schedule on the headline clip and a seed-7 render.
    _, frames7, corners7 = headline_clip(dev, seed=PP_SEED)
    launches_p = run_pipelined(scene, [frames, frames7], [corners, corners7], err)
    add_counts(launches, launches_p)
    frames32 = torch.from_numpy(np.ascontiguousarray(frames[:32]))
    del frames, frames7

    # Phase 9: odometry over the board-free clip, two-view, the kernels, the CLI.
    with recording(klt, "lucas_kanade") as calls, recording(ransac, "refine_relative_pose") as refines, \
            geometry_counts() as geometry_calls, first_hyp_calls() as odometry_hyp, \
            recording(ransac, "estimate_relative_pose") as estimates:
        launches_o, odo = run_odometry(mscene, mframes, mposes)
    check_geometry("odometry", launches_o, geometry_calls, board=False, chain=False)
    add_counts(launches, launches_o)
    odometry_lk, odometry_refine = lk_call_case(calls[0]), relpose_call_case(refines[0])
    odometry_estimate = estimates[0]
    del refines, estimates
    odometry_plain(mscene, mframes, odo)
    with recording(klt, "lucas_kanade") as calls, recording(ransac, "refine_relative_pose") as refines, \
            geometry_counts() as geometry_calls, first_hyp_calls() as two_view_hyp:
        launches_t = run_two_view(mscene, mframes)
    check_geometry("two-view", launches_t, geometry_calls, board=False, chain=False)
    add_counts(launches, launches_t)
    lk_cases = [("odometry step 1", odometry_lk), ("two-view matches", lk_call_case(calls[0]))]
    two_view_refine = relpose_call_case(refines[0])
    del calls, refines
    compare_hyp([("odometry step 1", odometry_hyp), ("two-view", two_view_hyp)], err)
    time_hyp_at("odometry step 1", odometry_hyp, hyp_timings)
    time_hyp_at("two-view", two_view_hyp, hyp_timings)
    count_estimate_syncs(odometry_estimate)
    del odometry_hyp, two_view_hyp, odometry_estimate
    compare_lk(lk_cases, err)
    for label, case in lk_cases:
        time_lk_at(label, case, lk_timings)
    compare_relpose([("odometry step 1", odometry_refine), ("two-view", two_view_refine)], err)
    time_relpose_at("odometry step 1", odometry_refine, relpose_timings)
    time_relpose_at("two-view", two_view_refine, relpose_timings)
    del odometry_refine, two_view_refine
    frame = torch.from_numpy(np.ascontiguousarray(mframes[:1])).to(dev).float()
    compare_kernels(dev, [("odometry frame", frame, (8, 8)), ("batch-clip keyframes", batch_kf, (8, 8))], err)
    time_at("odometry frame", frame, timings)
    time_at("batch-clip keyframes", batch_kf, timings)
    run_cli(bclips)
    del bclips

    # Phase 10: the mesh.
    launches_s = run_mesh(dev, ba_problem, kf_pair, frames32, err, timings)
    add_counts(launches, launches_s)
    # Phase 11: the volume tools.
    add_counts(launches, run_volume_tools())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "meatmodeler_tpu", "bench"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package or its bench: {loaded}")

    main = timings["known-path keyframes"]
    rows = {name: dict(main[name], bound_by="bytes", at=main["shape"]) for name in CLAHE}
    lk_main = lk_timings["headline scan input"]
    rows["lk_track"] = dict(lk_main, at=[*lk_main["shape"], lk_main["points"]])
    rp_main = relpose_timings["odometry step 1"]
    rows["refine_relpose"] = dict(rp_main, at=[rp_main["candidates"], rp_main["points"]])
    geo = geometry_timings["known path"]
    rows["obs_jacobians"] = dict(geo["obs_jacobians"], at=[geo["obs_jacobians"][k] for k in ("cameras", "points",
                                                                                              "observations")])
    rows["pnp_refine"] = dict(geo["pnp_refine"], at=[geo["pnp_refine"][k] for k in ("twins", "frames", "points")])
    rows["calib_lm"] = dict(geo["calib_lm"], at=[geo["calib_lm"][k] for k in ("views", "points", "n_intr",
                                                                              "iterations")])
    # The relative pose's kernels at the odometry's first step; the
    # homography kernel's two launches (hypotheses, then polish) summed.
    hyp = hyp_timings["odometry step 1"]
    for name in ("essential_hypotheses", "recover_pose", "score_candidates"):
        rows[name] = dict(hyp[name], at=[hyp[name]["items"], hyp[name]["points"]])
    both = (hyp["homography_hypotheses"], hyp["homography_polish"])
    rows["homography_hypotheses"] = {key: sum(r[key] for r in both) for key in ("ms", "plain_ms", "bound_ms")}
    rows["homography_hypotheses"].update(bound_by=both[0]["bound_by"], at=[both[0]["items"], both[0]["points"]],
                                         share=rows["homography_hypotheses"]["bound_ms"] / rows["homography_hypotheses"]["ms"])
    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][1],
                "replaces": KERNELS[name][0],
                "launches": launches[name],
                "max_abs_err": err[name],
                "ms": rows[name]["ms"],
                "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"],
                "bound_by": rows[name]["bound_by"],
                "share": rows[name]["share"],
                # No single PyTorch call computes a tile-LUT CLAHE, pyramidal
                # LK, a robust LM refinement, projection Jacobians, a
                # Gauss-Newton PnP, an LM calibration, batched 8-point or
                # 4-point RANSAC hypotheses with their consensus, a
                # cheirality vote or a triangulated-reprojection score.
                "library_ms": None,
                "at": rows[name]["at"],
            }
            for name in KERNELS
        ]
    }
    print(f"gpu: {gpu}")
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
