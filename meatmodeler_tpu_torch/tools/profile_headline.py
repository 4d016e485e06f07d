"""Time and profile the port's headline runs on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.profile_headline [--warm-runs 10] [--out FILE]
        [--paths known,detector,markerless,batch,pipelined,odometry,sharded]

It renders the headline clip on the card (300 frames, 1920x1080, seed 0,
with its ground-truth board corners) and profiles two paths through
``process``:

  known: ``headline_config()`` (host C++ pass 1, grey pass-2 enhance)
    with the renderer's board corners as ``known_corners``;
  detector: the board-finding default path, ``detector_config`` of the
    same config (device pass 1, ``bgr_lab`` enhance, the device chessboard
    detector) with no ``known_corners``;

and then the board-free clip (``markerless_clip``: 120 grey frames,
1280x720, seed 1) through a third:

  markerless: ``markerless_config()`` (``assume_markerless``, the host pass
    1 at /4, the pose chain instead of the board geometry); its accuracy
    comes from ``markerless_accuracy`` against the renderer's poses, and its
    host syncs are counted (``count_host_syncs``).

Each path runs four ways:

  1. cold: the first ``process`` of the process (the kernel libraries are
     built first if they are missing);
  2. warm, ``--warm-runs`` times: e2e seconds (median and quartiles), fps,
     and each hand-written kernel's launches per run (CLAHE, LK, the
     relative-pose refinement, the BA Jacobians, the PnP refinement and the
     calibration LM);
  3. once with ``MEATMODELER_SYNC_STAGES=1``: per-stage seconds that bill
     device work to the stage that queued it, and the peak allocation;
  4. once under ``torch.profiler``: device busy time (the union of kernel,
     copy and memset intervals), kernel launches, and the busy share of that
     run's wall time (the profiler slows the host, so the share is a floor).

The multi-video entry points and the odometry run the same four ways
(``profile_entry``; their stage seconds are summed over the videos):

  batch: ``parallel.batch.process_batch`` on the JAX package's batch row
    (``batch_clips``: 8 clips of 60 frames, 1920x1080, seeds 100-107) with
    ``batch_config()``, no corners;
  pipelined: ``parallel.pipelined.process_batch_pipelined`` on two
    300-frame clips (the headline clip and a seed-7 render, ``pp_clips``)
    with ``headline_config()`` and their corners, each warm run followed by
    the same two through ``process`` one after the other;
  odometry: ``odometry.chain_poses`` over the board-free clip with the
    scene's K; its accuracy is the chained rotations' error against the
    renderer's orbit (``odometry_accuracy``), and its synced run times the
    calls of each step (``ODOMETRY_STAGES``); its profiled run, and a count
    of its host syncs, take the first 20 steps.

  sharded: the known path's BA problem (recorded from one run) through
    ``parallel.sharded.solve_ba_point_sharded`` on four virtual shards of
    ``cuda:0`` (and over every GPU where there are several) against the
    unsharded ``solve_ba``, checked, then timed in turns (``profile_sharded``).

One summary line per phase goes to stdout; everything goes as JSON to
``--out`` (default ``build/profile_headline.json``), one entry per path.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from meatmodeler_tpu_torch.config import (
    DEFAULT_CONFIG,
    KeyframeConfig,
    MatcherConfig,
    OrbConfig,
    PipelineConfig,
    SolverConfig,
    TrackConfig,
    VolumeConfig,
)
from meatmodeler_tpu_torch.geometry import calibration_cuda, pnp_cuda, projection, ransac, ransac_cuda, so3, triangulation
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch import odometry as odometry_module
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.ops import clahe, clahe_cuda, features, klt, klt_cuda
from meatmodeler_tpu_torch.parallel import sharded
from meatmodeler_tpu_torch.parallel.batch import process_batch
from meatmodeler_tpu_torch.parallel.pipelined import process_batch_pipelined
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.solvers import bundle_adjust, bundle_adjust_cuda
from meatmodeler_tpu_torch.utils.alignment import umeyama

REPO = Path(__file__).resolve().parents[2]
HEADLINE_FRAMES = 300
MARKERLESS_FRAMES = 120
# The JAX package's batch row (bench.py:819-837).
BATCH_FRAMES = 60
BATCH_SEEDS = tuple(range(100, 108))
# The second clip of its pipelined row (bench.py:1019-1026).
PP_SEED = 7


def headline_scene() -> TurntableScene:
    """The headline scene: the JAX package's ``bench.py`` scene."""
    return TurntableScene(image_size=(1920, 1080), focal=1500.0, noise_sigma=1.5)


def headline_clip(device, seed=0):
    """The headline scene and its 300-frame clip rendered on ``device``."""
    scene = headline_scene()
    frames, _, corners = render_sequence(scene, HEADLINE_FRAMES, seed=seed, backend="torch", device=device)
    return scene, frames, corners


def batch_clips(device):
    """The JAX package's batch row: 8 clips of 60 frames of the headline
    scene, seeds 100-107, rendered on ``device`` (numpy uint8 BGR, about
    3.0 GB in all). Returns (scene, clips)."""
    scene = headline_scene()
    clips = [render_sequence(scene, BATCH_FRAMES, seed=s, backend="torch", device=device)[0] for s in BATCH_SEEDS]
    return scene, clips


def batch_config() -> PipelineConfig:
    """``headline_config()`` with the device chessboard detector: the
    JAX package's batch row ran the default "auto" detector, which falls
    back to cv2 on a miss; this package has no cv2, so a video without
    corners needs the device detector."""
    config = headline_config()
    return dataclasses.replace(config, chessboard=dataclasses.replace(config.chessboard, detector="device"))


def headline_config() -> PipelineConfig:
    """The headline configuration: field for field the value of the JAX
    package's ``bench.bench_config()`` (``bench.py:118-198``, where each
    knob's measurement is noted), in this package's config classes.

    Denser keyframes than the reference's 0.1 rule (the resolution-invariant
    ``threshold_abs=96``, window 15, the displacement trigger 0.015); 4096
    ORB features on 4 levels; 2048 matches per pair; 8192 tracks over at
    most 64 keyframes, n-view triangulation, a 3 px track gate; a 64^3
    carve with closing 0.015 and 0.9 view agreement; the host C++ pass 1 at
    1/6 resolution; half-resolution grey keyframes."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(KeyframeConfig(), threshold_abs=96.0, window=15, flow_threshold=0.015),
        orb=OrbConfig(num_features=4096, num_levels=4),
        matcher=MatcherConfig(max_matches=2048),
        volume=dataclasses.replace(VolumeConfig(), carve_close_frac=0.015, carve_vote_frac=0.9, voxel_resolution=64),
        tracks=TrackConfig(max_tracks=8192, max_keyframes=64, triangulation="nview", max_reproj_px=3.0),
        frame_chunk=32,
        pass1_backend="host",
        pass1_downscale=6,
        pass2_downscale=2,
        pass2_enhance="grey",
    )


def markerless_clip(device):
    """The JAX package's marker-free bench scene (``bench.markerless_scene``:
    1280x720, focal 1000, noise 1.0, no board, a textured ground sheet) and
    its 120-frame clip, seed 1, rendered grey on ``device``. Returns (scene,
    frames (T, H, W) uint8, ground-truth poses (T, 6))."""
    scene = TurntableScene(
        image_size=(1280, 720), focal=1000.0, noise_sigma=1.0, show_board=False, ground_texture=12.0
    )
    frames, poses, _ = render_sequence(scene, MARKERLESS_FRAMES, seed=1, color=False, backend="torch", device=device)
    return scene, frames, poses


def markerless_config() -> PipelineConfig:
    """``headline_config()`` as the JAX package's marker-free bench variant
    sets it (``bench.py:678-696``): pass 1 at /4 for 720p, no displacement
    trigger (the chain needs per-pair baseline), ``assume_markerless`` with
    the assumed focal prior (``markerless_focal=0``)."""
    config = headline_config()
    return dataclasses.replace(
        config,
        pass1_downscale=4,
        keyframe=dataclasses.replace(config.keyframe, flow_threshold=0.0),
        assume_markerless=True,
        markerless_focal=0.0,
    )


def _pose_anchors(rot: np.ndarray, tvec: np.ndarray, d: float) -> np.ndarray:
    """Three alignment anchors per camera: center, +forward*d, +down*d."""
    c = -rot.T @ tvec
    return np.stack([c, c + rot.T @ np.array([0.0, 0.0, 1.0]) * d, c + rot.T @ np.array([0.0, 1.0, 0.0]) * d])


def markerless_accuracy(res, gt_poses, scene) -> dict:
    """The JAX package's marker-free accuracy (``bench.py:726-753``): the
    keyframe poses' anchors Umeyama-aligned to the renderer's, their RMSE
    absolute and relative to the camera-ring radius, and the median and p90
    distance of the aligned points to the nearest true surface (ellipsoid or
    ground plane), in units of the ellipsoid's semi-axes."""
    kf_idx = res.metrics["counters"]["keyframe_indices"]
    ext = res.extrinsics
    d = scene.ring_radius / 3.0
    src = np.concatenate([_pose_anchors(ext[i, :3, :3], ext[i, :3, 3], d) for i in range(len(ext))])
    gt = np.asarray(gt_poses, np.float64)[kf_idx]
    rots = so3.exp(torch.from_numpy(gt[:, :3])).numpy()
    dst = np.concatenate([_pose_anchors(r, p[3:], d) for r, p in zip(rots, gt)])
    tf = umeyama(src, dst)
    r = tf.apply(src) - dst
    pose_rmse = float(np.sqrt((r * r).sum(axis=1).mean()))
    pts = tf.apply(res.points)
    c, ax = np.array(scene.ellipsoid_center), np.array(scene.ellipsoid_axes)
    implicit = np.minimum(np.abs(np.linalg.norm((pts - c) / ax, axis=1) - 1.0), np.abs(pts[:, 1]) / float(np.mean(ax)))
    return {
        "gauge_scale": tf.scale,
        "aligned_pose_rmse": pose_rmse,
        "aligned_pose_rmse_vs_ring": pose_rmse / scene.ring_radius,
        "point_surface_residual_median": float(np.median(implicit)),
        "point_surface_residual_p90": float(np.percentile(implicit, 90)),
    }


def odometry_accuracy(res, gt_poses, first_steps=10) -> dict:
    """Chained rotations against the renderer's orbit, both relative to
    frame 0 (rotation is free of the monocular scale): the largest error
    over the first ``first_steps`` steps (the JAX package's test bound is 6
    degrees over 10 frames, ``tests/test_odometry.py``), the largest over
    the clip and the error at its last frame (drift), in degrees; and the
    fewest points tracked in a step."""

    def rel(poses):
        r = so3.exp(torch.from_numpy(np.asarray(poses, np.float64)[:, :3]))
        return r @ r[0].T

    r_est, r_gt = rel(res.poses), rel(gt_poses)
    cos = (torch.einsum("tij,tij->t", r_est, r_gt) - 1.0) / 2.0
    err = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0))).numpy()
    return {
        "rot_err_first_deg": float(err[1 : first_steps + 1].max()),
        "rot_err_max_deg": float(err.max()),
        "drift_deg": float(err[-1]),
        "min_tracked": int(res.num_tracked[1:].min()),
        "orbit_deg": float(torch.rad2deg(torch.arccos(torch.clamp((torch.trace(r_gt[-1]) - 1.0) / 2.0, -1.0, 1.0)))),
    }


def count_host_syncs(run):
    """Run ``run()`` (a ``process`` or ``chain_poses`` call) with
    ``MEATMODELER_SYNC_STAGES=1`` and read its host syncs from the
    program's own counters: ``host_reads:<span>`` (each synchronizing CUDA
    operation, by the span it ran in) and ``lm_iterations:<span>`` (each LM
    iteration reads one flag back), in all and inside the marker-free pose
    chain. Returns (run's result, counts)."""
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    counters = res.metrics["counters"]

    def by_span(prefix):
        return {k[len(prefix):]: v for k, v in counters.items() if k.startswith(prefix)}

    reads, iterations = by_span("host_reads:"), by_span("lm_iterations:")

    def in_chain(table):
        return sum(v for path, v in table.items() if path.split("/")[0] == "pose_chain")

    return res, {
        "lm_iterations": sum(iterations.values()), "cuda_syncs": sum(reads.values()),
        "chain_lm_iterations": in_chain(iterations), "chain_cuda_syncs": in_chain(reads),
        "host_reads_by_span": reads, "lm_iterations_by_span": iterations, "wall_s": wall,
    }


# The calls that make up one odometry step, timed in its synced run; the
# ransac calls after ``estimate_relative_pose`` run inside it (their
# seconds are part of its own), and so does ``triangulate_pairs`` inside
# ``scale_step`` (CPU tensors only: on the card the step is one kernel).
ODOMETRY_STAGES = (
    (clahe, "clahe"),
    (klt, "build_pyramid"),
    (klt, "lucas_kanade"),
    (ransac, "estimate_relative_pose"),
    (odometry_module, "scale_step"),
    (triangulation, "triangulate_pairs"),
    (features, "good_features"),
    (ransac, "essential_hypotheses"),
    (ransac, "recover_pose"),
    (ransac, "homography_hypotheses"),
    (ransac, "homography_polish"),
    (ransac, "refine_relative_pose"),
    (ransac, "score_candidates"),
)


def synced_calls(run, targets):
    """Run ``run()`` with each (module, name) of ``targets`` wrapped to sync
    the device before and after and to add its wall seconds to a sum per
    name. Returns (run's result, {name: seconds})."""
    sums = {name: 0.0 for _, name in targets}
    real = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def timed(name, fn):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                sums[name] += time.perf_counter() - t0

        return call

    for mod, name, fn in real:
        setattr(mod, name, timed(name, fn))
    try:
        out = run()
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    return out, sums


# The JAX package's point-sharded test problem (tests/test_sharding.py:93-108).
SHARDED_PROBLEM = dict(seed=42, n_frames=12, n_points=10240, n_obs=40960)


def synthetic_ba_problem(device, seed=42, n_frames=12, n_points=10240, n_obs=40960):
    """The JAX package's sharding-test BA problem (``make_ba_problem`` of
    ``tests/test_sharding.py``): its numpy draws, projected with this
    package, float32 on ``device``."""
    rng = np.random.default_rng(seed)
    k = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], np.float32)
    pts = rng.normal(size=(n_points, 3)).astype(np.float32) * 2
    cams = np.hstack([rng.normal(size=(n_frames, 3)) * 0.1, rng.normal(size=(n_frames, 3))]).astype(np.float32)
    cams[:, 5] += 10
    fidx = rng.integers(0, n_frames, n_obs)
    pidx = rng.integers(0, n_points, n_obs)
    obs = projection.project_points(torch.from_numpy(pts[pidx]), torch.from_numpy(cams[fidx]), torch.from_numpy(k))
    obs = obs.numpy() + rng.normal(scale=0.3, size=obs.shape).astype(np.float32)
    cams0 = cams + rng.normal(scale=0.01, size=cams.shape).astype(np.float32)
    pts0 = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    fields = (cams0, pts0, k, obs, fidx, pidx, np.ones(n_obs, bool))
    return bundle_adjust.BAProblem(*(torch.from_numpy(np.asarray(a)).to(device) for a in fields))


def headline_ba_problem(frames, corners, config):
    """The BA problem that ``process`` hands the global solve on the
    headline clip (the last ``solve_ba`` call of one known-corner run)."""
    with recording(bundle_adjust, "solve_ba") as calls:
        process(frames, config=config, known_corners=corners, device="cuda")
    return [args[0] for args, kwargs in calls if not kwargs.get("fix_points")][-1]


@contextlib.contextmanager
def recording(module, name, keep: bool = True):
    """Within the block, every call of ``module.name`` (from any thread)
    runs as before and appends its (args, kwargs) to the list the block
    receives; without ``keep`` it appends None, and the list only counts."""
    calls, real = [], getattr(module, name)

    def call(*args, **kwargs):
        calls.append((args, kwargs) if keep else None)
        return real(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def with_dtype(problem, dtype):
    """A BA ``problem`` with its float fields in ``dtype``."""
    return problem._replace(**{
        k: getattr(problem, k).to(dtype) for k in ("cam_params", "points", "intrinsics", "obs", "weight")
        if getattr(problem, k) is not None
    })


def _compare(a, b) -> dict:
    """Iterations, rmse and the largest parameter differences of two solves."""
    return {
        "iterations": [a.iterations, b.iterations], "rmse": [float(a.rmse), float(b.rmse)],
        "cam_max_abs_diff": float((a.cam_params.double() - b.cam_params.double()).abs().max()),
        "points_max_abs_diff": float((a.points.double() - b.points.double()).abs().max()),
    }


def point_sharded_check(problem, devices, config=None) -> dict:
    """``solve_ba_point_sharded`` over ``devices`` against the unsharded
    ``solve_ba`` on ``problem``. Raises on disagreement.

    In float64 the sharded solve is held to the JAX package's bounds
    (``tests/test_sharding.py``: rmse rtol 1e-4, equal iterations, cameras
    atol 1e-4, points atol 1e-3). In the problem's own float32, which the
    path runs, a problem's cameras and points are fixed only as far as its
    conditioning allows any change of summation order to move them: there
    the check is the rmse (rtol 1e-4), and the parameter differences are
    reported beside those between the unsharded solve and itself with the
    observations permuted. Each float32 solve is timed once (host clock to
    a device sync)."""
    config = config or SolverConfig()
    mesh = sharded.make_mesh(data=len(devices), devices=devices)
    wall_1, one = _timed(lambda: bundle_adjust.solve_ba(problem, config=config))
    wall_sh, sh = _timed(lambda: sharded.solve_ba_point_sharded(mesh, problem, config=config))
    perm = torch.randperm(problem.obs.shape[0], generator=torch.Generator().manual_seed(0)).to(problem.obs.device)
    permuted = bundle_adjust.solve_ba(problem._replace(**{
        k: getattr(problem, k)[perm] for k in ("obs", "frame_idx", "point_idx", "mask", "weight")
        if getattr(problem, k) is not None
    }), config=config)
    p64 = with_dtype(problem, torch.float64)
    out = {
        "devices": [str(d) for d in devices], "points": problem.points.shape[0], "frames": problem.cam_params.shape[0],
        "observations": problem.obs.shape[0], "unsharded_s": wall_1, "sharded_s": wall_sh,
        "float32": _compare(one, sh), "float32_unsharded_permuted": _compare(one, permuted),
        "float64": _compare(bundle_adjust.solve_ba(p64, config=config),
                            sharded.solve_ba_point_sharded(mesh, p64, config=config)),
    }
    f32, f64 = out["float32"], out["float64"]
    ok = (
        abs(f32["rmse"][1] - f32["rmse"][0]) <= 1e-4 * abs(f32["rmse"][0])
        and f64["iterations"][0] == f64["iterations"][1]
        and abs(f64["rmse"][1] - f64["rmse"][0]) <= 1e-4 * abs(f64["rmse"][0])
        and f64["cam_max_abs_diff"] <= 1e-4
        and f64["points_max_abs_diff"] <= 1e-3
    )
    if not ok:
        raise AssertionError(f"point-sharded solve disagrees with the unsharded one: {json.dumps(out)}")
    return out


def profile_sharded(problem, warm_runs) -> dict:
    """The point-sharded solve of ``problem`` against the unsharded
    ``solve_ba``, on four virtual shards of ``cuda:0`` and, with several
    GPUs, over all of them: one checked run each (``point_sharded_check``),
    then ``warm_runs`` timed runs of each, in turns; the all-reduces and
    flag reads (one per LM iteration) of one sharded solve."""
    n_gpus = torch.cuda.device_count()
    meshes = {"virtual4": [torch.device("cuda", 0)] * 4}
    if n_gpus > 1:
        meshes[f"gpus{n_gpus}"] = [torch.device("cuda", i) for i in range(n_gpus)]
    rep = {"gpus": n_gpus}
    for label, devices in meshes.items():
        check = point_sharded_check(problem, devices)
        mesh = sharded.make_mesh(data=len(devices), devices=devices)
        one, sh = [], []
        for _ in range(warm_runs):
            one.append(_timed(lambda: bundle_adjust.solve_ba(problem))[0])
            sh.append(_timed(lambda: sharded.solve_ba_point_sharded(mesh, problem))[0])
        with recording(sharded, "all_reduce_sum") as reduces:
            res = sharded.solve_ba_point_sharded(mesh, problem)
        rep[label] = {
            "check": check, "unsharded": _quartiles(one), "sharded": _quartiles(sh),
            "all_reduces": len(reduces), "flag_reads": res.iterations,
        }
        print(f"[sharded] {label}: {check['points']} points, {check['frames']} frames; unsharded median "
              f"{rep[label]['unsharded']['median_s']} s, point-sharded median {rep[label]['sharded']['median_s']} s "
              f"(x{warm_runs} each); {len(reduces)} all-reduces and {res.iterations} flag reads per solve")
    return rep


def detector_config(config):
    """``config`` on the board-finding default path: the JAX package's
    default pass 1 ("device") and pass-2 enhance ("bgr_lab"), and the
    device chessboard detector."""
    return dataclasses.replace(
        config, pass1_backend="device", pass2_enhance="bgr_lab",
        chessboard=dataclasses.replace(config.chessboard, detector="device"),
    )


def _timed(run):
    """(wall seconds of ``run()`` up to a device sync, its result)."""
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _timed_process(frames, corners, config):
    return _timed(lambda: process(frames, config=config, known_corners=corners, device="cuda"))


# The hand-written kernels' wrappers, each with its launch counts.
KERNEL_MODULES = (clahe_cuda, klt_cuda, ransac_cuda, bundle_adjust_cuda, pnp_cuda, calibration_cuda)


def _reset_launches() -> None:
    for m in KERNEL_MODULES:
        m.reset_launches()


def _launches_per_run(runs: int) -> dict:
    """Each hand-written kernel's launches per run since ``_reset_launches``."""
    return {k: v / max(runs, 1) for m in KERNEL_MODULES for k, v in m.LAUNCHES.items()}


def _quartiles(walls) -> dict:
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else [walls[0]] * 3
    return {"wall_s": walls, "median_s": q[1], "q1_s": q[0], "q3_s": q[2]}


def _device_busy(trace_path: Path):
    """(busy ms, kernel launches) from a chrome trace: the union of the
    device's kernel, memcpy and memset intervals."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, kernels = [], 0
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            kernels += cat == "kernel"
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, kernels


def _profiled(label, run) -> dict:
    """One run of ``run`` under ``torch.profiler``: wall seconds, device busy
    ms, its share of the wall time, kernel launches."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = _timed(run)
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        busy_ms, kernels = _device_busy(trace)
    print(f"[{label}] profiled: wall {wall} s device busy {busy_ms} ms share {busy_ms / 1e3 / wall} "
          f"kernel launches {kernels}")
    return {"wall_s": wall, "device_busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / wall, "kernel_launches": kernels}


def profile_path(label, scene, frames, corners, config, warm_runs, report, gt_poses=None):
    """The four runs of one path; fills ``report[label]``. With ``gt_poses``
    (the marker-free path) the warm entry carries ``markerless_accuracy``
    in place of the volume error (the volume is in the gauge's units), and
    one more run counts the host syncs."""
    rep = report[label] = {}
    n_frames = len(frames)
    wall, res = _timed_process(frames, corners, config)
    rep["cold"] = {"wall_s": wall, "stages": res.metrics["timings"]}
    print(f"[{label}] cold: wall {wall} s stages {json.dumps(res.metrics['timings'])}")

    walls = []
    _reset_launches()
    for _ in range(warm_runs):
        wall, res = _timed_process(frames, corners, config)
        walls.append(wall)
    q = _quartiles(walls)
    rep["warm"] = {
        **q, "fps_at_median": n_frames / q["median_s"], "kernel_launches_per_run": _launches_per_run(len(walls)),
        "keyframes": res.metrics["counters"]["keyframes"], "points": len(res.points),
        "rmse_px": res.reprojection_rmse, "stages": res.metrics["timings"],
    }
    if gt_poses is None:
        rep["warm"]["volume_err"] = (res.volume - scene.volume) / scene.volume
    else:
        rep["warm"]["accuracy"] = markerless_accuracy(res, gt_poses, scene)
    print(f"[{label}] warm x{len(walls)}: median {q['median_s']} s (q1 {q['q1_s']}, q3 {q['q3_s']}), "
          f"{n_frames / q['median_s']} fps; keyframes {rep['warm']['keyframes']} points {rep['warm']['points']} "
          f"rmse {res.reprojection_rmse} {json.dumps({k: v for k, v in rep['warm'].items() if k in ('volume_err', 'accuracy')})}"
          f"; kernel launches per run {json.dumps(rep['warm']['kernel_launches_per_run'])}")

    torch.cuda.reset_peak_memory_stats()
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        wall, res = _timed_process(frames, corners, config)
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # Pass 1's own split: the children of its span (decimation, upload, scan, flags' read, ...).
    pass1 = {k: v for k, v in res.metrics["timings"].items() if k.startswith("pass1_keyframes/")}
    rep["synced"] = {"wall_s": wall, "stages": res.metrics["timings"], "pass1_split_s": pass1, "peak_alloc_mib": peak_mib}
    print(f"[{label}] synced: wall {wall} s peak alloc {peak_mib} MiB stages {json.dumps(res.metrics['timings'])} "
          f"pass1 split {json.dumps(pass1)}")

    rep["profiled"] = _profiled(label, lambda: process(frames, config=config, known_corners=corners, device="cuda"))

    if gt_poses is not None:
        _, syncs = count_host_syncs(lambda: process(frames, config=config, known_corners=corners, device="cuda"))
        rep["host_syncs"] = syncs
        print(f"[{label}] host syncs (sync debug mode on): {json.dumps(syncs)}")


def _stage_sums(results) -> dict:
    """Per-stage seconds summed over a list of results."""
    sums = {}
    for r in results:
        for k, v in r.metrics["timings"].items():
            sums[k] = sums.get(k, 0.0) + v
    return sums


def profile_entry(
    label, run, n_frames, warm_runs, report, summarize, baseline=None, synced_stages=None, profiled_run=None
):
    """The four runs of an entry point other than ``process`` (``run()``
    returns its results); fills ``report[label]``. ``summarize(results)``
    gives the warm entry's counts and accuracy. ``baseline``: another
    callable on the same input, run after each warm run (the pipelined
    schedule's sequential counterpart), whose wall times are kept beside.
    ``synced_stages``: (module, name) calls to time in the synced run (for
    an entry point without stage timings); else the results' stages are
    summed. ``profiled_run``: a shorter run for the profiled one, where a
    trace of the whole run is too large to read back."""
    rep = report[label] = {}
    wall, out = _timed(run)
    rep["cold"] = {"wall_s": wall}
    print(f"[{label}] cold: wall {wall} s")

    walls, base_walls, launches = [], [], {}
    for _ in range(warm_runs):
        _reset_launches()
        wall, out = _timed(run)
        walls.append(wall)
        for k, v in _launches_per_run(warm_runs).items():
            launches[k] = launches.get(k, 0.0) + v
        if baseline is not None:
            wall_b, out_b = _timed(baseline)
            base_walls.append(wall_b)
    q = _quartiles(walls)
    rep["warm"] = {**q, "fps_at_median": n_frames / q["median_s"], **summarize(out), "kernel_launches_per_run": launches}
    print(f"[{label}] warm x{len(walls)}: median {q['median_s']} s (q1 {q['q1_s']}, q3 {q['q3_s']}), "
          f"{n_frames / q['median_s']} fps; {json.dumps(summarize(out))}; kernel launches per run {json.dumps(launches)}")
    if baseline is not None:
        qb = _quartiles(base_walls)
        rep["baseline"] = {**qb, **summarize(out_b)}
        print(f"[{label}] baseline (one after the other) x{len(base_walls)}: median {qb['median_s']} s "
              f"(q1 {qb['q1_s']}, q3 {qb['q3_s']}); {json.dumps(summarize(out_b))}")

    torch.cuda.reset_peak_memory_stats()
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        if synced_stages:
            wall, (out, stages) = _timed(lambda: synced_calls(run, synced_stages))
        else:
            wall, out = _timed(run)
            stages = _stage_sums(out)
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    rep["synced"] = {"wall_s": wall, "stages_summed": stages, "peak_alloc_mib": peak_mib}
    print(f"[{label}] synced: wall {wall} s peak alloc {peak_mib} MiB stages summed {json.dumps(stages)}")

    rep["profiled"] = _profiled(label, profiled_run or run)


def batch_summary(scene):
    def summarize(results):
        return {
            "keyframes": [r.metrics["counters"]["keyframes"] for r in results],
            "points": [len(r.points) for r in results],
            "rmse_px": [r.reprojection_rmse for r in results],
            "volume_err": [(r.volume - scene.volume) / scene.volume for r in results],
            "low_confidence": [r.volume_confidence["low_confidence"] for r in results],
            "ba_iterations": [r.metrics["counters"]["ba_iterations"] for r in results],
        }

    return summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm-runs", type=int, default=10)
    ap.add_argument("--out", default=str(REPO / "build" / "profile_headline.json"))
    ap.add_argument("--paths", default="known,detector,markerless,batch,pipelined,odometry,sharded",
                    help="comma-separated subset to run")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not torch.cuda.is_available():
        print("profile_headline: CUDA is not available", file=sys.stderr)
        return 2
    config = headline_config()
    report = {"device": torch.cuda.get_device_name(0), "frames": HEADLINE_FRAMES}
    report["library_prebuilt"] = all(m.LIBRARY.exists() for m in KERNEL_MODULES)

    if "known" in paths or "detector" in paths or "sharded" in paths:
        t0 = time.perf_counter()
        scene, frames, corners = headline_clip("cuda")
        torch.cuda.synchronize()
        report["render_s"] = time.perf_counter() - t0
        print(f"rendered {tuple(frames.shape)} in {report['render_s']} s (library prebuilt: {report['library_prebuilt']})")
        if "known" in paths:
            profile_path("known", scene, frames, corners, config, args.warm_runs, report)
        if "detector" in paths:
            profile_path("detector", scene, frames, None, detector_config(config), args.warm_runs, report)
        if "sharded" in paths:
            report["sharded"] = profile_sharded(headline_ba_problem(frames, corners, config), args.warm_runs)
        del frames
    if "markerless" in paths or "odometry" in paths:
        scene, frames, poses = markerless_clip("cuda")
        report["markerless_frames"] = len(frames)
        if "markerless" in paths:
            profile_path("markerless", scene, frames, None, markerless_config(), args.warm_runs, report, gt_poses=poses)
        if "odometry" in paths:
            # The profiled run and the sync count take the first 20 steps.
            steps = 20

            def odometry(n=None):
                return chain_poses(frames[:n], scene.intrinsics, device="cuda")

            profile_entry(
                "odometry", odometry, len(frames), args.warm_runs, report, lambda res: odometry_accuracy(res, poses),
                synced_stages=ODOMETRY_STAGES, profiled_run=lambda: odometry(steps + 1),
            )
            report["odometry"]["profiled"]["steps"] = steps
            _, syncs = count_host_syncs(lambda: odometry(steps + 1))
            report["odometry"]["host_syncs"] = {"steps": steps, **syncs}
            print(f"[odometry] host syncs over {steps} steps (sync debug mode on): {json.dumps(syncs)}")
        del frames
    if "batch" in paths:
        scene, clips = batch_clips("cuda")
        config = batch_config()
        profile_entry(
            "batch", lambda: process_batch(clips, config=config, device="cuda"), sum(len(c) for c in clips),
            args.warm_runs, report, batch_summary(scene),
        )
        del clips
    if "pipelined" in paths:
        scene, f0, c0 = headline_clip("cuda")
        _, f7, c7 = headline_clip("cuda", seed=PP_SEED)
        clips, corners = [f0, f7], [c0, c7]
        profile_entry(
            "pipelined", lambda: process_batch_pipelined(clips, config=headline_config(), known_corners=corners),
            2 * HEADLINE_FRAMES, args.warm_runs, report, batch_summary(scene),
            baseline=lambda: [process(v, config=headline_config(), known_corners=c, device="cuda")
                              for v, c in zip(clips, corners)],
        )

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
