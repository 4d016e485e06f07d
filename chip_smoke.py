"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CLAHE kernels from ``meatmodeler_tpu_torch/csrc`` (nvcc),
     removing any library left from an earlier build first;
  3. hold each kernel against its plain PyTorch version on the card (the
     LUT bit-exact, apply within 1e-4) on seeded images, a flat image, an
     unaligned width under two tile grids and a two-tone board;
  4. render the headline clip (300 frames, 1080p) on the card and run
     ``process`` with ``headline_config()`` and the renderer's board
     corners twice, with the launch counts reset just before; check the
     repo's accuracy bounds and that every kernel ran on this path; then
     compare the kernels once more at the path's own CLAHE input (all
     keyframes, grey at 540x960) and time them there;
  5. the board-finding default path: the same clip through ``process`` with
     ``detector_config(headline_config())`` (device pass 1, ``bgr_lab``
     enhance, device chessboard detector) and NO known corners, twice, with
     the launch counts reset just before; the same checks; then compare
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
     package's record on this clip; then the automatic fallback, the same
     clip once through ``detector_config(headline_config())`` with no
     corners: the device hunt must give up (``board_probe_exhausted`` >=
     ``board_probe_frames``) and the run come out marker-free; last, the
     kernels at this path's keyframe input (n_kf, 360, 640), compared and
     timed;
  7. the multi-video batch, the JAX package's batch row: 8 clips of 60
     frames, 1080p, seeds 100-107, rendered on the card, through
     ``process_batch`` with ``batch_config()`` and no corners, twice (launch
     counts reset just before); every clip must take the batch prepass and
     meet the rmse and volume bounds, and each kernel must launch once per
     clip; per-clip rmse and volume error are printed beside the JAX
     package's record;
  8. the pipelined schedule: the headline clip and a seed-7 render (300
     frames each, with their corners) through ``process_batch_pipelined``
     with ``headline_config()`` (launch counts reset just before), the same
     checks per clip, then the same two through ``process`` one after the
     other; seconds and rmse of both are printed;
  9. odometry: ``chain_poses`` over the board-free clip of phase 6 with the
     scene's K (launch counts reset just before): more than 50 points
     tracked in every step and a chained-rotation error under 6 degrees
     over the first 10 steps (the JAX package's test bound); the drift over
     the clip is printed; then the kernels compared and timed at its input
     (one 720x1280 frame) and at a batch clip's keyframes; last, the
     command line as a subprocess, ``python3 -m meatmodeler_tpu_torch.cli``
     on one batch clip saved as ``.npy`` with ``--detector device --json``,
     then on two with ``--schedule mesh``: exit 0 and the JSON payload's keys.
Kernel times are device medians with a cold L2 and the host's launch time
hidden (``tools/clahe_bench.time_ms``), each printed beside the bytes the
kernel must move, its bound at the card's memory rate and the share of it
reached. The last two lines are a JSON record of the kernels (launches
summed over all paths; times, bound and share at the known path's
keyframes) and the device line.
Per-stage attribution, device busy share and the e2e spread come from
``python3 -m meatmodeler_tpu_torch.tools.profile_headline``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from meatmodeler_tpu_torch.io import native_ops
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.ops import clahe as clahe_mod
from meatmodeler_tpu_torch.ops import clahe_cuda, color
from meatmodeler_tpu_torch.parallel.batch import process_batch
from meatmodeler_tpu_torch.parallel.pipelined import process_batch_pipelined
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.tools.clahe_bench import time_kernels
from meatmodeler_tpu_torch.tools.profile_headline import (
    HEADLINE_FRAMES,
    PP_SEED,
    batch_clips,
    batch_config,
    detector_config,
    headline_clip,
    headline_config,
    markerless_accuracy,
    markerless_clip,
    markerless_config,
    odometry_accuracy,
)

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
KERNELS = {
    "clahe_lut": ("meatmodeler_tpu/ops/clahe_pallas.py:192", "_lut_kernel"),
    "clahe_apply": ("meatmodeler_tpu/ops/clahe_pallas.py:208", "_apply_kernel"),
}


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
    for name in KERNELS:
        r = rows[name]
        print(f"time {label} {tuple(img.shape)} {name}: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f} ms), "
              f"{r['bytes']} B, bound {r['bound_ms']:.6f} ms, share of bound {r['share']:.3f}")


def run_path(label, scene, frames, corners, config):
    """One path through ``process`` on the headline clip, twice, with the
    launch counts reset just before and read just after. Returns (launches,
    counters of the last run)."""
    clahe_cuda.reset_launches()
    for run in range(2):
        t0 = time.perf_counter()
        res = process(frames, path=str(OUT / f"{label}{run}"), config=config, known_corners=corners, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = res.metrics["counters"]
        vol_err = (res.volume - scene.volume) / scene.volume
        low = res.volume_confidence["low_confidence"]
        print(f"[{label}] run {run}: wall {wall:.3f} s ({HEADLINE_FRAMES / wall:.2f} fps)")
        print("  stages:", json.dumps({k: round(v, 4) for k, v in res.metrics["timings"].items()}))
        print(f"  keyframes {c['keyframes']} of {c['keyframes_selected']} selected, points {len(res.points)} "
              f"rmse {res.reprojection_rmse:.4f} volume {res.volume:.4f} carved {res.volume_carved:.4f} "
              f"truth {scene.volume:.4f} err {vol_err:+.4f} confidence {json.dumps(res.volume_confidence)}")
        print(f"  keyframe indices {c['keyframe_indices']}")
        print(f"  clahe_cuda.LAUNCHES {clahe_cuda.LAUNCHES}")
        if c["keyframes"] < 3 or len(res.points) < 500:
            raise AssertionError("too few keyframes or points")
        if not (np.isfinite(res.reprojection_rmse) and res.reprojection_rmse <= RMSE_MAX_PX):
            raise AssertionError(f"rmse {res.reprojection_rmse} outside {RMSE_MAX_PX}")
        if not np.isfinite(res.points).all() or res.points.shape[1] != 3:
            raise AssertionError("non-finite or misshapen cloud")
        if not low and not abs(vol_err) <= VOLUME_ERR_MAX:
            raise AssertionError(f"hull volume error {vol_err} outside {VOLUME_ERR_MAX}")
    launches = dict(clahe_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    return launches, c


def run_markerless(scene, frames, poses):
    """Phase 6's two ``markerless_config()`` runs, with the launch counts
    reset just before and read just after. Returns (launches, counters)."""
    config = markerless_config()
    clahe_cuda.reset_launches()
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
        print(f"  clahe_cuda.LAUNCHES {clahe_cuda.LAUNCHES}")
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
    launches = dict(clahe_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the markerless path never launched: {launches}")
    return launches, c


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
    clahe_cuda.reset_launches()
    for run in range(2):
        before = dict(clahe_cuda.LAUNCHES)
        t0 = time.perf_counter()
        results = process_batch(clips, config=config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: clahe_cuda.LAUNCHES[k] - before[k] for k in KERNELS}
        print(f"[batch] run {run}: wall {wall:.3f} s for {len(clips)} clips ({n_frames / wall:.2f} fps aggregate), "
              f"batch solve {results[0].metrics['counters']['batch_solve_s']:.4f} s, launches {launched}")
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
    return dict(clahe_cuda.LAUNCHES), results[0].metrics["counters"]


def run_pipelined(scene, clips, corners):
    """Phase 8: ``process_batch_pipelined`` on two 300-frame clips, then the
    same two through ``process``. Returns the pipelined run's launches."""
    config = headline_config()
    clahe_cuda.reset_launches()
    t0 = time.perf_counter()
    piped = process_batch_pipelined(clips, config=config, known_corners=corners)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = dict(clahe_cuda.LAUNCHES)
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the pipelined path never launched: {launches}")
    return launches


def run_odometry(scene, frames, poses):
    """Phase 9a: ``chain_poses`` over the board-free clip. Returns its
    launches."""
    clahe_cuda.reset_launches()
    t0 = time.perf_counter()
    res = chain_poses(frames, scene.intrinsics, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(clahe_cuda.LAUNCHES)
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
    if min(launches.values()) < len(frames):
        raise AssertionError(f"a kernel did not launch for every frame of the odometry: {launches}")
    return launches


def run_cli(clips):
    """Phase 9b: the command line as a subprocess, on one batch clip saved
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = _gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    clahe_cuda.LIBRARY.unlink(missing_ok=True)
    t0 = time.perf_counter()
    clahe_cuda.build()
    print(f"built {clahe_cuda.LIBRARY} in {time.perf_counter() - t0:.2f} s")

    err = {"clahe_lut": 0.0, "clahe_apply": 0.0}
    compare_kernels(dev, seeded_cases(dev), err)

    t0 = time.perf_counter()
    scene, frames, corners = headline_clip(dev)
    torch.cuda.synchronize()
    print(f"rendered {frames.shape} in {time.perf_counter() - t0:.2f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    config = headline_config()
    timings = {}

    # Phase 4: known corners, host pass 1, grey enhance.
    launches, c = run_path("known", scene, frames, corners, config)
    # Its CLAHE input: every keyframe, grey at half resolution.
    p2s = config.pass2_downscale
    keyframes = np.ascontiguousarray(frames[c["keyframe_indices"]])
    grey = torch.from_numpy(native_ops.bgr_to_grey_down(keyframes, p2s)).to(dev).float()
    compare_kernels(dev, [("known-path keyframes", grey, (8, 8))], err)
    time_at("known-path keyframes", grey, timings)

    # Phase 5: the board-finding default path, video alone.
    dconfig = detector_config(config)
    launches_d, c = run_path("detector", scene, frames, None, dconfig)
    for k in launches:
        launches[k] += launches_d[k]
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
    launches_m, c = run_markerless(mscene, mframes, mposes)
    for k in launches:
        launches[k] += launches_m[k]
    mconfig = markerless_config()
    p2s = mconfig.pass2_downscale
    kf_grey = np.ascontiguousarray(mframes[c["keyframe_indices"]])
    kf_grey = torch.from_numpy(native_ops.bgr_to_grey_down(np.repeat(kf_grey[..., None], 3, axis=-1), p2s)).to(dev).float()
    compare_kernels(dev, [("marker-free keyframes", kf_grey, (8, 8))], err)
    time_at("marker-free keyframes", kf_grey, timings)
    clahe_cuda.reset_launches()
    run_fallback(mframes)
    if min(clahe_cuda.LAUNCHES.values()) <= 0:
        raise AssertionError(f"a kernel of the fallback path never launched: {clahe_cuda.LAUNCHES}")
    for k in launches:
        launches[k] += clahe_cuda.LAUNCHES[k]

    # Phase 7: the multi-video batch.
    t0 = time.perf_counter()
    bscene, bclips = batch_clips(dev)
    print(f"rendered {len(bclips)} x {bclips[0].shape} in {time.perf_counter() - t0:.2f} s")
    launches_b, c = run_batch(bscene, bclips)
    for k in launches:
        launches[k] += launches_b[k]
    batch_kf = torch.from_numpy(
        native_ops.bgr_to_grey_down(np.ascontiguousarray(bclips[0][c["keyframe_indices"]]), c["kf_scale"])
    ).to(dev).float()

    # Phase 8: the pipelined schedule on the headline clip and a seed-7 render.
    _, frames7, corners7 = headline_clip(dev, seed=PP_SEED)
    launches_p = run_pipelined(scene, [frames, frames7], [corners, corners7])
    for k in launches:
        launches[k] += launches_p[k]
    del frames, frames7

    # Phase 9: odometry over the board-free clip, its kernels, the CLI.
    launches_o = run_odometry(mscene, mframes, mposes)
    for k in launches:
        launches[k] += launches_o[k]
    frame = torch.from_numpy(np.ascontiguousarray(mframes[:1])).to(dev).float()
    compare_kernels(dev, [("odometry frame", frame, (8, 8)), ("batch-clip keyframes", batch_kf, (8, 8))], err)
    time_at("odometry frame", frame, timings)
    time_at("batch-clip keyframes", batch_kf, timings)
    run_cli(bclips)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "meatmodeler_tpu", "bench"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package or its bench: {loaded}")

    main = timings["known-path keyframes"]
    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "meatmodeler_tpu_torch/csrc/clahe.cu",
                "replaces": KERNELS[name][0],
                "launches": launches[name],
                "max_abs_err": err[name],
                "ms": main[name]["ms"],
                "plain_ms": main[name]["plain_ms"],
                "bound_ms": main[name]["bound_ms"],
                "bound_by": "bytes",
                "share": main[name]["share"],
                "library_ms": None,  # no single PyTorch call computes a tile-LUT CLAHE
                "at": main["shape"],
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
