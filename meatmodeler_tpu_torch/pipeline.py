"""End-to-end SfM + volume pipeline on one CUDA device — the ``process``
entry point (torch twin of ``meatmodeler_tpu/pipeline.py``).

The path is the reference's headline configuration (``bench.bench_config``):

  PASS 1 (host): the native C++ keyframe scan (``meatmodeler_tpu.io.
    native_pass1``) selects keyframes; only they go to the device, as
    half-resolution grey under ``pass2_enhance="grey"``.
  PASS 2 (device): CLAHE (the hand-written CUDA kernels), ORB, Hamming
    matching, the SoA track store.
  GEOMETRY (device): sub-pixel corners, Zhang calibration, planar PnP,
    pose-only BA, triangulation + outlier gate, global Schur BA, hull +
    carve volume; then the PLY file.

Board corners come from the caller (``known_corners``): board detection
(cv2 or the reference's device detector) is not part of this package yet,
and neither are the marker-free path, the device pass 1, the ``bgr_lab``
enhancement and incremental BA — each raises rather than running
something else. The reference's shape padding and bucketing, compile
warm-up threads and single-buffer fetch packing exist only for the XLA
compiler and its link, and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from meatmodeler_tpu.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu.io import ply as ply_mod
from meatmodeler_tpu.io import video as video_mod
from meatmodeler_tpu_torch import tracks as tracks_mod
from meatmodeler_tpu_torch import volume as volume_mod
from meatmodeler_tpu_torch.geometry import calibration, distortion, pnp, projection, triangulation
from meatmodeler_tpu_torch.ops import chessboard, clahe, matching, orb
from meatmodeler_tpu_torch.solvers import bundle_adjust
from meatmodeler_tpu_torch.utils import Metrics, numerics

__all__ = ["ProcessResult", "process"]


class ProcessResult(NamedTuple):
    points: np.ndarray  # (P, 3) bundle-adjusted cloud
    extrinsics: np.ndarray  # (F, 4, 4) refined keyframe extrinsics
    intrinsics: np.ndarray  # (3, 3)
    distortion: np.ndarray  # (5,)
    volume: float  # convex-hull volume of the item
    volume_carved: float  # voxel-carved volume
    ply_path: Optional[str]
    reprojection_rmse: float
    metrics: Dict[str, Any]
    # {"low_confidence", "view_arc_deg", "elongation", "reason", "n_item_points"}
    volume_confidence: Optional[Dict[str, Any]] = None


class PreBA(NamedTuple):
    """Everything computed before the global bundle adjustment."""

    ext_refined: torch.Tensor  # (F, 3, 4) pose-BA-refined extrinsics
    intrinsics: torch.Tensor  # (3, 3)
    dist: torch.Tensor  # (5,)
    points: torch.Tensor  # (P, 3) triangulated inlier points
    obs: torch.Tensor  # (O, 2) undistorted observations
    fidx: torch.Tensor  # (O,) frame indices
    pidx: torch.Tensor  # (O,) point indices
    obs_weight: torch.Tensor  # (O,) inverse-octave-sigma BA weights
    point_sigma: torch.Tensor  # (P,) per-point octave sigma
    point_parallax: torch.Tensor  # (P,) endpoint-ray parallax (deg)
    image_size: Tuple[int, int]  # (w, h) in pass-2 working resolution
    kf_scale: int = 1


def _check_supported(config: PipelineConfig, known_corners) -> None:
    if config.pass1_backend != "host":
        raise NotImplementedError(
            "pass1_backend='device' is not ported; use pass1_backend='host'"
        )
    if config.pass2_enhance != "grey":
        raise NotImplementedError(
            "pass2_enhance='bgr_lab' is not ported; use pass2_enhance='grey'"
        )
    if config.incremental_ba:
        raise NotImplementedError("incremental_ba is not ported")
    if known_corners is None:
        raise ValueError(
            "this package has no board detector yet: pass the per-frame board "
            "corners as known_corners (T, N, 2)"
        )


def _make_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"process(device={str(device)!r}): CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# --------------------------------------------------------------------------
# PASS 1: native host keyframe scan
# --------------------------------------------------------------------------


def _run_pass1_host(video, config, pattern, known_corners, metrics):
    """The reference's ``_run_pass1_host`` with known corners: the native
    C++ scan bootstraps at frame 0 and flags keyframes; each keyframe is
    kept on the host at the pass-2 working resolution (grey).

    Returns (kf_frames [host uint8 (h, w)], kf_corners, kf_indices,
    frames_total, pass-2 scale).
    """
    import time as _time

    from meatmodeler_tpu.io.native_pass1 import HostPass1Scanner

    source = video_mod.FrameSource(video)
    scale = config.pass1_downscale
    p2s = config.pass2_downscale
    with metrics.stage("pass1_keyframes"):
        frame_idx = 0
        kf_frames, kf_corners, kf_indices = [], [], []
        scanner = None

        def known_of(global_idx):
            return chessboard.canonicalize_corners(
                np.asarray(known_corners[global_idx], np.float32), pattern
            )

        def retain(frame_bgr, global_idx):
            # Grey at the pass-2 resolution (FrameSource yields BGR chunks).
            kf_frames.append(native_ops.bgr_to_grey_down(np.asarray(frame_bgr)[None], p2s)[0])
            kf_corners.append(known_of(global_idx))
            kf_indices.append(int(global_idx))

        for chunk in source.chunks(config.frame_chunk):
            min_dim = min(chunk.shape[1], chunk.shape[2])
            if scale == 0:
                scale = 4 if min_dim >= 1060 else 2 if min_dim >= 720 else 1
            if p2s == 0:
                p2s = 2 if min_dim >= 1060 else 1
            t_d0 = _time.perf_counter()
            grey_host = native_ops.bgr_to_grey_down(chunk, scale)
            metrics.add("pass1_decim_s", _time.perf_counter() - t_d0)
            if scanner is None:
                scanner = HostPass1Scanner(
                    config, grey_host.shape[1], grey_host.shape[2], full_width=chunk.shape[2]
                )
            idx0 = frame_idx
            frame_idx += len(chunk)
            bootstrap_at = 0 if not scanner.initialized else -1
            t_s0 = _time.perf_counter()
            flags, _ = scanner.scan(grey_host, bootstrap_at=bootstrap_at)
            metrics.add("pass1_host_scan_s", _time.perf_counter() - t_s0)
            if bootstrap_at >= 0:
                # The bootstrap frame is always a keyframe.
                retain(chunk[0], idx0)
                flags[:1] = False
            for i in np.nonzero(flags)[0]:
                retain(chunk[i], idx0 + int(i))

        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes_selected", len(kf_frames))
    return kf_frames, kf_corners, kf_indices, frame_idx, p2s or 1


def _resolve_board_corners(kf_corners):
    """Sequential 180-degree orientation anchoring of the (known) corners:
    the known-corner branch of the reference's resolver, so every keyframe
    is kept."""
    out, prev = [], None
    for c in kf_corners:
        prev = chessboard.orient_corners_to(c, prev)
        out.append(prev)
    return out


# --------------------------------------------------------------------------
# PASS 2 + geometry
# --------------------------------------------------------------------------


def _pose_stage(corners, intr, dist_coefs, obj_z0, side_length):
    """Undistort the corners and solve planar PnP against the reference's
    X-Z board (``processor.py:162-166``)."""
    und_corners = distortion.undistort_pixels(corners, intr, dist_coefs)
    board_xz = torch.zeros((obj_z0.shape[0], 3), dtype=corners.dtype, device=corners.device)
    board_xz[:, 0] = obj_z0[:, 0] * side_length
    board_xz[:, 2] = obj_z0[:, 1] * side_length
    poses = pnp.solve_pnp_batch(board_xz[:, [0, 2]], (0, 2), board_xz, und_corners, intr)
    return und_corners, poses


def _triangulate_gate(store, ext_refined, intr, dist_coefs, tri_mode, scale_factor, min_parallax_deg, reproj_gate):
    """Triangulate every track and gate outliers by their worst
    octave-normalized reprojection residual and the endpoint parallax
    (the reference's ``_make_triangulate_gate``)."""
    coords_und = distortion.undistort_pixels(store.coords, intr, dist_coefs)
    store = store._replace(coords=coords_und)
    projections = projection.projection_from_extrinsic(intr, ext_refined)
    first_kf, last_kf, first_xy, last_xy, tri_valid = tracks_mod.triangulation_endpoints(store)
    if tri_mode == "nview":
        pts3d = triangulation.triangulate_nview(projections, store.coords, store.obs_mask)
    else:
        pts3d = triangulation.triangulate_pairs(projections[first_kf], projections[last_kf], first_xy, last_xy)
    finite = torch.all(torch.isfinite(pts3d), dim=1)
    cam_params = projection.params_from_extrinsics(ext_refined)
    proj_all = projection.project_points(pts3d[:, None, :], cam_params[None, :, :], intr)  # (T, F, 2)
    resid = torch.linalg.norm(proj_all - store.coords, dim=-1)
    sigma_obs = torch.tensor(scale_factor, dtype=torch.float32, device=intr.device) ** store.octaves.to(torch.float32)
    resid_norm = torch.where(store.obs_mask, resid / sigma_obs, torch.zeros_like(resid))
    inlier = torch.amax(resid_norm, dim=1) < reproj_gate
    rot = ext_refined[:, :3, :3]
    centers = -torch.einsum("fij,fi->fj", rot, ext_refined[:, :3, 3])
    r1 = pts3d - centers[first_kf]
    r2 = pts3d - centers[last_kf]
    cosang = torch.sum(r1 * r2, dim=1) / torch.clamp(
        torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r2, dim=1), min=1e-12
    )
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    if min_parallax_deg > 0:
        inlier &= parallax_deg > min_parallax_deg
    store = store._replace(points=torch.where(finite[:, None], pts3d, torch.zeros_like(pts3d)))
    return store, tri_valid & finite & inlier, torch.sum(finite & ~inlier), parallax_deg


def _pass2_to_preba(config, metrics, ckpt, kf_stack, kf_frames, kf_corners, kf_indices, frame_idx, p2s, device):
    """PASS 2 + geometry from the keyframes to the BA-ready problem.
    ``kf_stack`` (enhanced greys, from a checkpoint) or ``kf_frames`` (raw
    host keyframes to upload and enhance here) must be given."""
    pattern = config.chessboard.pattern
    n_kf = len(kf_corners)
    if kf_stack is None:
        with metrics.stage("pass2_preprocess"):
            frames = torch.from_numpy(np.stack(kf_frames)).to(device)
            # The reference's pass-2 grey enhance uses CLAHE's defaults.
            kf_stack = clahe.clahe(frames.to(torch.float32))
    if ckpt.enabled and not ckpt.has("keyframes"):
        ckpt.save(
            "keyframes",
            greys=kf_stack.cpu().numpy(),
            corners=np.stack(kf_corners),
            frames_total=frame_idx,
            kf_scale=p2s,
            indices=np.asarray(kf_indices, np.int64),
        )

    with metrics.stage("pass2_orb"):
        oc = config.orb
        orb_batch = orb.detect_and_compute(
            kf_stack,
            max_features=oc.num_features,
            num_levels=oc.num_levels,
            scale_factor=oc.scale_factor,
            fast_threshold=oc.fast_threshold,
            grid_cells=oc.grid_cells,
        )

    with metrics.stage("pass2_matching"):
        mc = config.matcher
        pair_matches = matching.match_descriptors(
            orb_batch.descriptors[:-1], orb_batch.descriptors[1:],
            orb_batch.mask[:-1], orb_batch.mask[1:],
            ratio=mc.ratio, max_distance=mc.max_distance,
            max_matches=mc.max_matches, cross_check=mc.cross_check,
        )
        metrics.count_async("matches_per_pair", pair_matches.mask.sum(dim=1))

    with metrics.stage("pass2_tracks"):
        store = tracks_mod.make_store(config.tracks.max_tracks, n_kf, device=device)
        store = tracks_mod.update_tracks_scan(
            store, pair_matches.query_idx, pair_matches.train_idx, pair_matches.mask,
            orb_batch.xy, orb_batch.octave,
        )
        store = tracks_mod.finalize_tracks(store)
        metrics.count_async("tracks", store.used.sum())

    h, w = kf_stack.shape[1:]
    with metrics.stage("corner_refine"):
        # Corners are in full-resolution pixels; pass 2 works at 1/p2s.
        corners = torch.from_numpy(np.stack(kf_corners)).to(device) / p2s
        corners = chessboard.refine_corners_subpix(
            kf_stack, corners, win=config.chessboard.subpix_window,
            iters=config.chessboard.subpix_iters,
        )

    with metrics.stage("calibration"):
        obj_z0 = calibration.chessboard_object_points(pattern, corners.dtype, device)
        cb = config.chessboard
        calib = calibration.calibrate(
            corners, obj_z0, (w, h), num_dist=cb.calib_num_dist,
            fix_principal_point=cb.calib_fix_principal_point,
            single_focal=cb.calib_single_focal,
        )
        metrics.count_async("calibration_rms_px", calib.rms)
        numerics.check_finite("calibration", intrinsics=calib.intrinsics, dist=calib.dist)
        intr, dist_coefs = calib.intrinsics, calib.dist

    with metrics.stage("pose_estimation"):
        side = config.chessboard.side_length
        und_corners, poses = _pose_stage(corners, intr, dist_coefs, obj_z0, side)

    with metrics.stage("pose_ba"):
        ext0 = projection.extrinsics_from_params(poses)
        # The reference's tighter pose-only stopping rule.
        pose_cfg = dataclasses.replace(
            config.solver, ftol=min(config.solver.ftol, 1e-7),
            max_iters=max(config.solver.max_iters, 100),
        )
        ext_refined, pose_ba_res = bundle_adjust.adjust_pose(
            ext0, intr, und_corners.reshape(-1, 2), pattern=pattern,
            side_length=side, config=pose_cfg,
        )
        metrics.count_async("pose_ba_rmse_px", pose_ba_res.rmse)
        numerics.check_finite("pose_ba", extrinsics=ext_refined)

    with metrics.stage("triangulation"):
        store, tri_valid, n_outlier, track_parallax = _triangulate_gate(
            store, ext_refined, intr, dist_coefs, config.tracks.triangulation,
            config.orb.scale_factor, config.tracks.min_parallax_deg,
            reproj_gate=config.tracks.max_reproj_px / p2s,
        )
        metrics.count_async("triangulated", tri_valid.sum())
        metrics.count_async("outlier_tracks_dropped", n_outlier)

    return _finish_preba(
        store, tri_valid, track_parallax, ext_refined, intr, dist_coefs,
        (int(w), int(h)), p2s, float(config.orb.scale_factor),
    )


def _finish_preba(store, tri_valid, track_parallax, ext_refined, intr, dist_coefs,
                  image_size, p2s, scale_factor) -> PreBA:
    """BA observation lists from the track store: tracks with >= 2
    observations that passed the gate, their observations in track-major
    order, inverse-octave-sigma weights, per-point sigma and parallax."""
    n_obs_per = store.obs_mask.sum(1)
    track_ids = torch.nonzero(store.used & (n_obs_per >= 2))[:, 0]
    t_idx, f_idx = torch.nonzero(store.obs_mask[track_ids], as_tuple=True)
    sel = track_ids[t_idx]
    obs = store.coords[sel, f_idx]
    obs_sigma = torch.tensor(scale_factor, dtype=torch.float32, device=obs.device) ** store.octaves[
        sel, f_idx
    ].to(torch.float32)

    tri_valid_t = tri_valid[track_ids]
    obs_keep = tri_valid_t[t_idx]
    n_t = track_ids.shape[0]
    n_per = torch.bincount(t_idx, minlength=n_t).to(torch.float32)
    sum_per = torch.zeros(n_t, dtype=torch.float32, device=obs.device).index_add_(0, t_idx, obs_sigma)
    sigma_mean = torch.where(n_per > 0, sum_per / torch.clamp(n_per, min=1), torch.full_like(n_per, torch.inf))
    remap = torch.full((n_t,), -1, dtype=torch.int64, device=obs.device)
    remap[tri_valid_t] = torch.arange(int(tri_valid_t.sum()), device=obs.device)
    return PreBA(
        ext_refined=ext_refined,
        intrinsics=intr,
        dist=dist_coefs,
        points=store.points[track_ids][tri_valid_t],
        obs=obs[obs_keep],
        fidx=f_idx[obs_keep],
        pidx=remap[t_idx[obs_keep]],
        obs_weight=(1.0 / obs_sigma)[obs_keep],
        point_sigma=sigma_mean[tri_valid_t],
        point_parallax=track_parallax[track_ids][tri_valid_t],
        image_size=image_size,
        kf_scale=p2s,
    )


def _reconstruct_to_ba(video, config, known_corners, metrics, ckpt, device) -> PreBA:
    """PASS 1 + PASS 2 + geometry up to (not including) the global BA."""
    pattern = config.chessboard.pattern
    kf_stack, kf_frames = None, []
    if ckpt.has("keyframes"):
        data = ckpt.load("keyframes")
        kf_stack = torch.from_numpy(data["greys"].astype(np.float32)).to(device)
        kf_corners = list(data["corners"])
        frame_idx = int(data["frames_total"])
        p2s = int(data["kf_scale"])
        kf_indices = [int(i) for i in data["indices"]]
        metrics.count("frames_total", frame_idx)
    else:
        kf_frames, kf_corners, kf_indices, frame_idx, p2s = _run_pass1_host(
            video, config, pattern, known_corners, metrics
        )
        with metrics.stage("board_detect"):
            kf_corners = _resolve_board_corners(kf_corners)
    n_kf = len(kf_corners)
    metrics.count("keyframes", n_kf)
    metrics.count("kf_scale", p2s)
    metrics.count("keyframe_indices", list(kf_indices))
    if n_kf < 3:
        raise ValueError(
            f"only {n_kf} keyframes with a visible chessboard; need >= 3 (check "
            "the video shows the calibration target)"
        )
    if n_kf > config.tracks.max_keyframes:
        raise ValueError(
            f"{n_kf} keyframes exceed tracks.max_keyframes={config.tracks.max_keyframes}; "
            "raise the capacity or the keyframe threshold"
        )
    return _pass2_to_preba(config, metrics, ckpt, kf_stack, kf_frames, kf_corners, kf_indices, frame_idx, p2s, device)


def process(
    video,
    path: Optional[str] = None,
    config: PipelineConfig = DEFAULT_CONFIG,
    known_corners: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
) -> ProcessResult:
    """Video -> bundle-adjusted point cloud + volume (+ ``<path>Cloud.ply``).

    The reference's entry point without its cv2 parameter dicts (set
    ``config`` instead), plus ``device``: the whole device half runs there
    ("cuda" by default). Without CUDA a "cuda" device raises; the run
    never moves to the CPU on its own (pass ``device="cpu"`` for that).

    Args:
      video: path (video/.npy/.y4m) or (T, H, W[, 3]) uint8 array.
      path: output prefix for ``<path>Cloud.ply`` (skipped if None).
      config: the config tree; this package runs ``pass1_backend="host"``
        with ``pass2_enhance="grey"`` and batch BA.
      known_corners: (T, N, 2) board corners per frame — required.
      checkpoint_dir: per-stage npz artifacts; a re-run resumes after the
        keyframe stage.
    """
    device = _make_device(device)
    _check_supported(config, known_corners)
    from meatmodeler_tpu.utils.checkpoint import StageCheckpointer

    metrics = Metrics()
    ckpt = StageCheckpointer(checkpoint_dir)
    # Full float32 throughout the run: cuDNN would run the Sobel/box/Gaussian
    # convolutions in TF32 by default (the reference pins HIGHEST precision
    # for the same reason). The caller's settings come back afterwards.
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            pre = _reconstruct_to_ba(video, config, known_corners, metrics, ckpt, device)
            return _solve_and_finish(pre, config, metrics, ckpt, path)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# --------------------------------------------------------------------------
# Global BA + volume
# --------------------------------------------------------------------------


def _volume_confidence(arc_deg: float, elong: float, n_item: int, config) -> Dict[str, Any]:
    """LOW confidence in the estimator's validated weak regime (narrow arc x
    elongated item) or for a sparse item cloud (thresholds in VolumeConfig)."""
    vc = config.volume
    low = n_item >= 8 and arc_deg < vc.confidence_min_arc_deg and elong > vc.confidence_max_elongation
    reason = ""
    if low:
        reason = (
            f"view arc {arc_deg:.0f} deg < {vc.confidence_min_arc_deg:.0f} and "
            f"item elongation {elong:.2f} > {vc.confidence_max_elongation:.2f}: "
            "the symmetric-completion hull cannot observe the item's far "
            "long-axis extent from this arc (validated weak case: ~+40%)"
        )
    elif n_item < vc.confidence_min_item_points:
        low = True
        reason = (
            f"item cloud has only {n_item} points "
            f"(< {vc.confidence_min_item_points}): the trimmed support "
            "underreads a sparsely sampled surface — use a longer clip or "
            "denser features"
        )
    return {
        "low_confidence": bool(low),
        "view_arc_deg": round(arc_deg, 2),
        "elongation": round(elong, 3),
        "reason": reason,
        "n_item_points": n_item,
    }


def _view_regime(ext4, points, item_mask):
    """(view_arc_deg, elongation): the volume-confidence predictors."""
    n_item = torch.clamp(item_mask.sum(), min=1)
    pts_f = points.to(torch.float32)
    centroid = torch.sum(torch.where(item_mask[:, None], pts_f, torch.zeros_like(pts_f)), dim=0) / n_item
    centers = -torch.einsum("fij,fi->fj", ext4[:, :3, :3], ext4[:, :3, 3])
    d = centers - centroid[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-9)
    arc = torch.amax(torch.arccos(torch.clamp(d @ d.T, -1.0, 1.0)))
    x = torch.where(item_mask[:, None], pts_f - centroid[None, :], torch.zeros_like(pts_f))
    eig = torch.linalg.eigvalsh((x.T @ x) / n_item)  # ascending
    elong = torch.sqrt(eig[2] / torch.clamp(eig[1], min=1e-12))
    return torch.rad2deg(arc), elong


def _estimate_volume(pts, intrinsics, ext4, image_size, config, point_sigma, point_parallax, kf_scale):
    """Hull + carved volume of the gated item points. Returns a (6,) tensor
    [hull, carve, n_item, 0, view_arc_deg, elongation]; the caller applies
    the too-few-points NaN rule."""
    vc = config.volume
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    pmask = valid
    if vc.max_point_sigma > 0:
        precise = valid & (point_sigma <= vc.max_point_sigma)
        pmask = torch.where(precise.sum() >= 32, precise, pmask)
    if vc.min_parallax_deg > 0:
        certain = pmask & (point_parallax >= vc.min_parallax_deg)
        pmask = torch.where(certain.sum() >= 32, certain, pmask)
    item_mask = volume_mod.split_item_points(pts, pmask, use_plane=True)
    proj_new = projection.projection_from_extrinsic(intrinsics, ext4[:, :3, :])
    proj_mask = torch.ones(ext4.shape[0], dtype=torch.bool, device=pts.device)
    hull, carve = volume_mod.hull_and_carved_volume(
        pts, item_mask, proj_new, proj_mask, image_size=image_size,
        resolution=vc.voxel_resolution, num_directions=vc.hull_directions,
        trim=vc.hull_trim,
        # carve_dilation is in full-resolution pixels; the projections are
        # in 1/kf_scale units, and the silhouette grid step shrinks with it.
        dilation=max(1, round(vc.carve_dilation / kf_scale)),
        grid_step=max(1, 4 // kf_scale),
        close_frac=vc.carve_close_frac, vote_frac=vc.carve_vote_frac,
        support_mask=item_mask, trim_ref=vc.hull_trim_ref,
    )
    arc_deg, elong = _view_regime(ext4, pts, item_mask)
    return torch.stack(
        [hull.to(torch.float32), carve.to(torch.float32), item_mask.sum().to(torch.float32),
         torch.zeros((), device=pts.device), arc_deg.to(torch.float32), elong.to(torch.float32)]
    )


def _solve_and_finish(pre: PreBA, config, metrics, ckpt, path) -> ProcessResult:
    """Global BA + volume + PLY from a PreBA."""
    with metrics.stage("bundle_adjustment"):
        new_pts, new_ext, ba_res = bundle_adjust.adjust_points(
            pre.ext_refined, pre.intrinsics, pre.points, pre.obs, pre.fidx, pre.pidx,
            weights=pre.obs_weight, config=config.solver,
        )
        metrics.count_async("ba_rmse_px", ba_res.rmse)
        metrics.count("ba_iterations", ba_res.iterations)
        numerics.check_finite("bundle_adjustment", points=new_pts, extrinsics=new_ext)
        metrics.count("points", int(new_pts.shape[0]))
        if ckpt.enabled:
            ckpt.save(
                "cloud",
                points=new_pts.cpu().numpy(), extrinsics=new_ext.cpu().numpy(),
                intrinsics=pre.intrinsics.cpu().numpy(), distortion=pre.dist.cpu().numpy(),
                rmse=float(ba_res.rmse),
            )

    with metrics.stage("volume"):
        fused = _estimate_volume(
            new_pts, pre.intrinsics, new_ext, pre.image_size, config,
            pre.point_sigma, pre.point_parallax, pre.kf_scale,
        ).cpu().numpy()

    new_pts_np = new_pts.cpu().numpy()
    ply_path = None
    if path is not None:
        with metrics.stage("ply_export"):
            ply_path = ply_mod.write_ply(str(path) + "Cloud.ply", new_pts_np)

    n_item = int(fused[2])
    if n_item >= 8:
        vol_hull, vol_carve = float(fused[0]), float(fused[1])
    else:
        vol_hull = vol_carve = float("nan")
    metrics.count("item_points", n_item)
    metrics.count("volume_hull", vol_hull)
    metrics.count("volume_carved", vol_carve)
    volume_confidence = _volume_confidence(float(fused[4]), float(fused[5]), n_item, config)
    metrics.count("volume_low_confidence", volume_confidence["low_confidence"])
    metrics.count("volume_view_arc_deg", volume_confidence["view_arc_deg"])
    metrics.count("volume_elongation", volume_confidence["elongation"])
    return ProcessResult(
        points=new_pts_np,
        extrinsics=new_ext.cpu().numpy(),
        intrinsics=pre.intrinsics.cpu().numpy(),
        distortion=pre.dist.cpu().numpy(),
        volume=vol_hull,
        volume_carved=vol_carve,
        ply_path=ply_path,
        reprojection_rmse=float(ba_res.rmse),
        metrics=metrics.as_dict(),
        volume_confidence=volume_confidence,
    )
