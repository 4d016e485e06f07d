"""Marker-free visual odometry: KLT tracking + incremental pose chaining
(torch twin of ``meatmodeler_tpu/odometry.py``).

Consecutive frames are linked by pyramidal LK, each step's relative pose
comes from the batched LO-RANSAC essential estimator
(``geometry/ransac.py``), and the per-step monocular scale is propagated by
3-frame depth consistency: points tracked across (k-1, k, k+1) are
triangulated in both adjacent pairs, and the median depth ratio fixes step
k+1's translation relative to step k's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu_torch.geometry import projection, ransac, so3, triangulation
from meatmodeler_tpu_torch.ops import clahe, features, klt
from meatmodeler_tpu_torch.pipeline import _make_device, full_fp32
from meatmodeler_tpu_torch.utils.profiling import Metrics, profile_run

__all__ = ["OdometryResult", "chain_poses"]


class OdometryResult(NamedTuple):
    poses: np.ndarray  # (T, 6) world-to-camera [rvec, tvec]; frame 0 = identity
    num_inliers: np.ndarray  # (T,) epipolar inliers per step (0 for frame 0)
    num_tracked: np.ndarray  # (T,) KLT survivors per step
    scales: np.ndarray  # (T,) translation magnitude applied per step
    metrics: dict  # {"timings": span seconds by path, "counters"}, as ``process`` returns


def _compose(pose_a: np.ndarray, rvec_rel: np.ndarray, tvec_rel: np.ndarray) -> np.ndarray:
    """world->cam_b from world->cam_a and cam_a->cam_b."""
    r_a = so3.exp(torch.from_numpy(pose_a[:3])).numpy()
    r_rel = so3.exp(torch.from_numpy(rvec_rel)).numpy()
    r_b = r_rel @ r_a
    t_b = r_rel @ pose_a[3:] + tvec_rel
    return np.concatenate([so3.log(torch.from_numpy(r_b)).numpy(), t_b])


def chain_poses(
    frames,
    intrinsics,
    config: PipelineConfig = DEFAULT_CONFIG,
    generator: Optional[torch.Generator] = None,
    min_tracks: int = 40,
    num_hypotheses: int = 1024,
    device="cuda",
) -> OdometryResult:
    """Chain camera poses through a sequence without a calibration target.

    Args:
      frames: (T, H, W[, 3]) uint8 frames (BGR frames are enhanced with
        ``clahe.enhanced_grey``, grey ones with ``clahe.clahe``).
      intrinsics: (3, 3) K.
      config: the keyframe block supplies the Shi-Tomasi/KLT parameters.
      generator: the RANSAC draws' ``torch.Generator`` on ``device``
        (default: seed 0); every step draws from it in turn.
      min_tracks: reseed features when the live track count drops below this.
      num_hypotheses: RANSAC hypotheses per step.
      device: where the per-frame work runs ("cuda" by default; without CUDA
        it raises).

    Returns:
      OdometryResult (numpy) with frame-0-anchored world-to-camera poses.
      The global scale is set by the first step's unit translation (the
      monocular gauge); later steps are scaled consistently to it. Its
      ``metrics`` time each step's parts as stages (``utils/profiling``):
      ``odometry_enhance`` (upload and CLAHE), ``odometry_pyramid``,
      ``odometry_lk`` (LK and the survivor count's read),
      ``odometry_relpose`` (the estimate and its inliers' read),
      ``odometry_scale`` (triangulation, reads, the median depth ratio and
      the pose composition) and ``odometry_reseed``.
    """
    device = _make_device(device)
    generator = generator or ransac.default_generator(device)
    kf = config.keyframe
    frames = np.asarray(frames)
    eye = torch.eye(3, 4, device=device)
    metrics = Metrics()

    def pyramid_of(i):
        with metrics.stage("odometry_enhance"):
            f = torch.from_numpy(np.ascontiguousarray(frames[i])).to(device)
            grey = clahe.enhanced_grey(f[None])[0] if f.ndim == 3 else clahe.clahe(f.to(torch.float32))
        with metrics.stage("odometry_pyramid"):
            return klt.build_pyramid(grey, kf.pyramid_levels)

    def seed(grey):
        with metrics.stage("odometry_reseed"):
            c = features.good_features(
                grey, max_corners=kf.max_corners, quality_level=kf.quality_level,
                min_distance=kf.min_distance, block_size=kf.block_size,
            )
            return c.xy, c.mask

    poses = [np.zeros(6, np.float32)]
    inliers_per, tracked_per, scales = [0], [0], [0.0]
    with profile_run(), full_fp32(), torch.no_grad():
        with metrics.stage("odometry_relpose"):  # K's upload, once
            k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
        prev_pyr = pyramid_of(0)
        pts, mask = seed(prev_pyr[0])
        # Depth of each point slot in the previous camera, in the global
        # gauge (NaN = unavailable), for the scale chaining.
        prev_depth = np.full(pts.shape[0], np.nan, np.float32)
        prev_scale = 1.0
        for t in range(1, len(frames)):
            cur_pyr = pyramid_of(t)
            with metrics.stage("odometry_lk"):
                flow = klt.lucas_kanade(
                    prev_pyr, cur_pyr, pts, win=kf.window, levels=kf.pyramid_levels,
                    max_iters=kf.max_iters, eps=kf.eps, point_mask=mask,
                )
                good = mask & flow.status
                n_good = int(good.sum())
            tracked_per.append(n_good)
            with metrics.stage("odometry_relpose"):
                rvec, tvec, res = ransac.estimate_relative_pose(
                    pts, flow.points, good, k, generator=generator, num_hypotheses=num_hypotheses
                )
                inl = res.inliers.cpu().numpy()
            inliers_per.append(int(inl.sum()))

            with metrics.stage("odometry_scale"):
                # Triangulate this pair (unit translation): depths in camera t-1.
                ext2 = projection.extrinsics_from_params(torch.cat([rvec, tvec])[None])[0]
                n = pts.shape[0]
                pts3d = triangulation.triangulate_pairs(
                    (k @ eye).expand(n, 3, 4), (k @ ext2).expand(n, 3, 4), pts, flow.points
                ).cpu().numpy()
                ext2 = ext2.cpu().numpy()
                depth_cur = pts3d[:, 2]
                ok_depth = inl & np.isfinite(depth_cur) & (depth_cur > 1e-3)

                # Slots with a depth from the previous pair give the ratio of the
                # global gauge to this pair's unit-translation gauge.
                both = ok_depth & np.isfinite(prev_depth)
                if both.sum() >= 8:
                    scale = float(np.median(prev_depth[both] / depth_cur[both]))
                else:
                    scale = prev_scale  # assume constant speed
                scales.append(scale)
                poses.append(_compose(poses[-1], rvec.cpu().numpy(), tvec.cpu().numpy() * scale))

                # Depths in camera t, rescaled to the global gauge, for the next step.
                cam_t = (ext2[:3, :3] @ pts3d.T).T + ext2[:3, 3]
                new_depth = np.where(ok_depth, cam_t[:, 2] * scale, np.nan).astype(np.float32)

            pts, mask = flow.points, good
            if n_good < min_tracks:
                pts, mask = seed(cur_pyr[0])
                new_depth = np.full(pts.shape[0], np.nan, np.float32)
            prev_pyr, prev_depth, prev_scale = cur_pyr, new_depth, scale

    return OdometryResult(
        poses=np.stack(poses),
        num_inliers=np.asarray(inliers_per),
        num_tracked=np.asarray(tracked_per),
        scales=np.asarray(scales, np.float32),
        metrics=metrics.as_dict(),
    )
