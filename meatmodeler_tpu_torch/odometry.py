"""Marker-free visual odometry: KLT tracking + incremental pose chaining
(torch twin of ``meatmodeler_tpu/odometry.py``).

Consecutive frames are linked by pyramidal LK, each step's relative pose
comes from the batched LO-RANSAC essential estimator
(``geometry/ransac.py``), and the per-step monocular scale is propagated by
3-frame depth consistency: points tracked across (k-1, k, k+1) are
triangulated in both adjacent pairs, and the median depth ratio fixes step
k+1's translation relative to step k's. On the card that scale step is one
launch of ``csrc/scale_step.cu`` (:func:`scale_step`); the chain's poses,
scales and counts stay on the card until one read after the last step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu_torch.geometry import projection, ransac, ransac_hyp_cuda, so3, triangulation
from meatmodeler_tpu_torch.ops import clahe, cuda_build, features, klt
from meatmodeler_tpu_torch.pipeline import _make_device, full_fp32
from meatmodeler_tpu_torch.utils.profiling import Metrics, profile_run, trace

__all__ = ["OdometryResult", "chain_poses", "scale_step", "scale_step_reference"]

# Fewer slots with a depth in both pairs keep the previous step's scale.
MIN_RATIOS = 8


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


def scale_step_reference(pts1, pts2, inliers, rvec, tvec, intrinsics, prev_depth, prev_scale, prev_pose):
    """One step of the scale chaining, the plain version (the JAX package's
    step body, ``meatmodeler_tpu/odometry.py:129-163``): triangulate the
    step's pairs with unit translation (depths in the previous camera), take
    the median ratio of ``prev_depth`` to these depths over the inlier slots
    with a finite depth above 1e-3 in both pairs (``np.median``: the mean of
    the two middle values for an even count), or keep ``prev_scale`` where
    fewer than 8 slots qualify, and compose the pose.

    Args: (N, 2) pixels ``pts1`` / ``pts2`` of the previous and the current
    frame, bool (N,) ``inliers``, the step's ``rvec`` and unit ``tvec``
    (3,), a (3, 3) ``intrinsics`` (tensors, on any device, of one float
    type); ``prev_depth`` (N,) numpy depths in the previous camera in the
    chain's gauge (NaN = none), the previous step's ``prev_scale`` (float)
    and the previous frame's world-to-camera ``prev_pose`` (6,) numpy.

    Returns (pose (6,), scale, new depths (N,) in the current camera in the
    chain's gauge, NaN where no inlier in front of the previous camera,
    held): numpy, a float, numpy and whether the scale was held.
    """
    eye = torch.eye(3, 4, dtype=intrinsics.dtype, device=intrinsics.device)
    ext2 = projection.extrinsics_from_params(torch.cat([rvec, tvec])[None])[0]
    n = pts1.shape[0]
    pts3d = triangulation.triangulate_pairs(
        (intrinsics @ eye).expand(n, 3, 4), (intrinsics @ ext2).expand(n, 3, 4), pts1, pts2
    ).cpu().numpy()
    ext2 = ext2.cpu().numpy()
    depth_cur = pts3d[:, 2]
    ok_depth = inliers.cpu().numpy() & np.isfinite(depth_cur) & (depth_cur > 1e-3)

    # Slots with a depth from the previous pair give the ratio of the
    # global gauge to this pair's unit-translation gauge.
    both = ok_depth & np.isfinite(prev_depth)
    held = bool(both.sum() < MIN_RATIOS)  # then assume constant speed
    scale = prev_scale if held else float(np.median(prev_depth[both] / depth_cur[both]))
    pose = _compose(prev_pose, rvec.cpu().numpy(), tvec.cpu().numpy() * scale)

    # Depths in the current camera, rescaled to the global gauge, for the next step.
    cam_t = (ext2[:3, :3] @ pts3d.T).T + ext2[:3, 3]
    new_depth = np.where(ok_depth, cam_t[:, 2] * scale, np.nan).astype(prev_depth.dtype)
    return pose, scale, new_depth, held


def scale_step(pts1, pts2, inliers, rvec, tvec, intrinsics, depth, prev_pose, prev_scale, pose, scale, counts):
    """:func:`scale_step_reference` in place, as ``ransac_hyp_cuda.scale_step``
    takes it: one launch of the CUDA kernel for tensors on the card, the
    plain version on the CPU. ``depth`` (N,) holds the previous step's
    depths and gets this step's; ``pose`` (6,) and the 0-d ``scale`` get the
    chained pose and the scale; the int32 ``counts`` (2,) the inlier count
    and whether the scale was held."""
    if cuda_build.on_card(pts1):
        ransac_hyp_cuda.scale_step(
            pts1, pts2, inliers, rvec, tvec, intrinsics, depth, prev_pose, prev_scale, pose, scale, counts
        )
        return
    p, s, d, held = scale_step_reference(
        pts1, pts2, inliers, rvec, tvec, intrinsics, depth.numpy(), float(prev_scale), prev_pose.numpy()
    )
    pose.copy_(torch.from_numpy(p))
    scale.fill_(s)
    depth.copy_(torch.from_numpy(d))
    counts[0] = inliers.sum()
    counts[1] = int(held)


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
      ``odometry_relpose`` (the estimate), ``odometry_scale`` (the scale
      step: on the card one launch; its child ``odometry_scale/result`` is
      the record's one read after the last step) and ``odometry_reseed``.
      The counter ``scale_held:odometry_scale`` counts the steps that kept
      the previous step's scale.
    """
    device = _make_device(device)
    generator = generator or ransac.default_generator(device)
    kf = config.keyframe
    frames = np.asarray(frames)
    metrics = Metrics()

    def pyramid_of(i):
        with metrics.stage("odometry_enhance"):
            f = torch.from_numpy(np.ascontiguousarray(frames[i])).to(device)
            grey = clahe.enhanced_grey(f[None])[0] if f.ndim == 3 else clahe.clahe(f.to(torch.float32))
        with metrics.stage("odometry_pyramid"):
            return klt.build_pyramid(grey, kf.pyramid_levels)

    def seed(grey):
        """Fresh points, their mask, and their depths: none yet (NaN)."""
        with metrics.stage("odometry_reseed"):
            c = features.good_features(
                grey, max_corners=kf.max_corners, quality_level=kf.quality_level,
                min_distance=kf.min_distance, block_size=kf.block_size,
            )
            return c.xy, c.mask, torch.full(c.xy.shape[:1], float("nan"), device=device)

    tracked_per = [0]
    with profile_run(), full_fp32(), torch.no_grad():
        with metrics.stage("odometry_relpose"):  # K's upload, once
            k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
        with metrics.stage("odometry_scale"):
            # The chain's record, a row a frame: the world-to-camera pose and
            # the step's scale (float32 bits), its inlier count and whether
            # its scale was held. Row 0: frame 0's identity pose and the scale
            # the first step keeps if it must.
            record = torch.zeros((len(frames), 9), dtype=torch.int32, device=device)
            values = record[:, :7].view(torch.float32)
            values[0, 6].fill_(1.0)  # no host-to-device copy
        prev_pyr = pyramid_of(0)
        # Each point slot's depth in the previous camera, in the global gauge
        # (NaN = unavailable), for the scale chaining; updated in place.
        pts, mask, depth = seed(prev_pyr[0])
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
            with metrics.stage("odometry_scale"):
                scale_step(pts, flow.points, res.inliers, rvec, tvec, k, depth, values[t - 1, :6],
                           values[t - 1, 6], values[t, :6], values[t, 6], record[t, 7:])
            pts, mask = flow.points, good
            if n_good < min_tracks:
                pts, mask, depth = seed(cur_pyr[0])
            prev_pyr = cur_pyr
        with metrics.stage("odometry_scale"), trace("result"):  # the chain's one read
            record = record.cpu()

    values, counts = record[:, :7].view(torch.float32).numpy(), record[:, 7:].numpy()
    scales = values[:, 6].copy()
    scales[0] = 0.0
    metrics.add("scale_held:odometry_scale", int(counts[1:, 1].sum()))
    return OdometryResult(
        poses=np.ascontiguousarray(values[:, :6]),
        num_inliers=counts[:, 0].astype(np.int64),
        num_tracked=np.asarray(tracked_per),
        scales=scales,
        metrics=metrics.as_dict(),
    )
