"""Accuracy against the renderer's ground truth, frozen for the benchmark.

Copies of the port's ``utils/alignment.umeyama`` and of
``tools/profile_headline``'s ``markerless_accuracy`` and
``odometry_accuracy`` (the JAX package's bench formulas), as they stood
when the benchmark was defined. NumPy on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.frozen import so3

__all__ = ["SimilarityTransform", "umeyama", "markerless_accuracy", "odometry_accuracy"]


class SimilarityTransform(NamedTuple):
    scale: float
    rotation: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,)

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return self.scale * pts @ self.rotation.T + self.translation


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> SimilarityTransform:
    """Least-squares similarity transform mapping ``src`` onto ``dst``
    (Umeyama 1991), reflections excluded."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if not (src.shape == dst.shape and src.ndim == 2 and src.shape[1] == 3 and len(src) >= 3):
        raise ValueError(f"umeyama needs two (N >= 3, 3) point sets, got {src.shape} and {dst.shape}")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    rot = u @ s @ vt
    var_s = (sc * sc).sum() / len(src)
    scale = float(np.trace(np.diag(d) @ s) / max(var_s, 1e-30)) if with_scale else 1.0
    t = mu_d - scale * rot @ mu_s
    return SimilarityTransform(scale, rot, t)


def _pose_anchors(rot: np.ndarray, tvec: np.ndarray, d: float) -> np.ndarray:
    """Three alignment anchors per camera: centre, +forward*d, +down*d."""
    c = -rot.T @ tvec
    return np.stack([c, c + rot.T @ np.array([0.0, 0.0, 1.0]) * d, c + rot.T @ np.array([0.0, 1.0, 0.0]) * d])


def markerless_accuracy(keyframe_indices, extrinsics, points, gt_poses, scene) -> dict:
    """The keyframe poses' anchors Umeyama-aligned to the renderer's, their
    RMSE absolute and relative to the camera-ring radius, and the median and
    p90 distance of the aligned points to the nearest true surface (ellipsoid
    or ground plane), in units of the ellipsoid's semi-axes."""
    ext = np.asarray(extrinsics, np.float64)
    d = scene.ring_radius / 3.0
    src = np.concatenate([_pose_anchors(ext[i, :3, :3], ext[i, :3, 3], d) for i in range(len(ext))])
    gt = np.asarray(gt_poses, np.float64)[list(keyframe_indices)]
    rots = so3.exp(torch.from_numpy(gt[:, :3])).numpy()
    dst = np.concatenate([_pose_anchors(r, p[3:], d) for r, p in zip(rots, gt)])
    tf = umeyama(src, dst)
    r = tf.apply(src) - dst
    pose_rmse = float(np.sqrt((r * r).sum(axis=1).mean()))
    pts = tf.apply(np.asarray(points, np.float64))
    c, ax = np.array(scene.ellipsoid_center), np.array(scene.ellipsoid_axes)
    implicit = np.minimum(np.abs(np.linalg.norm((pts - c) / ax, axis=1) - 1.0), np.abs(pts[:, 1]) / float(np.mean(ax)))
    return {
        "gauge_scale": tf.scale,
        "aligned_pose_rmse": pose_rmse,
        "aligned_pose_rmse_vs_ring": pose_rmse / scene.ring_radius,
        "point_surface_residual_median": float(np.median(implicit)),
        "point_surface_residual_p90": float(np.percentile(implicit, 90)),
    }


def odometry_accuracy(poses, num_tracked, gt_poses, first_steps=10) -> dict:
    """Chained rotations against the renderer's orbit, both relative to
    frame 0: the largest error over the first ``first_steps`` steps, over
    the clip, and at its last frame, in degrees; the fewest points tracked
    in a step."""

    def rel(p):
        r = so3.exp(torch.from_numpy(np.asarray(p, np.float64)[:, :3]))
        return r @ r[0].T

    r_est, r_gt = rel(poses), rel(gt_poses)
    cos = (torch.einsum("tij,tij->t", r_est, r_gt) - 1.0) / 2.0
    err = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0))).numpy()
    return {
        "rot_err_first_deg": float(err[1 : first_steps + 1].max()),
        "rot_err_max_deg": float(err.max()),
        "drift_deg": float(err[-1]),
        "min_tracked": int(np.asarray(num_tracked)[1:].min()),
    }
