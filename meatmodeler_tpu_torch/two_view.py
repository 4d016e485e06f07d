"""Marker-free two-view reconstruction (torch twin of
``meatmodeler_tpu/two_view.py``).

ORB features -> exact Hamming matching -> single-level LK polish of the
matches -> batched LO-RANSAC relative pose (``geometry/ransac.py``) -> DLT
triangulation of the inliers. Scale is unobservable from two views: the
translation is unit-norm and the cloud is up to scale.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu_torch.geometry import projection, ransac, triangulation
from meatmodeler_tpu_torch.ops import clahe, klt, matching, orb
from meatmodeler_tpu_torch.pipeline import _make_device, full_fp32

__all__ = ["TwoViewResult", "reconstruct_two_view"]


class TwoViewResult(NamedTuple):
    points: torch.Tensor  # (M, 3) triangulated points (inlier slots valid)
    rvec: torch.Tensor  # (3,) axis-angle of camera 2 w.r.t. camera 1
    tvec: torch.Tensor  # (3,) unit-norm translation (scale unobservable)
    pts1: torch.Tensor  # (M, 2) matched pixels in view 1
    pts2: torch.Tensor  # (M, 2) matched pixels in view 2
    inliers: torch.Tensor  # (M,) bool: epipolar inlier AND in front of both cams
    num_inliers: torch.Tensor  # scalar int
    essential: torch.Tensor  # (3, 3)


def reconstruct_two_view(
    frame1,
    frame2,
    intrinsics,
    config: PipelineConfig = DEFAULT_CONFIG,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 2048,
    threshold: float = 1.5,
    device="cuda",
) -> TwoViewResult:
    """Reconstruct an up-to-scale cloud from two frames and a known K.

    ``frame*``: (H, W, 3) BGR uint8 or (H, W) grey, arrays or tensors.
    ``generator``: the RANSAC draws' ``torch.Generator`` on ``device``
    (default: seed 0). Runs on ``device`` ("cuda" unless the caller asks for
    the CPU; without CUDA a "cuda" device raises) in full float32.
    """
    device = _make_device(device)
    with full_fp32(), torch.no_grad():
        k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)

        def grey_of(f):
            f = torch.as_tensor(np.asarray(f), device=device)
            if f.ndim == 3:
                return clahe.enhanced_grey(f[None])[0]
            return f.to(torch.float32)

        g1, g2 = grey_of(frame1), grey_of(frame2)
        oc, mc = config.orb, config.matcher
        feats = [
            orb.detect_and_compute(
                g, max_features=oc.num_features, num_levels=oc.num_levels,
                scale_factor=oc.scale_factor, fast_threshold=oc.fast_threshold,
            )
            for g in (g1, g2)
        ]
        m = matching.match_descriptors(
            feats[0].descriptors, feats[1].descriptors, feats[0].mask, feats[1].mask,
            ratio=mc.ratio, max_distance=mc.max_distance, max_matches=mc.max_matches,
            cross_check=mc.cross_check,
        )
        pts1 = feats[0].xy[m.query_idx]
        pts2 = feats[1].xy[m.train_idx]

        # Sub-pixel polish of the matches: single-level LK seeded at the
        # match offset (FAST/ORB keypoints localize only to ~1 px, fatal for
        # epipolar geometry on narrow baselines).
        flow = klt.lucas_kanade(
            klt.build_pyramid(g1, 1), klt.build_pyramid(g2, 1), pts1, win=15, levels=1,
            point_mask=m.mask, initial_flow=pts2 - pts1,
        )
        pts2 = torch.where((flow.status & m.mask)[:, None], flow.points, pts2)

        rvec, tvec, res = ransac.estimate_relative_pose(
            pts1, pts2, m.mask, k, generator, threshold=threshold, num_hypotheses=num_hypotheses
        )
        ext2 = projection.extrinsics_from_params(torch.cat([rvec, tvec])[None])[0]
        eye = torch.eye(3, 4, dtype=k.dtype, device=device)
        n = pts1.shape[0]
        pts3d = triangulation.triangulate_pairs(
            (k @ eye).expand(n, 3, 4), (k @ ext2).expand(n, 3, 4), pts1, pts2
        )
        # Cheirality: keep points in front of both cameras.
        c2 = pts3d @ ext2[:, :3].T + ext2[:, 3]
        in_front = (pts3d[:, 2] > 0) & (c2[:, 2] > 0) & torch.all(torch.isfinite(pts3d), dim=1)
        inliers = res.inliers & in_front
        return TwoViewResult(
            points=torch.where(inliers[:, None], pts3d, torch.zeros_like(pts3d)),
            rvec=rvec,
            tvec=tvec,
            pts1=pts1,
            pts2=pts2,
            inliers=inliers,
            num_inliers=inliers.sum(),
            essential=res.matrix,
        )
