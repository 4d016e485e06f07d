"""Ideal (exact-silhouette) visual hull of a turntable scene's ellipsoid
(torch package's twin of ``tools/ideal_visual_hull.py``; numpy only).

Answers "how big SHOULD the voxel carve be?": the carve estimator
(``volume.hull_and_carved_volume``'s carved volume) reports the visual hull
of the item from the clip's view wedge, and from a partial arc that hull is
geometrically much larger than the item: no silhouette method can close
the unseen cone. This tool computes that bound with EXACT analytic
silhouettes (a voxel is inside a view's silhouette iff the ray from the
camera centre through it meets the ellipsoid), without the splat,
dilation and closing approximations the real carve makes.

Decision record (bench scene, 1080p, focal 1500, default 50-degree arc,
20 evenly spaced views, R=96):

    truth 22.619   ideal_visual_hull 36.360   ratio 1.607

i.e. the IDEAL carve from this wedge is +61% over truth. That is why
``volume`` (symmetric-completion hull intersected with the carve) is the
headline estimator and ``volume_carved`` is reported as a diagnostic upper
bound only (see ``volume.hull_and_carved_volume``).

Usage:  python3 -m meatmodeler_tpu_torch.tools.ideal_visual_hull [--views 20] [--res 96]
            [--width 1920] [--height 1080] [--focal 1500] [--arc 50]
"""

from __future__ import annotations

import argparse

import numpy as np

from meatmodeler_tpu_torch.io.synthetic import TurntableScene, camera_pose


def ideal_visual_hull(scene: TurntableScene, n_views: int, res: int) -> float:
    """Volume of the exact-silhouette visual hull from n evenly spaced views."""
    c = np.array(scene.ellipsoid_center)
    ax = np.array(scene.ellipsoid_axes)

    lo = c - ax * 1.3
    hi = c + ax * 1.3
    grids = [(np.arange(res) + 0.5) / res * (hi[i] - lo[i]) + lo[i] for i in range(3)]
    x, y, z = np.meshgrid(*grids, indexing="ij")
    voxels = np.stack([x, y, z], -1).reshape(-1, 3)
    voxel_vol = np.prod(hi - lo) / res**3

    inside = np.ones(len(voxels), bool)
    for t in np.linspace(0.0, 1.0, n_views):
        rot, tvec = camera_pose(scene, t)
        cam = -rot.T @ tvec  # camera centre in world coordinates
        # The ray cam -> voxel meets the ellipsoid iff |o' + s d'|^2 = 1
        # (coordinates scaled by the axes) has a real root.
        d_scaled = (voxels - cam) / ax
        o_scaled = (cam - c) / ax
        a2 = np.sum(d_scaled * d_scaled, axis=1)
        b2 = 2.0 * np.sum(d_scaled * o_scaled, axis=1)
        c2 = np.sum(o_scaled * o_scaled) - 1.0
        disc = b2 * b2 - 4.0 * a2 * c2
        # A real root only tests the infinite LINE; the silhouette needs the
        # ellipsoid on the FORWARD ray (s >= 0). With the camera outside the
        # ellipsoid (c2 > 0) the two roots share their sign, so the larger
        # root decides: s+ = (-b2 + sqrt(disc)) / (2 a2) >= 0 iff
        # -b2 + sqrt(disc) >= 0. An arc or focal that looks AWAY from the
        # item must not count the intersection behind the camera.
        hits = disc >= 0
        hits &= (-b2 + np.sqrt(np.maximum(disc, 0.0))) >= 0
        inside &= hits
    return float(inside.sum() * voxel_vol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--focal", type=float, default=1500.0)
    ap.add_argument("--arc", type=float, default=50.0)
    args = ap.parse_args(argv)

    scene = TurntableScene(image_size=(args.width, args.height), focal=args.focal, arc_degrees=args.arc)
    vh = ideal_visual_hull(scene, args.views, args.res)
    print(f"truth {scene.volume:.3f}  ideal_visual_hull {vh:.3f}  ratio {vh / scene.volume:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
