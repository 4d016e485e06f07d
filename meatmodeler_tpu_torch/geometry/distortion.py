"""OpenCV lens distortion model (k1, k2, p1, p2, k3) — torch twin of
``meatmodeler_tpu/geometry/distortion.py``."""

from __future__ import annotations

import torch

__all__ = ["distort_normalized", "distort_pixels", "undistort_pixels"]


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Distort (..., 2) normalized coordinates with (5,) coefficients."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _focal_center(intrinsics):
    f = torch.stack([intrinsics[0, 0], intrinsics[1, 1]])
    c = torch.stack([intrinsics[0, 2], intrinsics[1, 2]])
    return f, c


def distort_pixels(pix: torch.Tensor, intrinsics: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Ideal pixel coords -> distorted pixel coords."""
    f, c = _focal_center(intrinsics)
    return distort_normalized((pix - c) / f, dist) * f + c


def undistort_pixels(
    pix: torch.Tensor, intrinsics: torch.Tensor, dist: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Distorted pixel coords -> ideal pixel coords by OpenCV's fixed-point
    iteration x <- (x_d - tangential(x)) / radial(x)."""
    f, c = _focal_center(intrinsics)
    xyd = (pix - c) / f
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xy = xyd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xyd[..., 0] - dx) / radial, (xyd[..., 1] - dy) / radial], dim=-1)
    return xy * f + c
