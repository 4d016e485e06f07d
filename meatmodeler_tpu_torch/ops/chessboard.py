"""Board-corner helpers and sub-pixel corner refinement (torch twin of the
device half of ``meatmodeler_tpu/ops/chessboard.py``).

``canonicalize_corners`` and ``orient_corners_to`` are numpy helpers copied
from the reference because its module imports JAX at the top. Board
detection itself (cv2 or the device detector) is not part of this package:
``pipeline.process`` takes the corners as ``known_corners``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["canonicalize_corners", "orient_corners_to", "refine_corners_subpix"]


def orient_corners_to(corners: np.ndarray, prev: Optional[np.ndarray]) -> np.ndarray:
    """Resolve the board's 180-degree ambiguity against the previous
    keyframe's corners: keep the traversal whose endpoints stay closer."""
    c = np.asarray(corners, np.float32)
    if prev is None:
        return c
    keep = np.linalg.norm(c[0] - prev[0]) + np.linalg.norm(c[-1] - prev[-1])
    flip = np.linalg.norm(c[0] - prev[-1]) + np.linalg.norm(c[-1] - prev[0])
    if flip < keep:
        return np.ascontiguousarray(c[::-1])
    return c


def canonicalize_corners(corners: np.ndarray, pattern: Tuple[int, int]) -> np.ndarray:
    """Fix the grid traversal to a winding whose in-image cross product
    (along-row x along-column) is negative, reversing each row if needed."""
    cols, rows = pattern
    c = np.asarray(corners, np.float32).reshape(rows, cols, 2)
    v_row = c[0, -1] - c[0, 0]
    v_col = c[-1, 0] - c[0, 0]
    if v_row[0] * v_col[1] - v_row[1] * v_col[0] > 0:
        c = c[:, ::-1]
    return c.reshape(-1, 2)


def _grad_windows(img_p: torch.Tensor, q: torch.Tensor, win: int, pad: int):
    """Bilinear (win+2)^2 windows around q (B, N, 2) in the edge-padded
    images img_p (B, Hp, Wp), and their central-difference gradients."""
    size = win + 2
    half = (size - 1) / 2.0
    hp, wp = img_p.shape[-2:]
    tl = q - half + pad
    t0 = torch.floor(tl)
    fx = (tl[..., 0] - t0[..., 0])[..., None, None]
    fy = (tl[..., 1] - t0[..., 1])[..., None, None]
    x0 = torch.clamp(t0[..., 0].to(torch.int64), 0, wp - size - 1)
    y0 = torch.clamp(t0[..., 1].to(torch.int64), 0, hp - size - 1)
    ar = torch.arange(size + 1, device=img_p.device)
    bidx = torch.arange(img_p.shape[0], device=img_p.device)[:, None, None, None]
    big = img_p[bidx, (y0[..., None] + ar)[..., :, None], (x0[..., None] + ar)[..., None, :]]
    v = (
        big[..., :-1, :-1] * (1 - fy) * (1 - fx)
        + big[..., :-1, 1:] * (1 - fy) * fx
        + big[..., 1:, :-1] * fy * (1 - fx)
        + big[..., 1:, 1:] * fy * fx
    )
    gx = (v[..., 1:-1, 2:] - v[..., 1:-1, :-2]) * 0.5
    gy = (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) * 0.5
    return gx, gy


def refine_corners_subpix(
    img: torch.Tensor,
    corners: torch.Tensor,
    win: int = 11,
    iters: int = 30,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Refine (B, N, 2) corners on (B, H, W) images, or (N, 2) corners on
    one (H, W) image, to sub-pixel accuracy (cv2.cornerSubPix's
    orthogonality iteration, the reference's taper)."""
    if img.ndim == 2:
        return refine_corners_subpix(img[None], corners[None], win, iters, eps)[0]
    corners = corners.to(img.dtype)
    half = win // 2
    d = torch.arange(-half, half + 1, dtype=img.dtype, device=img.device)
    taper = torch.exp(-((d / (half + 1.0)) ** 2) * 2.0)
    weight = taper[:, None] * taper[None, :]
    offs_x = d[None, :].expand(win, win)
    offs_y = d[:, None].expand(win, win)
    pad = win + 3
    img_p = F.pad(img[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]

    q = corners
    for _ in range(iters):
        gx, gy = _grad_windows(img_p, q, win, pad)
        gxx = torch.sum(weight * gx * gx, dim=(-2, -1))
        gxy = torch.sum(weight * gx * gy, dim=(-2, -1))
        gyy = torch.sum(weight * gy * gy, dim=(-2, -1))
        bx = torch.sum(weight * (gx * gx * offs_x + gx * gy * offs_y), dim=(-2, -1))
        by = torch.sum(weight * (gx * gy * offs_x + gy * gy * offs_y), dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        ok = torch.abs(det) > 1e-12
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
        delta = torch.stack([(gyy * bx - gxy * by) * inv_det, (gxx * by - gxy * bx) * inv_det], dim=-1)
        small = torch.sum(delta * delta, dim=-1) < eps * eps
        q = torch.where((small | ~ok)[..., None], q, q + delta)
    # A fixed memory layout: downstream reductions sum in layout order.
    return q.contiguous()
