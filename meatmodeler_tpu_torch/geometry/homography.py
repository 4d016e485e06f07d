"""Normalized DLT homography (torch twin of
``meatmodeler_tpu/geometry/homography.py``), batched over leading dims."""

from __future__ import annotations

import math

import torch

__all__ = ["find_homography", "normalize_points"]


def normalize_points(pts: torch.Tensor):
    """Hartley normalization of (..., N, 2) points.

    Returns (pts_normalized (..., N, 2), T (..., 3, 3)) with
    pts_n ~ T @ [pts; 1].
    """
    centroid = pts.mean(dim=-2)
    centered = pts - centroid[..., None, :]
    mean_dist = torch.linalg.norm(centered, dim=-1).mean(dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-12)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    t = torch.stack(
        [
            torch.stack([scale, zero, -centroid[..., 0] * scale], dim=-1),
            torch.stack([zero, scale, -centroid[..., 1] * scale], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return centered * scale[..., None, None], t


def find_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT homography with Hartley normalization, dst ~ H @ src.

    ``src`` (..., N, 2) broadcasts against ``dst`` (..., N, 2); returns
    (..., 3, 3) normalized so H[2, 2] = 1.
    """
    src_n, t_src = normalize_points(src)
    dst_n, t_dst = normalize_points(dst)
    src_n, dst_n = torch.broadcast_tensors(src_n, dst_n)
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows_u = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    rows_v = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    design = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2N, 9)
    ata = design.transpose(-1, -2) @ design
    _, vecs = torch.linalg.eigh(ata)
    h_n = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    # solve_ex: the same solution, without reading its info flag back to the
    # host as torch.linalg.solve does on the card.
    h = torch.linalg.solve_ex(t_dst, h_n @ t_src)[0]
    return h / h[..., 2:3, 2:3]
