"""Volume estimation: item split, support-function hull and voxel carving
(torch twin of ``meatmodeler_tpu/volume.py``).

The (V, D) voxel-by-direction projection of the hull step is computed in
slabs, as the reference does, so it never materialises whole. Matmuls run
in full float32 (``pipeline.process`` turns TF32 off): the k-NN expansion
in ``split_item_points`` is cancellation-prone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.utils.numerics import nanmedian

__all__ = [
    "split_item_points",
    "convex_hull_volume",
    "maxpool_sep",
    "erode_sep",
    "hull_and_carved_volume",
]

_BIG = 1e9


def _nan0(x: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.full_like(x, fill), x)


def split_item_points(
    points: torch.Tensor,
    mask: torch.Tensor,
    plane_margin: float = 0.3,
    knn: int = 6,
    use_plane: bool = True,
) -> torch.Tensor:
    """Mask of item points: above the board plane (y < -margin), passing a
    k-NN density gate and a median + 4 MAD distance-to-centroid gate."""
    p = points.shape[0]
    above = points[:, 1] < -plane_margin if use_plane else torch.ones_like(mask)
    keep = mask & above

    sq = torch.sum(points * points, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (points @ points.T)
    d2 = torch.where(keep[None, :], d2, torch.full_like(d2, _BIG))
    d2 = d2 + torch.eye(p, dtype=d2.dtype, device=d2.device) * _BIG
    k_eff = min(knn, p)
    kth = torch.topk(d2, k_eff, dim=1, largest=False).values[:, -1]
    dk = torch.sqrt(torch.clamp(kth, min=0.0))
    dk_med = _nan0(nanmedian(torch.where(keep, dk, torch.nan)), 1.0)
    keep = keep & (dk <= 3.0 * dk_med)

    n_keep = torch.clamp(keep.sum(), min=1)
    center = torch.sum(torch.where(keep[:, None], points, torch.zeros_like(points)), dim=0) / n_keep
    d = torch.linalg.norm(points - center, dim=1)
    d_kept = torch.where(keep, d, torch.nan)
    med = _nan0(nanmedian(d_kept), 1.0)
    mad = _nan0(nanmedian(torch.abs(d_kept - med)), 0.5)
    return keep & (d <= med + 4.0 * mad)


def _fibonacci_directions(n: int) -> np.ndarray:
    """n roughly-uniform unit directions (Fibonacci sphere)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1
    ).astype(np.float32)


def _masked_bounds(points, mask):
    lo = torch.where(mask[:, None], points, torch.full_like(points, torch.inf)).amin(0)
    hi = torch.where(mask[:, None], points, torch.full_like(points, -torch.inf)).amax(0)
    return lo, hi


def _grid_centers(lo, extent, r):
    axis = (torch.arange(r, dtype=torch.float32, device=lo.device) + 0.5) / r
    grids = torch.meshgrid(lo[0] + axis * extent[0], lo[1] + axis * extent[1], lo[2] + axis * extent[2], indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, 3)


def _count_inside(centers, dirs, support, occupied=None, slab: int = 1 << 15):
    """Voxels with <v, d> <= h(d) + 1e-6 for every direction (and occupied)."""
    total = torch.zeros((), dtype=torch.int64, device=centers.device)
    for s in range(0, centers.shape[0], slab):
        inside = torch.all(centers[s : s + slab] @ dirs.T <= support[None, :] + 1e-6, dim=1)
        if occupied is not None:
            inside = inside & occupied[s : s + slab]
        total = total + inside.sum()
    return total


def convex_hull_volume(points, mask, resolution: int = 64, num_directions: int = 256, trim: int = 2):
    """Support-function hull volume of the masked points (trimmed support)."""
    dirs = torch.from_numpy(_fibonacci_directions(num_directions)).to(points.device)
    lo, hi = _masked_bounds(points, mask)
    extent = torch.clamp(hi - lo, min=1e-6)
    proj = torch.where(mask[:, None], points.to(torch.float32) @ dirs.T, torch.full((1,), -_BIG, device=points.device))
    k_eff = min(trim + 1, points.shape[0])
    support = torch.topk(proj.T, k_eff, dim=1).values[:, k_eff - 1]
    r = resolution
    centers = _grid_centers(lo, extent, r)
    return _count_inside(centers, dirs, support) * (torch.prod(extent) / r**3)


def maxpool_sep(g: torch.Tensor, r: int) -> torch.Tensor:
    """Binary dilation of (..., H, W) 0/1 grids by a (2r+1)^2 square, as
    two 1-D max passes (out-of-bounds never wins, like the reference's
    0-initialised reduce_window on 0/1 grids)."""
    shape = g.shape
    x = g.reshape(-1, 1, shape[-2], shape[-1])
    x = F.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))
    x = F.max_pool2d(x, (2 * r + 1, 1), stride=1, padding=(r, 0))
    return x.reshape(shape)


def erode_sep(g: torch.Tensor, r: int) -> torch.Tensor:
    """Binary erosion by a (2r+1)^2 square; out-of-bounds counts as set, so
    erosion never shrinks at the border (the reference's contract)."""
    return -maxpool_sep(-g, r)


def _carve_occupancy(points, mask, projections, proj_mask, image_size, resolution, dilation, grid_step, close_frac, vote_frac):
    """Voxel-carving occupancy over the item AABB. Returns (inside (R^3,)
    bool, centers (R^3, 3), voxel_vol, silhouettes (F, gh, gw))."""
    w, h = image_size
    f = projections.shape[0]
    device = points.device
    lo, hi = _masked_bounds(points, mask)
    pad = 0.1 * torch.clamp(hi - lo, min=1e-6)
    lo = lo - pad
    extent = torch.clamp(hi + pad - lo, min=1e-6)
    homog = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)

    gs = grid_step
    gw, gh = w // gs, h // gs
    rad = max(dilation // gs, 1)
    close_rad = max(round(close_frac * max(w, h)) // gs, 2 * rad)

    uvw = torch.einsum("pk,fjk->fpj", homog, projections)  # (F, P, 3)
    uv = uvw[..., :2] / torch.where(torch.abs(uvw[..., 2:3]) > 1e-9, uvw[..., 2:3], torch.ones_like(uvw[..., 2:3]))
    gx = torch.clamp((uv[..., 0] / gs).to(torch.int64), 0, gw - 1)
    gy = torch.clamp((uv[..., 1] / gs).to(torch.int64), 0, gh - 1)
    ok = mask[None, :] & (uvw[..., 2] > 1e-6)
    grid = torch.zeros((f, gh, gw), dtype=torch.float32, device=device)
    fi = torch.arange(f, device=device)[:, None].expand_as(gx)
    grid[fi[ok], gy[ok], gx[ok]] = 1.0
    sils = maxpool_sep(erode_sep(maxpool_sep(grid, close_rad), close_rad), rad)

    r = resolution
    centers = _grid_centers(lo, extent, r)
    votes = _silhouette_votes(centers, projections, proj_mask, sils, gs)
    n_active = torch.clamp(proj_mask.sum(), min=1)
    inside = votes >= torch.ceil(vote_frac * n_active)
    voxel_vol = torch.prod(extent) / r**3
    return inside, centers, voxel_vol, sils


def _silhouette_votes(pts, projections, proj_mask, sils, grid_step):
    """(P,) number of active views whose silhouette contains each point's
    projection (inactive views do not vote)."""
    gh, gw = sils.shape[1], sils.shape[2]
    homog = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    votes = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    for v in range(projections.shape[0]):
        uvw = homog @ projections[v].T
        z_ok = uvw[:, 2] > 1e-6
        uv = uvw[:, :2] / torch.where(z_ok[:, None], uvw[:, 2:3], torch.ones_like(uvw[:, 2:3]))
        gx = (uv[:, 0] / grid_step).to(torch.int64)
        gy = (uv[:, 1] / grid_step).to(torch.int64)
        in_img = z_ok & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
        val = sils[v][torch.clamp(gy, 0, gh - 1), torch.clamp(gx, 0, gw - 1)] > 0.5
        votes = votes + ((in_img & val) & proj_mask[v])
    return votes


def _points_in_silhouettes(points, projections, proj_mask, sils, grid_step, vote_frac):
    """(P,) mask: the point projects inside >= vote_frac of the active
    views' silhouettes (visual-hull membership per point)."""
    votes = _silhouette_votes(points, projections, proj_mask, sils, grid_step)
    n_active = torch.clamp(proj_mask.sum(), min=1)
    return votes >= torch.ceil(vote_frac * n_active)


def hull_and_carved_volume(
    points: torch.Tensor,
    mask: torch.Tensor,
    projections: torch.Tensor,
    proj_mask: torch.Tensor,
    image_size: Tuple[int, int],
    resolution: int = 64,
    num_directions: int = 512,
    trim: int = 7,
    dilation: int = 9,
    grid_step: int = 4,
    close_frac: float = 0.029,
    vote_frac: float = 0.8,
    support_mask: Optional[torch.Tensor] = None,
    trim_ref: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hull_volume, carved_volume) from one carve: the hull is the
    symmetric completion of the silhouette-pruned, trimmed support cloud
    intersected with the carve (see the reference's docstring for why
    neither half suffices alone)."""
    inside, centers, voxel_vol, sils = _carve_occupancy(
        points, mask, projections, proj_mask, image_size, resolution,
        dilation, grid_step, close_frac, vote_frac,
    )
    carve_vol = inside.sum() * voxel_vol
    dirs = torch.from_numpy(_fibonacci_directions(num_directions)).to(points.device)

    wocc = inside.to(torch.float32)
    nw = wocc.sum()
    pts_f = points.to(torch.float32)
    n_mask = torch.clamp(mask.sum(), min=1)
    pt_mean = torch.sum(torch.where(mask[:, None], pts_f, torch.zeros_like(pts_f)), dim=0) / n_mask
    occ_mean = torch.where(nw > 0, torch.sum(centers * wocc[:, None], dim=0) / torch.clamp(nw, min=1.0), pt_mean)

    smask = mask if support_mask is None else support_mask
    smask = smask & _points_in_silhouettes(points, projections, proj_mask, sils, grid_step, vote_frac)
    pproj = pts_f @ dirs.T
    k_eff = min(trim + 1, points.shape[0])
    neg_big = torch.full_like(pproj, -_BIG)
    top_hi = torch.topk(torch.where(smask[:, None], pproj, neg_big).T, k_eff, dim=1).values
    top_lo = torch.topk(torch.where(smask[:, None], -pproj, neg_big).T, k_eff, dim=1).values
    if trim_ref > 0:
        depth = torch.clamp((smask.sum() * trim) // trim_ref, 0, k_eff - 1)
    else:
        depth = torch.tensor(k_eff - 1, device=points.device)
    sup_seen = top_hi[:, depth]
    inf_seen = -top_lo[:, depth]
    support = torch.maximum(sup_seen, 2.0 * (occ_mean @ dirs.T) - inf_seen)

    hull_vol = _count_inside(centers, dirs, support, occupied=inside) * voxel_vol
    return hull_vol, carve_vol
