"""The plain reference of the volume: which points are the item's, their
carved visual hull and the hull volume the program reports.

- Item points: of the gated points, those above the board plane (y below
  ``-margin``), whose distance to their ``knn``-th nearest gated
  neighbour is at most 3 times the median such distance, then those within
  the median plus 4 median absolute deviations of their centroid.
- Carve: over the item points' box padded by a tenth a side, a
  ``resolution``^3 voxel grid; each view splats the item points into a
  grid of ``grid_step`` px cells, closes it (dilate, erode) and dilates
  it; a voxel is kept where at least ``vote_frac`` of the views see it
  inside their silhouette.
- Hull: over ``num_directions`` Fibonacci directions, the support of the
  silhouette-confirmed item points trimmed to the ``depth``-th largest
  projection (``depth`` = points x ``trim`` // ``trim_ref``), completed
  symmetrically about the kept voxels' centroid; the volume is the kept
  voxels inside every support plane.

Medians of an even count are the mean of the two middle values. ``dtype``
is the float type of the arithmetic: float64 for the judgement, bfloat16
for the control. Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["item_mask", "hull_volume"]


def _median(x):
    v = torch.sort(x).values
    n = v.shape[0]
    return 0.5 * (v[(n - 1) // 2] + v[n // 2]) if n else None


def item_mask(points, mask, margin: float = 0.3, knn: int = 6, use_plane: bool = True):
    """(P,) item points of the gated ``points`` (P, 3) (``mask`` (P,))."""
    keep = mask & (points[:, 1] < -margin) if use_plane else mask.clone()
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(keep[None, :], d2, torch.full_like(d2, math.inf))
    d2.fill_diagonal_(math.inf)
    dk = torch.sqrt(torch.topk(d2, min(knn, points.shape[0]), dim=1, largest=False).values[:, -1])
    med = _median(dk[keep])
    keep = keep & (dk <= 3.0 * (med if med is not None else 1.0))
    n = max(int(keep.sum()), 1)
    centre = (points * keep[:, None]).sum(0) / n
    d = torch.linalg.norm(points - centre, dim=1)
    med = _median(d[keep])
    mad = _median((d[keep] - med).abs()) if med is not None else None
    med = med if med is not None else 1.0
    mad = mad if mad is not None else 0.5
    return keep & (d <= med + 4.0 * mad)


def _directions(n: int, dtype, device):
    i = torch.arange(n, dtype=torch.float64) + 0.5
    phi = torch.arccos(1 - 2 * i / n)
    theta = math.pi * (1 + 5**0.5) * i
    return torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)],
                       -1).to(dtype=dtype, device=device)


def _dilate(g, r: int):
    x = g[:, None]
    x = F.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))
    return F.max_pool2d(x, (2 * r + 1, 1), stride=1, padding=(r, 0))[:, 0]


def _project(points, projections):
    """(F, P, 2) pixels and (F, P) depths of points in each view."""
    homog = torch.cat([points, torch.ones_like(points[:, :1])], 1)
    uvw = torch.einsum("pk,fjk->fpj", homog, projections)
    z = uvw[..., 2]
    safe = torch.where(z.abs() > 1e-9, z, torch.ones_like(z))
    return uvw[..., :2] / safe[..., None], z


def _inside_silhouettes(points, projections, sils, step: int, vote_frac: float):
    """(P,) whether each point projects inside at least ``vote_frac`` of the
    views' silhouettes."""
    gh, gw = sils.shape[1:]
    uv, z = _project(points, projections)
    gx, gy = (uv[..., 0] / step).to(torch.int64), (uv[..., 1] / step).to(torch.int64)
    seen = (z > 1e-6) & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
    f = torch.arange(sils.shape[0], device=points.device)[:, None]
    val = sils[f, gy.clamp(0, gh - 1), gx.clamp(0, gw - 1)] > 0.5
    return (seen & val).sum(0) >= math.ceil(vote_frac * projections.shape[0])


def hull_volume(points, items, projections, image_size, resolution: int, num_directions: int, trim: int,
                trim_ref: int, dilation: int, grid_step: int, close_frac: float, vote_frac: float, dtype):
    """The hull volume of the item points ``items`` (P,) of ``points``
    (P, 3) seen by ``projections`` (F, 3, 4) in images of ``image_size``
    (W, H), in ``dtype`` (see the module's docstring)."""
    points, projections = points.to(dtype), projections.to(dtype)
    device = points.device
    w, h = image_size
    item_pts = points[items]
    lo, hi = item_pts.min(0).values, item_pts.max(0).values
    pad = 0.1 * torch.clamp(hi - lo, min=1e-6)
    lo = lo - pad
    extent = torch.clamp(hi + pad - lo, min=1e-6)

    # Silhouettes: splat, close, dilate.
    gw, gh = w // grid_step, h // grid_step
    rad = max(dilation // grid_step, 1)
    close = max(round(close_frac * max(w, h)) // grid_step, 2 * rad)
    uv, z = _project(item_pts, projections)
    gx = (uv[..., 0] / grid_step).to(torch.int64).clamp(0, gw - 1)
    gy = (uv[..., 1] / grid_step).to(torch.int64).clamp(0, gh - 1)
    ok = z > 1e-6
    f = torch.arange(projections.shape[0], device=device)[:, None].expand_as(gx)
    grid = torch.zeros(projections.shape[0], gh, gw, dtype=torch.float32, device=device)
    grid[f[ok], gy[ok], gx[ok]] = 1.0
    sils = _dilate(-_dilate(-_dilate(grid, close), close), rad)

    # Voxels kept by the views' votes.
    axis = (torch.arange(resolution, dtype=dtype, device=device) + 0.5) / resolution
    cx, cy, cz = torch.meshgrid(lo[0] + axis * extent[0], lo[1] + axis * extent[1], lo[2] + axis * extent[2],
                                indexing="ij")
    centres = torch.stack([cx, cy, cz], -1).reshape(-1, 3)
    kept = torch.zeros(centres.shape[0], dtype=torch.bool, device=device)
    for s in range(0, centres.shape[0], 1 << 15):
        kept[s : s + (1 << 15)] = _inside_silhouettes(centres[s : s + (1 << 15)], projections, sils, grid_step,
                                                       vote_frac)

    # Trimmed, symmetrically completed support.
    dirs = _directions(num_directions, dtype, device)
    support_pts = points[items & _inside_silhouettes(points, projections, sils, grid_step, vote_frac)]
    proj = support_pts @ dirs.T  # (S, D)
    k = min(trim + 1, points.shape[0])
    depth = min((support_pts.shape[0] * trim) // trim_ref, k - 1) if trim_ref > 0 else k - 1
    depth = min(depth, support_pts.shape[0] - 1)
    sup = torch.sort(proj, dim=0, descending=True).values[depth]
    inf = torch.sort(proj, dim=0).values[depth]
    centre = centres[kept].mean(0) if bool(kept.any()) else item_pts.mean(0)
    support = torch.maximum(sup, 2.0 * (centre @ dirs.T) - inf)
    inside = torch.zeros_like(kept)
    for s in range(0, centres.shape[0], 1 << 15):
        inside[s : s + (1 << 15)] = torch.all(centres[s : s + (1 << 15)] @ dirs.T <= support[None, :] + 1e-6, dim=1)
    return float((inside & kept).sum()) * float(extent.double().prod()) / resolution**3
