"""Planar PnP, batched over frames (torch twin of
``meatmodeler_tpu/geometry/pnp.py``): closed-form homography init with both
planar twins, Gauss-Newton refinement of each, keep the lower-cost pose.
Points are already undistorted."""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from meatmodeler_tpu_torch.geometry import projection, so3
from meatmodeler_tpu_torch.geometry.homography import find_homography
from meatmodeler_tpu_torch.utils.numerics import one_thread_at_a_time

__all__ = ["solve_pnp_planar", "refine_pose", "solve_pnp_batch"]


def _orthonormalize(r: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) near-rotations onto SO(3) via SVD (Procrustes)."""
    u, _, vt = torch.linalg.svd(r)
    d = torch.linalg.det(u @ vt)
    fix = torch.ones(r.shape[:-2] + (3,), dtype=r.dtype, device=r.device)
    fix = torch.cat([fix[..., :2], d[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt


def solve_pnp_planar(plane_uv, obj_cols, img_pts, intrinsics):
    """Both planar-pose twins from the image-to-plane homography.

    plane_uv (N, 2), img_pts (F, N, 2) -> two (F, 6) pose batches; the
    second tilts the board the other way (Schweighofer-Pinz ambiguity).
    """
    h = find_homography(plane_uv, img_pts)
    m = torch.linalg.solve(intrinsics, h)  # K^-1 H = s [r_a r_b t]
    scale = 0.5 * (torch.linalg.norm(m[..., :, 0], dim=-1) + torch.linalg.norm(m[..., :, 1], dim=-1))
    m = m / torch.clamp(scale, min=1e-12)[..., None, None]
    m = m * torch.where(m[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    r_a, r_b, tvec = m[..., :, 0], m[..., :, 1], m[..., :, 2]

    a, b = obj_cols
    c = 3 - a - b
    perm_sign = 1.0 if (a, b, c) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0

    def complete(ra, rb):
        cols = [None, None, None]
        cols[a] = ra
        cols[b] = rb
        cols[c] = perm_sign * torch.linalg.cross(ra, rb, dim=-1)
        return _orthonormalize(torch.stack(cols, dim=-1))

    flip = torch.tensor([1.0, 1.0, -1.0], dtype=m.dtype, device=m.device)
    rot = complete(r_a, r_b)
    rot2 = complete(r_a * flip, r_b * flip)
    return (
        torch.cat([so3.log(rot), tvec], dim=-1),
        torch.cat([so3.log(rot2), tvec], dim=-1),
    )


def refine_pose(pose, obj_pts, img_pts, intrinsics, iters: int = 10, damping: float = 1e-8):
    """Gauss-Newton refinement of (F, 6) poses against (N, 3) object points
    and (F, N, 2) pixels (the ``SOLVEPNP_ITERATIVE`` functional)."""

    def residual(p, img):
        return (projection.project_points(obj_pts, p[None, :], intrinsics) - img).reshape(-1)

    jac_fn = one_thread_at_a_time(vmap(jacfwd(residual, argnums=0)))
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    for _ in range(iters):
        r = vmap(residual)(pose, img_pts)  # (F, 2N)
        jac = jac_fn(pose, img_pts)  # (F, 2N, 6)
        jt = jac.transpose(-1, -2)
        jtj = jt @ jac + damping * eye
        jtr = (jt @ r[..., None])[..., 0]
        pose = pose - torch.linalg.solve(jtj, jtr)
    return pose


def solve_pnp_batch(plane_uv, obj_cols, obj_pts, img_pts, intrinsics, iters: int = 10):
    """Planar init + GN refine for (F, N, 2) frames -> (F, 6) poses."""
    init_a, init_b = solve_pnp_planar(plane_uv, obj_cols, img_pts, intrinsics)
    pose_a = refine_pose(init_a, obj_pts, img_pts, intrinsics, iters=iters)
    pose_b = refine_pose(init_b, obj_pts, img_pts, intrinsics, iters=iters)

    def cost(p):
        proj = projection.project_points(obj_pts[None], p[:, None, :], intrinsics)
        return torch.sum((proj - img_pts) ** 2, dim=(-2, -1))

    return torch.where((cost(pose_a) <= cost(pose_b))[:, None], pose_a, pose_b)
