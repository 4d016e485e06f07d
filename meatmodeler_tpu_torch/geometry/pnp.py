"""Planar PnP, batched over frames (torch twin of
``meatmodeler_tpu/geometry/pnp.py``): closed-form homography init with both
planar twins, Gauss-Newton refinement of each, keep the lower-cost pose.
Points are already undistorted. On the card the refinement of every frame
and both twins is one launch of the hand-written kernel ``csrc/pnp.cu``
(``pnp_cuda``); on the CPU it is the plain version
(:func:`refine_pose_reference`)."""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from meatmodeler_tpu_torch.geometry import pnp_cuda, projection, so3
from meatmodeler_tpu_torch.geometry.homography import find_homography
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.utils.numerics import one_thread_at_a_time

__all__ = ["solve_pnp_planar", "refine_pose", "refine_pose_reference", "solve_pnp_batch"]


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
    """Gauss-Newton refinement (the ``SOLVEPNP_ITERATIVE`` functional) of
    one (6,) pose against (N, 3) object points and (N, 2) pixels, as the
    reference takes it, or of (F, 6) poses against (F, N, 2) pixels. One
    launch of the CUDA kernel (``pnp_cuda``) for tensors on the card, the
    plain version for tensors on the CPU."""
    if cuda_build.on_card(pose):
        single = pose.ndim == 1
        poses = pose.reshape(1, -1, 6)
        img = img_pts.reshape(-1, img_pts.shape[-2], 2)
        out, _ = pnp_cuda.pnp_refine(poses, obj_pts, img, intrinsics, iters, damping)
        return out[0, 0] if single else out[0]
    return refine_pose_reference(pose, obj_pts, img_pts, intrinsics, iters, damping)


def refine_pose_reference(pose, obj_pts, img_pts, intrinsics, iters: int = 10, damping: float = 1e-8):
    """The plain version of :func:`refine_pose`: each iteration a
    ``vmap(jacfwd)`` of the residual behind the forward-AD lock, the normal
    equations and a batched solve."""
    if pose.ndim == 1:
        return refine_pose_reference(pose[None], obj_pts, img_pts[None], intrinsics, iters, damping)[0]

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


def _cost(pose, obj_pts, img_pts, intrinsics):
    """(F,) sum |proj - img|^2 of (F, 6) poses against (F, N, 2) pixels."""
    proj = projection.project_points(obj_pts[None], pose[:, None, :], intrinsics)
    return torch.sum((proj - img_pts) ** 2, dim=(-2, -1))


def solve_pnp_batch(plane_uv, obj_cols, obj_pts, img_pts, intrinsics, iters: int = 10):
    """Planar init + GN refine for (F, N, 2) frames -> (F, 6) poses. On the
    card both twins of every frame refine in one launch, which also returns
    their costs."""
    init_a, init_b = solve_pnp_planar(plane_uv, obj_cols, img_pts, intrinsics)
    if cuda_build.on_card(img_pts):
        poses, cost = pnp_cuda.pnp_refine(torch.stack([init_a, init_b]), obj_pts, img_pts, intrinsics, iters)
        return torch.where((cost[0] <= cost[1])[:, None], poses[0], poses[1])
    pose_a = refine_pose_reference(init_a, obj_pts, img_pts, intrinsics, iters=iters)
    pose_b = refine_pose_reference(init_b, obj_pts, img_pts, intrinsics, iters=iters)
    better_a = _cost(pose_a, obj_pts, img_pts, intrinsics) <= _cost(pose_b, obj_pts, img_pts, intrinsics)
    return torch.where(better_a[:, None], pose_a, pose_b)
