"""Pinhole projection and extrinsic packing (torch twin of
``meatmodeler_tpu/geometry/projection.py``)."""

from __future__ import annotations

import torch

from meatmodeler_tpu_torch.geometry import so3

__all__ = [
    "rotate_points",
    "project_points",
    "params_from_extrinsics",
    "extrinsics_from_params",
    "projection_from_extrinsic",
]


def rotate_points(points: torch.Tensor, rvecs: torch.Tensor) -> torch.Tensor:
    """Rodrigues-rotate each (..., 3) point by its broadcast (..., 3) rvec.

    Smooth through the identity (every use of theta has a Taylor branch and
    the sqrt is guarded inside), so the BA Jacobian stays finite at the
    anchor camera — see the reference's note on the two NaN traps.
    """
    points, rvecs = torch.broadcast_tensors(points, rvecs)
    theta_sq = torch.sum(rvecs * rvecs, dim=-1, keepdim=True)
    small = theta_sq < 1e-12
    safe_theta_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_theta = torch.sqrt(safe_theta_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta_sq
    )
    cos_theta = torch.where(
        small, 1.0 - theta_sq / 2.0 + theta_sq * theta_sq / 24.0, torch.cos(safe_theta)
    )
    cross = torch.linalg.cross(rvecs, points, dim=-1)
    dot = torch.sum(points * rvecs, dim=-1, keepdim=True)
    return cos_theta * points + a * cross + b * dot * rvecs


def project_points(
    points: torch.Tensor, cam_params: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Rotate, translate, apply K, perspective-divide: (..., 3) -> (..., 2)."""
    cam = rotate_points(points, cam_params[..., :3]) + cam_params[..., 3:6]
    homog = torch.einsum("ij,...j->...i", intrinsics, cam)
    return homog[..., :2] / homog[..., 2:3]


def params_from_extrinsics(extrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) [R|t] -> (..., 6) [rvec, tvec]."""
    return torch.cat([so3.log(extrinsics[..., :3, :3]), extrinsics[..., :3, 3]], dim=-1)


def extrinsics_from_params(params: torch.Tensor, homogeneous: bool = False) -> torch.Tensor:
    """(..., 6) -> (..., 3, 4), or (..., 4, 4) with ``homogeneous``."""
    ext = torch.cat([so3.exp(params[..., :3]), params[..., 3:6, None]], dim=-1)
    if homogeneous:
        bottom = torch.zeros_like(ext[..., :1, :])
        bottom[..., 0, 3] = 1.0
        ext = torch.cat([ext, bottom], dim=-2)
    return ext


def projection_from_extrinsic(intrinsics: torch.Tensor, extrinsic: torch.Tensor) -> torch.Tensor:
    """P = K @ [R|t] for (..., 3, 4) extrinsics."""
    return torch.einsum("ij,...jk->...ik", intrinsics, extrinsic[..., :3, :])
