"""Batched DLT triangulation (torch twin of
``meatmodeler_tpu/geometry/triangulation.py``)."""

from __future__ import annotations

import torch

__all__ = ["triangulate_pairs", "triangulate_nview"]


def _dlt_solve(design: torch.Tensor) -> torch.Tensor:
    """Unit X minimising |design @ X| for (..., M, 4) designs: the smallest
    eigenvector of the 4x4 normal matrix, as in the reference."""
    ata = torch.einsum("...mi,...mj->...ij", design, design)
    _, vecs = torch.linalg.eigh(ata)
    return vecs[..., :, 0]


def triangulate_pairs(proj1, proj2, pts1, pts2) -> torch.Tensor:
    """Two-view DLT (``cv2.triangulatePoints`` semantics), dehomogenized."""

    def two_rows(proj, pt):
        r0 = pt[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]
        r1 = pt[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
        return torch.stack([r0, r1], dim=-2)

    design = torch.cat([two_rows(proj1, pts1), two_rows(proj2, pts2)], dim=-2)
    homog = _dlt_solve(design)
    return homog[..., :3] / homog[..., 3:4]


def triangulate_nview(
    projections: torch.Tensor, coords: torch.Tensor, obs_mask: torch.Tensor
) -> torch.Tensor:
    """Masked N-view DLT over the SoA track store.

    projections (F, 3, 4), coords (T, F, 2), obs_mask (T, F) -> (T, 3).
    Tracks with < 2 observations give garbage; callers gate on the count.
    """
    r0 = coords[..., 0:1] * projections[None, :, 2, :] - projections[None, :, 0, :]
    r1 = coords[..., 1:2] * projections[None, :, 2, :] - projections[None, :, 1, :]
    rows = torch.stack([r0, r1], dim=-2) * obs_mask[..., None, None]
    homog = _dlt_solve(rows.reshape(coords.shape[0], -1, 4))
    return homog[..., :3] / homog[..., 3:4]
