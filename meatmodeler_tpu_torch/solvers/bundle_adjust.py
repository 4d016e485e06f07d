"""Schur-complement Levenberg-Marquardt bundle adjustment (torch twin of
``meatmodeler_tpu/solvers/bundle_adjust.py``).

Same algorithm as the reference: per-observation Jacobians by forward-mode
AD, block-diagonal U (F,6,6) / V (P,3,3), point elimination through the
dense (P, F*6, 3) strip, a dense reduced camera solve, back-substitution,
and the Marquardt-damped LM loop with the reference's ftol rule. The loop is
a Python loop that reads one flag back per iteration. Problems are solved
at their exact shapes: the reference's bucket padding exists only so XLA
compiles once, and its padded rows are masked out, so the trajectory is the
same. One device holds the whole problem; the reference's point-sharded
multi-device solve is not part of this package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from meatmodeler_tpu.config import SolverConfig
from meatmodeler_tpu_torch.geometry import projection

__all__ = ["BAProblem", "BAResult", "solve_ba", "adjust_points", "adjust_pose"]


class BAProblem(NamedTuple):
    """Flat observation-list BA problem."""

    cam_params: torch.Tensor  # (F, 6) [rvec, tvec] per frame
    points: torch.Tensor  # (P, 3)
    intrinsics: torch.Tensor  # (3, 3)
    obs: torch.Tensor  # (N, 2) observed pixels
    frame_idx: torch.Tensor  # (N,) int64
    point_idx: torch.Tensor  # (N,) int64
    mask: torch.Tensor  # (N,) bool
    weight: Optional[torch.Tensor] = None  # (N,) residual weights (1/sigma)


class BAResult(NamedTuple):
    cam_params: torch.Tensor  # (F, 6)
    points: torch.Tensor  # (P, 3)
    cost: torch.Tensor  # final 0.5 * sum r^2 over valid obs
    rmse: torch.Tensor  # unweighted reprojection RMSE in pixels
    iterations: int
    final_lambda: torch.Tensor


def _residuals(cam, pts, intrinsics, obs, fidx, pidx, mask, weight=None):
    r = (projection.project_points(pts[pidx], cam[fidx], intrinsics) - obs) * mask[:, None]
    if weight is not None:
        r = r * weight[:, None]
    return r


def _obs_jacobians(cam, pts, intrinsics, obs, fidx, pidx, mask, weight=None):
    """Per-observation residual Jacobians: (N,2,6) wrt camera, (N,2,3) wrt point."""

    def res(c, p, ob):
        return projection.project_points(p[None], c[None], intrinsics)[0] - ob

    jc, jp = vmap(jacfwd(res, argnums=(0, 1)))(cam[fidx], pts[pidx], obs)
    m = mask.to(jc.dtype)[:, None, None]
    if weight is not None:
        m = m * weight[:, None, None]
    return jc * m, jp * m


def _segment_sum(x, idx, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _solve_normal_equations(problem: BAProblem, lam, jc, jp, r, fix_points: bool = False):
    """One damped Gauss-Newton step via the Schur complement.

    Returns (delta_cam (F,6), delta_pt (P,3)). ``fix_points`` (the pose-only
    problem): W = V = 0, the camera system is block-diagonal and
    delta_p = 0 exactly.
    """
    f = problem.cam_params.shape[0]
    p = problem.points.shape[0]
    fidx, pidx = problem.frame_idx, problem.point_idx
    u = _segment_sum(torch.einsum("nri,nrj->nij", jc, jc), fidx, f)
    b_c = -_segment_sum(torch.einsum("nri,nr->ni", jc, r), fidx, f)
    eye6 = torch.eye(6, dtype=u.dtype, device=u.device)
    u_d = u + lam * (u * eye6 + 1e-8 * eye6)
    # Unobserved cameras: identity block, so their rows decouple and solve to 0.
    u_trace = torch.einsum("fii->f", u)
    u_d = torch.where((u_trace < 1e-12)[:, None, None], eye6, u_d)
    if fix_points:
        delta_c = torch.linalg.solve(u_d, b_c[..., None])[..., 0]
        return delta_c, torch.zeros_like(problem.points)

    v = _segment_sum(torch.einsum("nri,nrj->nij", jp, jp), pidx, p)
    w = torch.einsum("nri,nrj->nij", jc, jp)  # (N, 6, 3)
    b_p = -_segment_sum(torch.einsum("nri,nr->ni", jp, r), pidx, p)
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    v_d = v + lam * (v * eye3 + 1e-8 * eye3)
    # Degeneracy on the UNDAMPED trace (see the reference's note).
    v_trace = v[:, 0, 0] + v[:, 1, 1] + v[:, 2, 2]
    v_d = torch.where((v_trace < 1e-12)[:, None, None], eye3, v_d)
    v_inv = torch.linalg.inv(v_d)

    # Dense per-point camera strip A_p (P, F*6, 3); S = blkdiag(U) - sum_p A_p V_p^-1 A_p^T.
    a = torch.zeros((p, f, 6, 3), dtype=w.dtype, device=w.device)
    a.index_put_((pidx, fidx), w, accumulate=True)
    a_flat = a.reshape(p, f * 6, 3)
    b_strip = torch.einsum("pak,pkl->pal", a_flat, v_inv)
    s_cross = torch.einsum("pak,pbk->ab", b_strip, a_flat)
    s = torch.block_diag(*u_d.unbind(0)) - s_cross

    y = torch.einsum("nij,njk->nik", w, v_inv[pidx])
    red = _segment_sum(torch.einsum("nij,nj->ni", y, b_p[pidx]), fidx, f)
    rhs = (b_c - red).reshape(f * 6)
    delta_c = torch.linalg.solve(s, rhs).reshape(f, 6)

    wt_dc = _segment_sum(torch.einsum("nij,ni->nj", w, delta_c[fidx]), pidx, p)
    delta_p = torch.einsum("pij,pj->pi", v_inv, b_p - wt_dc)
    return delta_c, delta_p


def _cost(problem, cam, pts):
    r = _residuals(
        cam, pts, problem.intrinsics, problem.obs, problem.frame_idx,
        problem.point_idx, problem.mask, problem.weight,
    )
    return 0.5 * torch.sum(r * r)


def solve_ba(
    problem: BAProblem,
    config: SolverConfig = SolverConfig(),
    fix_points: bool = False,
) -> BAResult:
    """Schur-complement LM until the ftol rule fires or max_iters."""
    dtype = torch.promote_types(
        torch.promote_types(problem.cam_params.dtype, problem.points.dtype),
        torch.promote_types(problem.obs.dtype, problem.intrinsics.dtype),
    )
    problem = problem._replace(
        cam_params=problem.cam_params.to(dtype),
        points=problem.points.to(dtype),
        intrinsics=problem.intrinsics.to(dtype),
        obs=problem.obs.to(dtype),
        weight=None if problem.weight is None else problem.weight.to(dtype),
    )
    device = problem.cam_params.device
    n_valid = torch.clamp(problem.mask.sum(), min=1)
    lam_up2 = config.lambda_up * config.lambda_up

    cam, pts = problem.cam_params, problem.points
    cost = _cost(problem, cam, pts)
    lam = torch.tensor(config.init_lambda, dtype=dtype, device=device)
    it = 0
    while it < config.max_iters:
        r = _residuals(
            cam, pts, problem.intrinsics, problem.obs, problem.frame_idx,
            problem.point_idx, problem.mask, problem.weight,
        )
        jc, jp = _obs_jacobians(
            cam, pts, problem.intrinsics, problem.obs, problem.frame_idx,
            problem.point_idx, problem.mask, problem.weight,
        )

        def attempt(lam_try):
            dc, dp = _solve_normal_equations(
                problem._replace(cam_params=cam, points=pts), lam_try, jc, jp, r,
                fix_points=fix_points,
            )
            return cam + dc, pts + dp, _cost(problem, cam + dc, pts + dp)

        c1_cam, c1_pts, c1 = attempt(lam)
        c2_cam, c2_pts, c2 = attempt(lam * lam_up2)
        use1 = c1 <= c2
        cand_cam = torch.where(use1, c1_cam, c2_cam)
        cand_pts = torch.where(use1, c1_pts, c2_pts)
        cand_cost = torch.where(use1, c1, c2)
        cand_lam = torch.where(use1, lam * config.lambda_down, lam * lam_up2)

        improved = cand_cost < cost
        new_cost = torch.where(improved, cand_cost, cost)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        done = (improved & (rel < config.ftol)) | (~improved & (lam >= 1e10))
        cam = torch.where(improved, cand_cam, cam)
        pts = torch.where(improved, cand_pts, pts)
        lam = torch.clamp(torch.where(improved, cand_lam, lam * lam_up2), 1e-12, 1e12)
        cost = new_cost
        it += 1
        if bool(done):  # the one host read per iteration
            break

    r_px = _residuals(
        cam, pts, problem.intrinsics, problem.obs, problem.frame_idx,
        problem.point_idx, problem.mask,
    )
    rmse = torch.sqrt(torch.sum(r_px * r_px) / n_valid)
    return BAResult(cam, pts, cost, rmse, it, lam)


def _check_one_device(n_p: int, n_f: int, config: SolverConfig, itemsize: int) -> None:
    """The reference shards points across devices on request, or when the
    dense Schur strip outgrows ``hbm_strip_budget_bytes``; this package
    solves on one device and refuses, with the numbers, what would need more."""
    if config.point_shard_devices > 1:
        raise ValueError(
            f"solver.point_shard_devices={config.point_shard_devices}: the "
            "multi-device point-sharded solve is not available in this package"
        )
    if config.hbm_strip_budget_bytes > 0:
        strip_bytes = 2 * n_p * n_f * 18 * itemsize
        if strip_bytes > config.hbm_strip_budget_bytes:
            raise ValueError(
                f"BA problem too large for one device: the dense Schur strip "
                f"over {n_p} points x {n_f} cameras is ~{strip_bytes / 2**20:.1f} "
                f"MiB, above hbm_strip_budget_bytes="
                f"{config.hbm_strip_budget_bytes / 2**20:.1f} MiB; raise the "
                "budget or reduce the problem"
            )


def adjust_points(
    extrinsics,
    intrinsics,
    points_3d,
    points_2d,
    frame_indices,
    point_indices,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, BAResult]:
    """Full BA over cameras and points. Returns refined (P, 3) points,
    (F, 4, 4) homogeneous extrinsics and the solver stats."""
    device = extrinsics.device
    points_3d = points_3d.reshape(-1, 3)
    points_2d = points_2d.reshape(-1, 2)
    frame_indices = torch.as_tensor(frame_indices, device=device).long()
    point_indices = torch.as_tensor(point_indices, device=device).long()
    _check_one_device(
        points_3d.shape[0], extrinsics.shape[0], config,
        torch.promote_types(points_3d.dtype, torch.float32).itemsize,
    )
    if mask is None:
        mask = torch.ones(points_2d.shape[0], dtype=torch.bool, device=device)
    problem = BAProblem(
        cam_params=projection.params_from_extrinsics(extrinsics),
        points=points_3d,
        intrinsics=intrinsics,
        obs=points_2d,
        frame_idx=frame_indices,
        point_idx=point_indices,
        mask=mask,
        weight=weights,
    )
    result = solve_ba(problem, config=config)
    new_ext = projection.extrinsics_from_params(result.cam_params, homogeneous=True)
    return result.points, new_ext, result


def _chessboard_xz(pattern, side_length, dtype, device):
    """The reference's pose-BA board: X-Z plane, y = 0."""
    x, y = pattern
    gx, gy = torch.meshgrid(
        torch.arange(x, dtype=dtype, device=device) * side_length,
        torch.arange(y, dtype=dtype, device=device) * side_length,
        indexing="xy",
    )
    zero = torch.zeros_like(gx.reshape(-1))
    return torch.stack([gx.reshape(-1), zero, gy.reshape(-1)], dim=-1)


def adjust_pose(
    extrinsics,
    intrinsics,
    points_2d,
    pattern: Tuple[int, int] = (4, 3),
    side_length: float = 2.0,
    config: SolverConfig = SolverConfig(),
) -> Tuple[torch.Tensor, BAResult]:
    """Pose-only BA against the known X-Z chessboard: ``points_2d`` is F
    stacked copies of the board corners. Returns (F, 3, 4) extrinsics."""
    f = extrinsics.shape[0]
    points_2d = points_2d.reshape(-1, 2)
    n = points_2d.shape[0] // f
    device = extrinsics.device
    board = _chessboard_xz(pattern, side_length, points_2d.dtype, device)[:n]
    problem = BAProblem(
        cam_params=projection.params_from_extrinsics(extrinsics),
        points=board,
        intrinsics=intrinsics,
        obs=points_2d,
        frame_idx=torch.arange(f, device=device).repeat_interleave(n),
        point_idx=torch.arange(n, device=device).repeat(f),
        mask=torch.ones(points_2d.shape[0], dtype=torch.bool, device=device),
    )
    result = solve_ba(problem, config=config, fix_points=True)
    return projection.extrinsics_from_params(result.cam_params), result
