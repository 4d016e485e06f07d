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

from meatmodeler_tpu_torch.config import SolverConfig
from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.utils.numerics import one_thread_at_a_time

__all__ = ["BAProblem", "BAResult", "solve_ba", "solve_ba_batch", "adjust_points", "adjust_pose", "pose_only_refine"]


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

    jc, jp = one_thread_at_a_time(vmap(jacfwd(res, argnums=(0, 1))))(cam[fidx], pts[pidx], obs)
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
    delta_p = 0 exactly; there ``lam`` may hold one damping per camera.
    """
    f = problem.cam_params.shape[0]
    p = problem.points.shape[0]
    fidx, pidx = problem.frame_idx, problem.point_idx
    u = _segment_sum(torch.einsum("nri,nrj->nij", jc, jc), fidx, f)
    b_c = -_segment_sum(torch.einsum("nri,nr->ni", jc, r), fidx, f)
    eye6 = torch.eye(6, dtype=u.dtype, device=u.device)
    lam = lam if lam.ndim == 0 else lam[:, None, None]  # one damping, or one per camera
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


def _canonical(problem: BAProblem) -> BAProblem:
    """One float dtype for every float field (mixed f32/f64 inputs)."""
    dtype = torch.promote_types(
        torch.promote_types(problem.cam_params.dtype, problem.points.dtype),
        torch.promote_types(problem.obs.dtype, problem.intrinsics.dtype),
    )
    return problem._replace(
        cam_params=problem.cam_params.to(dtype),
        points=problem.points.to(dtype),
        intrinsics=problem.intrinsics.to(dtype),
        obs=problem.obs.to(dtype),
        weight=None if problem.weight is None else problem.weight.to(dtype),
    )


def _lm_decision(config: SolverConfig, cost, lam, c1, c2):
    """The LM acceptance rule, elementwise over problems: of the two trial
    steps (damping ``lam`` and ``lam * lambda_up**2``) take the cheaper; keep
    it if it lowers the cost. Returns (use the first trial, improved, new
    cost, new damping, done by the ftol rule or an exploded damping)."""
    lam_up2 = config.lambda_up * config.lambda_up
    use1 = c1 <= c2
    cand_cost = torch.where(use1, c1, c2)
    cand_lam = torch.where(use1, lam * config.lambda_down, lam * lam_up2)
    improved = cand_cost < cost
    new_cost = torch.where(improved, cand_cost, cost)
    rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
    done = (improved & (rel < config.ftol)) | (~improved & (lam >= 1e10))
    new_lam = torch.clamp(torch.where(improved, cand_lam, lam * lam_up2), 1e-12, 1e12)
    return use1, improved, new_cost, new_lam, done


def solve_ba(
    problem: BAProblem,
    config: SolverConfig = SolverConfig(),
    fix_points: bool = False,
    init_lambda=None,
) -> BAResult:
    """Schur-complement LM until the ftol rule fires or max_iters.

    ``init_lambda``: optional damping to start from instead of
    ``config.init_lambda`` (a float or a 0-d tensor, read on the device):
    warm-starting a grown prefix of the same problem from the previous
    solve's ``final_lambda`` skips the damping walk-down.
    """
    problem = _canonical(problem)
    n_valid = torch.clamp(problem.mask.sum(), min=1)
    cam, pts = problem.cam_params, problem.points
    cost = _cost(problem, cam, pts)
    lam = torch.as_tensor(
        config.init_lambda if init_lambda is None else init_lambda, dtype=cam.dtype, device=cam.device
    )
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
        c2_cam, c2_pts, c2 = attempt(lam * config.lambda_up**2)
        use1, improved, cost, new_lam, done = _lm_decision(config, cost, lam, c1, c2)
        cam = torch.where(improved, torch.where(use1, c1_cam, c2_cam), cam)
        pts = torch.where(improved, torch.where(use1, c1_pts, c2_pts), pts)
        lam = new_lam
        it += 1
        if bool(done):  # the one host read per iteration
            break

    r_px = _residuals(
        cam, pts, problem.intrinsics, problem.obs, problem.frame_idx,
        problem.point_idx, problem.mask,
    )
    rmse = torch.sqrt(torch.sum(r_px * r_px) / n_valid)
    return BAResult(cam, pts, cost, rmse, it, lam)


def _solve_normal_equations_batch(problem: BAProblem, lam, jc, jp, r):
    """:func:`_solve_normal_equations` for (V,) independent problems
    stacked on a leading lane axis, each with its own damping ``lam`` (V,).
    Frames and points are numbered per lane (lane * F + f) so one segment
    sum serves every lane; each lane has its own (P, F*6, 3) strip and
    (6F, 6F) reduced system. Unobserved (padded) cameras and points get
    identity blocks and solve to 0. The ``_ex`` solves leave a singular
    lane's step non-finite instead of raising or reading back."""
    nv, f = problem.cam_params.shape[:2]
    p = problem.points.shape[1]
    lane = torch.arange(nv, device=jc.device)[:, None]
    fidx = (lane * f + problem.frame_idx).reshape(-1)
    pidx = (lane * p + problem.point_idx).reshape(-1)
    jc, jp, r = jc.reshape(-1, 2, 6), jp.reshape(-1, 2, 3), r.reshape(-1, 2)
    u = _segment_sum(torch.einsum("nri,nrj->nij", jc, jc), fidx, nv * f).reshape(nv, f, 6, 6)
    b_c = -_segment_sum(torch.einsum("nri,nr->ni", jc, r), fidx, nv * f).reshape(nv, f, 6)
    v = _segment_sum(torch.einsum("nri,nrj->nij", jp, jp), pidx, nv * p).reshape(nv, p, 3, 3)
    b_p = -_segment_sum(torch.einsum("nri,nr->ni", jp, r), pidx, nv * p)
    w = torch.einsum("nri,nrj->nij", jc, jp)  # (V*N, 6, 3)
    lam = lam[:, None, None, None]
    eye6 = torch.eye(6, dtype=u.dtype, device=u.device)
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    u_d = u + lam * (u * eye6 + 1e-8 * eye6)
    u_d = torch.where((torch.einsum("vfii->vf", u) < 1e-12)[..., None, None], eye6, u_d)
    v_d = v + lam * (v * eye3 + 1e-8 * eye3)
    v_trace = v[..., 0, 0] + v[..., 1, 1] + v[..., 2, 2]
    v_d = torch.where((v_trace < 1e-12)[..., None, None], eye3, v_d)
    v_inv = torch.linalg.inv_ex(v_d)[0].reshape(nv * p, 3, 3)

    a = torch.zeros((nv * p, f, 6, 3), dtype=w.dtype, device=w.device)
    a.index_put_((pidx, problem.frame_idx.reshape(-1)), w, accumulate=True)
    a_flat = a.reshape(nv, p, f * 6, 3)
    b_strip = torch.einsum("vpak,vpkl->vpal", a_flat, v_inv.reshape(nv, p, 3, 3))
    s_cross = torch.einsum("vpak,vpbk->vab", b_strip, a_flat)
    eye_f = torch.eye(f, dtype=u.dtype, device=u.device)
    s = torch.einsum("vfij,fg->vfigj", u_d, eye_f).reshape(nv, f * 6, f * 6) - s_cross

    y = torch.einsum("nij,njk->nik", w, v_inv[pidx])
    red = _segment_sum(torch.einsum("nij,nj->ni", y, b_p[pidx]), fidx, nv * f).reshape(nv, f, 6)
    rhs = (b_c - red).reshape(nv, f * 6)
    delta_c = torch.linalg.solve_ex(s, rhs)[0].reshape(nv, f, 6)

    wt_dc = _segment_sum(torch.einsum("nij,ni->nj", w, delta_c.reshape(-1, 6)[fidx]), pidx, nv * p)
    delta_p = torch.einsum("pij,pj->pi", v_inv, b_p - wt_dc).reshape(nv, p, 3)
    return delta_c, delta_p


def solve_ba_batch(problem: BAProblem, config: SolverConfig = SolverConfig()) -> BAResult:
    """(V,) independent problems stacked on a leading axis and padded to
    common (F, P, N) — the reference's ``jax.vmap(solve_ba)`` over padded
    problems (``parallel/batch.py``). Every field carries the lane axis
    (``intrinsics`` (V, 3, 3)); padded observations are masked, padded
    cameras and points unobserved. Each lane keeps its own damping, cost,
    iteration count and stop, and a finished lane is frozen, as under
    ``vmap`` of one ``while_loop``; the loop reads one "any lane active"
    flag per iteration. ``iterations`` and the other result fields are
    per lane."""
    problem = _canonical(problem)
    nv, f = problem.cam_params.shape[:2]
    _check_one_device(problem.points.shape[1], f, config, problem.points.dtype.itemsize)
    residuals = vmap(_residuals)
    jacobians = vmap(_obs_jacobians)
    fixed = (problem.intrinsics, problem.obs, problem.frame_idx, problem.point_idx, problem.mask)
    weighted = fixed if problem.weight is None else fixed + (problem.weight,)

    def costs(cam, pts):  # (V,) 0.5 * sum r^2 per lane
        r = residuals(cam, pts, *weighted)
        return 0.5 * torch.sum(r * r, dim=(1, 2))

    cam, pts = problem.cam_params, problem.points
    cost = costs(cam, pts)
    lam = torch.full((nv,), config.init_lambda, dtype=cam.dtype, device=cam.device)
    it = torch.zeros(nv, dtype=torch.int64, device=cam.device)
    active = torch.full((nv,), config.max_iters > 0, dtype=torch.bool, device=cam.device)
    while config.max_iters > 0:
        r = residuals(cam, pts, *weighted)
        jc, jp = jacobians(cam, pts, *weighted)

        def attempt(lam_try):
            dc, dp = _solve_normal_equations_batch(problem._replace(cam_params=cam, points=pts), lam_try, jc, jp, r)
            return cam + dc, pts + dp, costs(cam + dc, pts + dp)

        c1_cam, c1_pts, c1 = attempt(lam)
        c2_cam, c2_pts, c2 = attempt(lam * config.lambda_up**2)
        use1, improved, new_cost, new_lam, done = _lm_decision(config, cost, lam, c1, c2)
        # Lanes that have stopped keep their state.
        step = (active & improved)[:, None, None]
        cam = torch.where(step, torch.where(use1[:, None, None], c1_cam, c2_cam), cam)
        pts = torch.where(step, torch.where(use1[:, None, None], c1_pts, c2_pts), pts)
        cost = torch.where(active, new_cost, cost)
        lam = torch.where(active, new_lam, lam)
        it = it + active.to(torch.int64)
        active = active & ~done & (it < config.max_iters)
        if not bool(active.any()):  # the one host read per iteration
            break

    r_px = residuals(cam, pts, *fixed)
    rmse = torch.sqrt(torch.sum(r_px * r_px, dim=(1, 2)) / torch.clamp(problem.mask.sum(1), min=1))
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
    init_lambda=None,
) -> Tuple[torch.Tensor, torch.Tensor, BAResult]:
    """Full BA over cameras and points. Returns refined (P, 3) points,
    (F, 4, 4) homogeneous extrinsics and the solver stats.
    ``init_lambda``: optional damping warm start (see :func:`solve_ba`)."""
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
    result = solve_ba(problem, config=config, init_lambda=init_lambda)
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


def pose_only_refine(
    cam_params: torch.Tensor,
    points_3d: torch.Tensor,
    intrinsics: torch.Tensor,
    obs: torch.Tensor,
    mask: torch.Tensor,
    config: SolverConfig = SolverConfig(),
) -> torch.Tensor:
    """(B,) independent 6-dof LM pose solves against fixed points, batched.

    ``cam_params`` (B, 6); ``points_3d`` (B, N, 3), ``obs`` (B, N, 2) and
    ``mask`` (B, N) per problem. Each problem keeps its own damping, cost
    and stop, as the reference's ``vmap`` of one ``while_loop`` does: every
    iteration steps all problems and freezes those already done, and the
    loop ends when none is left (one host read per iteration). Folding them
    into one joint solve would stop them all at the same point.
    """
    b, n = obs.shape[:2]
    device = obs.device
    problem = _canonical(
        BAProblem(
            cam_params=cam_params,
            points=points_3d.reshape(-1, 3),
            intrinsics=intrinsics,
            obs=obs.reshape(-1, 2),
            frame_idx=torch.arange(b, device=device).repeat_interleave(n),
            point_idx=torch.arange(b * n, device=device),
            mask=mask.reshape(-1),
        )
    )

    def residuals(cam):
        return _residuals(
            cam, problem.points, problem.intrinsics, problem.obs, problem.frame_idx,
            problem.point_idx, problem.mask,
        )

    def costs(cam):  # (B,) 0.5 * sum r^2 per problem
        r = residuals(cam)
        return 0.5 * torch.sum((r * r).reshape(b, -1), dim=1)

    cam = problem.cam_params
    cost = costs(cam)
    lam = torch.full((b,), config.init_lambda, dtype=cam.dtype, device=device)
    it = torch.zeros(b, dtype=torch.int64, device=device)
    active = torch.full((b,), config.max_iters > 0, dtype=torch.bool, device=device)
    while config.max_iters > 0:
        r = residuals(cam)
        jc, jp = _obs_jacobians(
            cam, problem.points, problem.intrinsics, problem.obs, problem.frame_idx,
            problem.point_idx, problem.mask,
        )

        def attempt(lam_try):
            dc, _ = _solve_normal_equations(problem._replace(cam_params=cam), lam_try, jc, jp, r, fix_points=True)
            return cam + dc, costs(cam + dc)

        c1_cam, c1 = attempt(lam)
        c2_cam, c2 = attempt(lam * config.lambda_up**2)
        use1, improved, new_cost, new_lam, done = _lm_decision(config, cost, lam, c1, c2)
        new_cam = torch.where(improved[:, None], torch.where(use1[:, None], c1_cam, c2_cam), cam)
        # Problems that have stopped keep their state.
        cam = torch.where(active[:, None], new_cam, cam)
        cost = torch.where(active, new_cost, cost)
        lam = torch.where(active, new_lam, lam)
        it = it + active.to(torch.int64)
        active = active & ~done & (it < config.max_iters)
        if not bool(active.any()):  # the one host read per iteration
            break
    return cam
