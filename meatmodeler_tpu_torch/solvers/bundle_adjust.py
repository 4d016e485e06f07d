"""Schur-complement Levenberg-Marquardt bundle adjustment (torch twin of
``meatmodeler_tpu/solvers/bundle_adjust.py``).

Same algorithm as the reference: per-observation Jacobians (one launch of
the hand-written kernel ``csrc/ba_jac.cu`` an iteration on the card,
forward-mode AD on the CPU), block-diagonal U (F,6,6) / V (P,3,3), point elimination through the
dense (P, F*6, 3) strip, a dense reduced camera solve, back-substitution,
and the Marquardt-damped LM loop with the reference's ftol rule. The loop is
a Python loop that reads one flag back per iteration. Problems are solved
at their exact shapes: the reference's bucket padding exists only so XLA
compiles once, and its padded rows are masked out, so the trajectory is the
same.

The loop runs over point shards (``_solve_shards``): each shard holds the
cameras and a block of the points with their observations; the
camera-sized sums (U, b_c, the Schur cross term, the reduced RHS, the cost)
go through a reduction across the shards where the reference calls
``_allsum``, so every shard solves the same reduced camera system and walks
the same LM trajectory. ``solve_ba`` is the one-shard case;
``parallel.sharded.solve_ba_point_sharded`` spreads the shards over a mesh,
which ``adjust_points`` does on request (``solver.point_shard_devices``) or
when the dense Schur strip outgrows ``solver.hbm_strip_budget_bytes``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from meatmodeler_tpu_torch.config import SolverConfig
from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.solvers import bundle_adjust_cuda
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
    """Per-observation residual Jacobians: (N,2,6) wrt camera, (N,2,3) wrt
    point, masked and weighted; with a leading lane axis on every argument,
    per lane (``solve_ba_batch``). One launch of the CUDA kernel
    (``bundle_adjust_cuda``) for tensors on the card, the plain version for
    tensors on the CPU."""
    if cuda_build.on_card(cam):
        return bundle_adjust_cuda.obs_jacobians(cam, pts, intrinsics, fidx, pidx, mask, weight)
    if cam.ndim == 3:
        extra = () if weight is None else (weight,)
        return vmap(_obs_jacobians_reference)(cam, pts, intrinsics, obs, fidx, pidx, mask, *extra)
    return _obs_jacobians_reference(cam, pts, intrinsics, obs, fidx, pidx, mask, weight)


def _obs_jacobians_reference(cam, pts, intrinsics, obs, fidx, pidx, mask, weight=None):
    """The plain version of :func:`_obs_jacobians` for one problem:
    ``vmap(jacfwd)`` of the projection over the observations, behind the
    forward-AD lock."""

    def res(c, p, ob):
        return projection.project_points(p[None], c[None], intrinsics)[0] - ob

    jc, jp = one_thread_at_a_time(vmap(jacfwd(res, argnums=(0, 1))))(cam[fidx], pts[pidx], obs)
    m = mask.to(jc.dtype)[:, None, None]
    if weight is not None:
        m = m * weight[:, None, None]
    return jc * m, jp * m


def _segment_sum(x, idx, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _identity(tensors):
    """The reduction of a single shard."""
    return tensors


def _damped_u(u, lam):
    """Marquardt damping of the camera blocks (``lam`` one damping, or one
    per camera); an unobserved camera gets an identity block, so its rows
    decouple and its step solves to 0."""
    eye6 = torch.eye(6, dtype=u.dtype, device=u.device)
    lam = lam if lam.ndim == 0 else lam[:, None, None]
    u_d = u + lam * (u * eye6 + 1e-8 * eye6)
    u_trace = torch.einsum("fii->f", u)
    return torch.where((u_trace < 1e-12)[:, None, None], eye6, u_d)


def _point_side(problem: BAProblem, lam, jc, jp, r):
    """One shard's point side: the damped, guarded V^-1, b_p and the W
    blocks it keeps, and its shares of the Schur cross term and of the
    reduced RHS, which are summed over the shards."""
    f = problem.cam_params.shape[0]
    p = problem.points.shape[0]
    fidx, pidx = problem.frame_idx, problem.point_idx
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

    y = torch.einsum("nij,njk->nik", w, v_inv[pidx])
    red = _segment_sum(torch.einsum("nij,nj->ni", y, b_p[pidx]), fidx, f)
    return w, v_inv, b_p, s_cross, red


def _solve_normal_equations(shards, lam, jc, jp, r, fix_points: bool = False, reduce=_identity):
    """One damped Gauss-Newton step via the Schur complement, over point
    shards.

    ``shards`` holds one BAProblem per shard (the cameras, this shard's
    points, its observations with local point indices); ``lam``, ``jc``,
    ``jp`` and ``r`` hold one entry per shard. The camera-sized sums go
    through ``reduce`` (one tensor per shard in, their sum per shard out),
    so every shard solves the same reduced camera system; the point blocks
    stay with their shard. Returns [(delta_cam (F,6), delta_pt (P,3))] per
    shard. ``fix_points`` (the pose-only problem): W = V = 0, the camera
    system is block-diagonal and delta_p = 0 exactly; there ``lam`` may hold
    one damping per camera.
    """
    f = shards[0].cam_params.shape[0]
    u = reduce([
        _segment_sum(torch.einsum("nri,nrj->nij", jc_s, jc_s), p.frame_idx, f) for p, jc_s in zip(shards, jc)
    ])
    b_c = reduce([
        -_segment_sum(torch.einsum("nri,nr->ni", jc_s, r_s), p.frame_idx, f) for p, jc_s, r_s in zip(shards, jc, r)
    ])
    if fix_points:
        return [
            (torch.linalg.solve(_damped_u(u_s, lam_s), b_s[..., None])[..., 0], torch.zeros_like(p.points))
            for p, u_s, b_s, lam_s in zip(shards, u, b_c, lam)
        ]
    sides = [_point_side(*args) for args in zip(shards, lam, jc, jp, r)]
    s_cross = reduce([side[3] for side in sides])
    red = reduce([side[4] for side in sides])
    steps = []
    for p, (w, v_inv, b_p, _, _), u_s, b_s, s_s, red_s, lam_s in zip(shards, sides, u, b_c, s_cross, red, lam):
        s = torch.block_diag(*_damped_u(u_s, lam_s).unbind(0)) - s_s
        delta_c = torch.linalg.solve(s, (b_s - red_s).reshape(f * 6)).reshape(f, 6)
        # Back-substitute: delta_p = V^-1 (b_p - sum_{n in p} W_n^T delta_c[f_n]).
        wt_dc = _segment_sum(torch.einsum("nij,ni->nj", w, delta_c[p.frame_idx]), p.point_idx, p.points.shape[0])
        steps.append((delta_c, torch.einsum("pij,pj->pi", v_inv, b_p - wt_dc)))
    return steps


def _cost(problem, cam, pts):
    r = _residuals(cam, pts, *_fields(problem))
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
    return _solve_shards([problem], config, fix_points, init_lambda)[0]


def _solve_shards(shards, config: SolverConfig, fix_points: bool = False, init_lambda=None, reduce=_identity):
    """The LM loop of :func:`solve_ba` over point shards (see
    :func:`_solve_normal_equations`): the observation count, the costs and
    the rmse's sum of squares go through ``reduce`` too, so every shard
    takes the same decisions, and the flag of the first shard is the one
    host read per iteration. Returns one BAResult per shard: cameras, cost,
    rmse, iterations and damping the same on every shard, points the
    shard's own."""
    shards = [_canonical(p) for p in shards]
    n_valid = [torch.clamp(n, min=1) for n in reduce([p.mask.sum() for p in shards])]

    def costs(cam, pts):
        return reduce([_cost(p, c, x) for p, c, x in zip(shards, cam, pts)])

    cam = [p.cam_params for p in shards]
    pts = [p.points for p in shards]
    cost = costs(cam, pts)
    lam0 = config.init_lambda if init_lambda is None else init_lambda
    lam = [torch.as_tensor(lam0, dtype=c.dtype, device=c.device) for c in cam]
    it = 0
    while it < config.max_iters:
        r = [_residuals(c, x, *_fields(p)) for p, c, x in zip(shards, cam, pts)]
        jc, jp = zip(*(_obs_jacobians(c, x, *_fields(p)) for p, c, x in zip(shards, cam, pts)))

        def attempt(lam_try):
            steps = _solve_normal_equations(
                [p._replace(cam_params=c, points=x) for p, c, x in zip(shards, cam, pts)],
                lam_try, jc, jp, r, fix_points=fix_points, reduce=reduce,
            )
            new_cam = [c + dc for c, (dc, _) in zip(cam, steps)]
            new_pts = [x + dp for x, (_, dp) in zip(pts, steps)]
            return new_cam, new_pts, costs(new_cam, new_pts)

        c1_cam, c1_pts, c1 = attempt(lam)
        c2_cam, c2_pts, c2 = attempt([l * config.lambda_up**2 for l in lam])
        done = []
        for s in range(len(shards)):
            use1, improved, cost[s], lam_s, done_s = _lm_decision(config, cost[s], lam[s], c1[s], c2[s])
            cam[s] = torch.where(improved, torch.where(use1, c1_cam[s], c2_cam[s]), cam[s])
            pts[s] = torch.where(improved, torch.where(use1, c1_pts[s], c2_pts[s]), pts[s])
            lam[s] = lam_s
            done.append(done_s)
        it += 1
        if bool(done[0]):  # the one host read per iteration
            break

    def sum_sq(p, c, x):  # the UNWEIGHTED pixel residuals, whatever the weights
        r_px = _residuals(c, x, *_fields(p)[:-1])
        return torch.sum(r_px * r_px)

    sq = reduce([sum_sq(p, c, x) for p, c, x in zip(shards, cam, pts)])
    return [
        BAResult(cam[s], pts[s], cost[s], torch.sqrt(sq[s] / n_valid[s]), it, lam[s]) for s in range(len(shards))
    ]


def _fields(problem: BAProblem):
    """The fixed arguments of ``_residuals`` and ``_obs_jacobians``."""
    return (
        problem.intrinsics, problem.obs, problem.frame_idx, problem.point_idx, problem.mask, problem.weight,
    )


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
    problems (``parallel/batch.py``), which reads neither
    ``point_shard_devices`` nor the memory band. Every field carries the
    lane axis (``intrinsics`` (V, 3, 3)); padded observations are masked,
    padded cameras and points unobserved. Each lane keeps its own damping,
    cost, iteration count and stop, and a finished lane is frozen, as under
    ``vmap`` of one ``while_loop``; the loop reads one "any lane active"
    flag per iteration. ``iterations`` and the other result fields are
    per lane."""
    lm = _BatchSolve(problem, config)
    while config.max_iters > 0 and bool(lm.step()):  # the one host read per iteration
        pass
    return lm.result()


class _BatchSolve:
    """The LM of :func:`solve_ba_batch`, one iteration per :meth:`step`, so
    that ``parallel.sharded.solve_ba_batch`` can step one per device in
    lockstep."""

    def __init__(self, problem: BAProblem, config: SolverConfig):
        self.problem = problem = _canonical(problem)
        self.config = config
        nv = problem.cam_params.shape[0]
        self.fixed = (problem.intrinsics, problem.obs, problem.frame_idx, problem.point_idx, problem.mask)
        self.weighted = self.fixed if problem.weight is None else self.fixed + (problem.weight,)
        self.cam, self.pts = problem.cam_params, problem.points
        self.cost = self._costs(self.cam, self.pts)
        device = self.cam.device
        self.lam = torch.full((nv,), config.init_lambda, dtype=self.cam.dtype, device=device)
        self.it = torch.zeros(nv, dtype=torch.int64, device=device)
        self.active = torch.full((nv,), config.max_iters > 0, dtype=torch.bool, device=device)

    def _costs(self, cam, pts):  # (V,) 0.5 * sum r^2 per lane
        r = vmap(_residuals)(cam, pts, *self.weighted)
        return 0.5 * torch.sum(r * r, dim=(1, 2))

    def step(self) -> torch.Tensor:
        """One LM iteration of every active lane; returns the "any lane
        still active" flag, on the device (not read)."""
        config, cam, pts, lam, active = self.config, self.cam, self.pts, self.lam, self.active
        r = vmap(_residuals)(cam, pts, *self.weighted)
        jc, jp = _obs_jacobians(cam, pts, *self.weighted)

        def attempt(lam_try):
            dc, dp = _solve_normal_equations_batch(self.problem._replace(cam_params=cam, points=pts), lam_try, jc, jp, r)
            return cam + dc, pts + dp, self._costs(cam + dc, pts + dp)

        c1_cam, c1_pts, c1 = attempt(lam)
        c2_cam, c2_pts, c2 = attempt(lam * config.lambda_up**2)
        use1, improved, new_cost, new_lam, done = _lm_decision(config, self.cost, lam, c1, c2)
        # Lanes that have stopped keep their state.
        step = (active & improved)[:, None, None]
        self.cam = torch.where(step, torch.where(use1[:, None, None], c1_cam, c2_cam), cam)
        self.pts = torch.where(step, torch.where(use1[:, None, None], c1_pts, c2_pts), pts)
        self.cost = torch.where(active, new_cost, self.cost)
        self.lam = torch.where(active, new_lam, lam)
        self.it = self.it + active.to(torch.int64)
        self.active = active & ~done & (self.it < config.max_iters)
        return self.active.any()

    def result(self) -> BAResult:
        r_px = vmap(_residuals)(self.cam, self.pts, *self.fixed)
        n_valid = torch.clamp(self.problem.mask.sum(1), min=1)
        rmse = torch.sqrt(torch.sum(r_px * r_px, dim=(1, 2)) / n_valid)
        return BAResult(self.cam, self.pts, self.cost, rmse, self.it, self.lam)


def _ceil_to(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q if q > 1 else n


def _point_shards(n_p: int, n_f: int, config: SolverConfig, itemsize: int, n_devices: int) -> int:
    """The reference's memory band (``adjust_points``), on its bucket-padded
    sizes: the dense Schur strip (P, F, 6, 3) and its V^-1 product peak at
    ~2 * P * F * 72 bytes of float32. Returns the number of point shards —
    ``point_shard_devices``, or as many as keep each shard's strip inside
    ``hbm_strip_budget_bytes`` — or raises, with the numbers, when that is
    more than ``n_devices``. Only the decision follows the padded sizes:
    the solve runs at the exact ones."""
    pb = _ceil_to(n_p, config.bucket[1])
    fb = _ceil_to(n_f, config.bucket[0])
    shards = max(config.point_shard_devices, 1)
    if config.hbm_strip_budget_bytes > 0:
        strip_bytes = 2 * pb * fb * 18 * itemsize
        need = -(-strip_bytes // config.hbm_strip_budget_bytes)
        if need > shards:
            if need > n_devices:
                raise ValueError(
                    f"BA problem too large for the configured memory band: "
                    f"the dense Schur strip over {pb} points x {fb} cameras "
                    f"is ~{strip_bytes / 2**20:.1f} MiB, needing {need} "
                    f"point shards at hbm_strip_budget_bytes="
                    f"{config.hbm_strip_budget_bytes / 2**20:.1f} MiB/device, "
                    f"but only {n_devices} devices are addressable. Run on a "
                    f"larger slice, raise solver.hbm_strip_budget_bytes, or "
                    f"reduce the problem (fewer tracks/keyframes)."
                )
            shards = int(need)
    return shards


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
    devices=None,
) -> Tuple[torch.Tensor, torch.Tensor, BAResult]:
    """Full BA over cameras and points. Returns refined (P, 3) points,
    (F, 4, 4) homogeneous extrinsics and the solver stats.
    ``init_lambda``: optional damping warm start (see :func:`solve_ba`).

    The points are sharded over several devices (``parallel.sharded.
    solve_ba_point_sharded``) when ``config.point_shard_devices`` asks for
    it or the memory band needs it (``_point_shards``). ``devices``: the
    devices a sharded solve may use; by default every visible GPU for a
    problem on the card, else the problem's own device. ``["cpu"] * n``
    offers n virtual shards on the CPU."""
    device = extrinsics.device
    points_3d = points_3d.reshape(-1, 3)
    points_2d = points_2d.reshape(-1, 2)
    frame_indices = torch.as_tensor(frame_indices, device=device).long()
    point_indices = torch.as_tensor(point_indices, device=device).long()
    if devices is None:
        devices = (
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda" else [device]
        )
    shards = _point_shards(
        points_3d.shape[0], extrinsics.shape[0], config,
        torch.promote_types(points_3d.dtype, torch.float32).itemsize, len(devices),
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
    if shards > 1:
        # Imported here: parallel.sharded imports this module.
        from meatmodeler_tpu_torch.parallel import sharded

        mesh = sharded.make_mesh(data=min(shards, len(devices)), model=1, devices=devices)
        result = sharded.solve_ba_point_sharded(mesh, problem, config=config, init_lambda=init_lambda)
    else:
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
            [(dc, _)] = _solve_normal_equations([problem._replace(cam_params=cam)], [lam_try], [jc], [jp], [r], fix_points=True)
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
