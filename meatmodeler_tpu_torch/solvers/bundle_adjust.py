"""Schur-complement Levenberg-Marquardt bundle adjustment (torch twin of
``meatmodeler_tpu/solvers/bundle_adjust.py``).

Same algorithm as the reference: per-observation Jacobians (one launch of
the hand-written kernel ``csrc/ba_jac.cu`` an iteration on the card,
forward-mode AD on the CPU), block-diagonal U (F,6,6) / V (P,3,3), point
elimination through the dense (P, F*6, 3) strip, a dense reduced camera
solve, back-substitution, and the Marquardt-damped LM loop with the
reference's ftol rule. Problems are solved at their exact shapes: the
reference's bucket padding exists only so XLA compiles once, and its padded
rows are masked out, so the trajectory is the same.

Every solve runs through one Schur step (``_schur_step``: problems
stacked on a leading lane axis, each lane its own reduced camera system,
over point shards whose camera-sized sums go through a reduction where the
reference calls ``_allsum``), one stepper (``_BatchSolve``: each lane keeps
its own damping, cost, iteration count and stop, as under the reference's
``vmap`` of one ``while_loop``) and one loop (``_lm_loop``: one stepper, or
one per device in lockstep, one host read an iteration). Each iteration
runs in three spans (``utils/profiling.trace``): ``linearize`` (residuals
and Jacobians), ``solve`` (both trial steps) and ``decide`` (the acceptance
rule and the flag read); each loop adds its iterations to the counter
``lm_iterations:<path>`` of the span it runs in. The ``_ex`` solves check
nothing on the host, as the reference's do: a step that is not finite has a
cost that is not finite, which the acceptance rule never takes.
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
from meatmodeler_tpu_torch.utils.profiling import span_add, trace

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
    """Masked, weighted reprojection residuals (..., N, 2) of one problem, or
    of problems stacked on a leading lane axis (every argument with it,
    ``intrinsics`` (L, 3, 3), indices numbered within their lane):
    ``projection.project_points`` with one K a lane."""
    c = torch.gather(cam, -2, fidx[..., None].expand(*fidx.shape, 6))
    x = torch.gather(pts, -2, pidx[..., None].expand(*pidx.shape, 3))
    x = projection.rotate_points(x, c[..., :3]) + c[..., 3:6]
    homog = torch.einsum("...ij,...nj->...ni", intrinsics, x)
    r = (homog[..., :2] / homog[..., 2:3] - obs) * mask[..., None]
    return r if weight is None else r * weight[..., None]


def _obs_jacobians(cam, pts, intrinsics, obs, fidx, pidx, mask, weight=None):
    """Per-observation residual Jacobians: (N,2,6) wrt camera, (N,2,3) wrt
    point, masked and weighted; with a leading lane axis on every argument,
    per lane. One launch of the CUDA kernel (``bundle_adjust_cuda``) for
    tensors on the card, the plain version for tensors on the CPU."""
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


def _across_lanes(problem: BAProblem):
    """Each observation's camera and point of lane-stacked problems numbered
    across the lanes (lane * F + f, lane * P + p), so that one segment sum
    serves every lane."""
    (nl, f), p = problem.cam_params.shape[:2], problem.points.shape[1]
    lane = torch.arange(nl, device=problem.frame_idx.device)[:, None]
    return (lane * f + problem.frame_idx).reshape(-1), (lane * p + problem.point_idx).reshape(-1)


def _damped(m, lam):
    """Marquardt damping of the (L, K, d, d) blocks ``m`` by each lane's
    ``lam`` (L,). A block of UNDAMPED trace below 1e-12 (an unobserved or
    padded camera or point, see the reference's note) becomes the identity,
    so its rows decouple and its step solves to 0."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    damped = m + lam[:, None, None, None] * (m * eye + 1e-8 * eye)
    return torch.where((torch.einsum("...ii->...", m) < 1e-12)[..., None, None], eye, damped)


def _schur_step(shards, index, lam, jc, jp, r, fix_points: bool = False, reduce=_identity):
    """One damped Gauss-Newton step of every lane via the Schur complement,
    over point shards.

    ``shards`` holds one lane-stacked BAProblem per shard (the cameras, this
    shard's points and their observations), ``index`` its
    :func:`_across_lanes`; ``lam`` (L,), ``jc`` (L, N, 2, 6), ``jp``
    (L, N, 2, 3) and ``r`` (L, N, 2) hold one entry per shard. The
    camera-sized sums (U, b_c, the Schur cross term, the reduced RHS) go
    through ``reduce`` (one tensor per shard in, their sum per shard out), so
    every shard solves the same reduced camera systems; the point blocks
    stay with their shard. Returns [(delta_cam (L, F, 6), delta_pt
    (L, P, 3))] per shard. ``fix_points`` (the pose-only problems): W = V =
    0, each camera's system is its own 6x6 block and delta_pt is None."""
    nl, f = shards[0].cam_params.shape[:2]
    jc = [j.reshape(-1, 2, 6) for j in jc]
    jp = [j.reshape(-1, 2, 3) for j in jp]
    r = [x.reshape(-1, 2) for x in r]
    u = reduce([
        _segment_sum(torch.einsum("nri,nrj->nij", j, j), fidx, nl * f).reshape(nl, f, 6, 6)
        for (fidx, _), j in zip(index, jc)
    ])
    b_c = reduce([
        -_segment_sum(torch.einsum("nri,nr->ni", j, x), fidx, nl * f).reshape(nl, f, 6)
        for (fidx, _), j, x in zip(index, jc, r)
    ])
    u_d = [_damped(u_s, lam_s) for u_s, lam_s in zip(u, lam)]
    if fix_points:
        return [(torch.linalg.solve_ex(u_s, b_s[..., None])[0][..., 0], None) for u_s, b_s in zip(u_d, b_c)]

    sides = []  # per shard: W, V^-1, b_p, and its shares of the cross term and the reduced RHS
    for p, (fidx, pidx), j_c, j_p, x, lam_s in zip(shards, index, jc, jp, r, lam):
        n_p = p.points.shape[1]
        v = _segment_sum(torch.einsum("nri,nrj->nij", j_p, j_p), pidx, nl * n_p).reshape(nl, n_p, 3, 3)
        v_inv = torch.linalg.inv_ex(_damped(v, lam_s))[0]
        b_p = -_segment_sum(torch.einsum("nri,nr->ni", j_p, x), pidx, nl * n_p)
        w = torch.einsum("nri,nrj->nij", j_c, j_p)  # (L*N, 6, 3)
        # Dense per-point camera strip A_p (L, P, F*6, 3); S = blkdiag(U) - sum_p A_p V_p^-1 A_p^T per lane.
        a = torch.zeros((nl * n_p, f, 6, 3), dtype=w.dtype, device=w.device)
        a.index_put_((pidx, p.frame_idx.reshape(-1)), w, accumulate=True)
        a = a.reshape(nl, n_p, f * 6, 3)
        s_cross = torch.einsum("vpak,vpbk->vab", torch.einsum("vpak,vpkl->vpal", a, v_inv), a)
        v_inv = v_inv.reshape(nl * n_p, 3, 3)
        y = torch.einsum("nij,njk->nik", w, v_inv[pidx])
        red = _segment_sum(torch.einsum("nij,nj->ni", y, b_p[pidx]), fidx, nl * f).reshape(nl, f, 6)
        sides.append((w, v_inv, b_p, s_cross, red))
    s_cross = reduce([side[3] for side in sides])
    red = reduce([side[4] for side in sides])
    steps = []
    for (fidx, pidx), (w, v_inv, b_p, _, _), u_s, b_s, s_s, red_s in zip(index, sides, u_d, b_c, s_cross, red):
        system = -s_s  # + blkdiag(U_d): the (F, F) diagonal of its 6x6 blocks
        system.view(nl, f, 6, f, 6).diagonal(dim1=1, dim2=3).add_(u_s.permute(0, 2, 3, 1))
        delta_c = torch.linalg.solve_ex(system, (b_s - red_s).reshape(nl, f * 6))[0].reshape(nl, f, 6)
        # Back-substitute: delta_p = V^-1 (b_p - sum_{n in p} W_n^T delta_c[f_n]).
        wt_dc = _segment_sum(torch.einsum("nij,ni->nj", w, delta_c.reshape(-1, 6)[fidx]), pidx, b_p.shape[0])
        steps.append((delta_c, torch.einsum("pij,pj->pi", v_inv, b_p - wt_dc).reshape(nl, -1, 3)))
    return steps


def _canonical(problem: BAProblem) -> BAProblem:
    """One float dtype for every float field (mixed f32/f64 inputs), int64
    indices."""
    dtype = torch.promote_types(
        torch.promote_types(problem.cam_params.dtype, problem.points.dtype),
        torch.promote_types(problem.obs.dtype, problem.intrinsics.dtype),
    )
    return problem._replace(
        cam_params=problem.cam_params.to(dtype),
        points=problem.points.to(dtype),
        intrinsics=problem.intrinsics.to(dtype),
        obs=problem.obs.to(dtype),
        frame_idx=problem.frame_idx.long(),
        point_idx=problem.point_idx.long(),
        weight=None if problem.weight is None else problem.weight.to(dtype),
    )


def _fields(problem: BAProblem):
    """The fixed arguments of ``_residuals`` and ``_obs_jacobians``."""
    return (
        problem.intrinsics, problem.obs, problem.frame_idx, problem.point_idx, problem.mask, problem.weight,
    )


def _lm_decision(config: SolverConfig, cost, lam, c1, c2):
    """The LM acceptance rule, elementwise over lanes: of the two trial
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


def _pick(take, use1, first, second, old):
    """Per lane: the first or the second trial where the lane steps, else
    its old state."""
    take, use1 = take.to(old.device)[:, None, None], use1.to(old.device)[:, None, None]
    return torch.where(take, torch.where(use1, first, second), old)


class _BatchSolve:
    """The LM of lane-stacked problems, one iteration of every active lane
    per :meth:`step`. ``shards``: the lanes' point shards (see
    :func:`_schur_step`; the cameras the same in each); their costs,
    observation counts and rmse sums go through ``reduce`` too, so every
    shard takes the same decisions. Each lane's damping (from
    ``init_lambda``, a float or a 0-d tensor, or ``config.init_lambda``),
    cost, iteration count and stop (``active``) live on the first shard's
    device."""

    def __init__(self, shards, config: SolverConfig, fix_points: bool = False, init_lambda=None, reduce=_identity):
        self.shards = [_canonical(p) for p in shards]
        self.index = [_across_lanes(p) for p in self.shards]
        self.config, self.fix_points, self.reduce = config, fix_points, reduce
        self.cam = [p.cam_params for p in self.shards]
        self.pts = [p.points for p in self.shards]
        self.cost = self._costs(self.cam, self.pts)
        first = self.cam[0]
        lam0 = config.init_lambda if init_lambda is None else init_lambda
        # A product, not a copy: a float or a 0-d tensor on the device, no host read.
        self.lam = torch.ones(first.shape[0], dtype=first.dtype, device=first.device) * lam0
        self.it = torch.zeros(first.shape[0], dtype=torch.int64, device=first.device)
        self.active = torch.ones(first.shape[0], dtype=torch.bool, device=first.device)

    def _costs(self, cam, pts):
        """(L,) 0.5 * sum r^2 of each lane over its (N, 2) residuals, summed
        over the shards."""
        costs = []
        for p, c, x in zip(self.shards, cam, pts):
            r = _residuals(c, x, *_fields(p))
            costs.append(0.5 * torch.sum(r * r, dim=(1, 2)))
        return self.reduce(costs)[0]

    def step(self) -> torch.Tensor:
        """One LM iteration of every active lane; returns the "any lane
        still active" flag, on the device (not read)."""
        config, active, lam = self.config, self.active, self.lam
        with trace("linearize"):
            r = [_residuals(c, x, *_fields(p)) for p, c, x in zip(self.shards, self.cam, self.pts)]
            jc, jp = zip(*(_obs_jacobians(c, x, *_fields(p)) for p, c, x in zip(self.shards, self.cam, self.pts)))

        def attempt(lam_try):
            steps = _schur_step(self.shards, self.index, [lam_try.to(c.device) for c in self.cam], jc, jp, r,
                                fix_points=self.fix_points, reduce=self.reduce)
            cam = [c + dc for c, (dc, _) in zip(self.cam, steps)]
            pts = self.pts if self.fix_points else [x + dp for x, (_, dp) in zip(self.pts, steps)]
            return cam, pts, self._costs(cam, pts)

        with trace("solve"):
            cam1, pts1, c1 = attempt(lam)
            cam2, pts2, c2 = attempt(lam * config.lambda_up**2)
        with trace("decide"):
            use1, improved, new_cost, new_lam, done = _lm_decision(config, self.cost, lam, c1, c2)
            # Lanes that have stopped keep their state.
            take = active & improved
            self.cam = [_pick(take, use1, a, b, c) for a, b, c in zip(cam1, cam2, self.cam)]
            if not self.fix_points:
                self.pts = [_pick(take, use1, a, b, x) for a, b, x in zip(pts1, pts2, self.pts)]
            self.cost = torch.where(active, new_cost, self.cost)
            self.lam = torch.where(active, new_lam, lam)
            self.it = self.it + active
            self.active = active & ~done
            return self.active.any()

    def result(self) -> BAResult:
        """Per lane: cameras, points (the shards' blocks in order, on the
        first shard's device), cost, unweighted pixel rmse, iterations and
        damping."""
        sq, n_valid = [], []
        for p, c, x in zip(self.shards, self.cam, self.pts):
            r_px = _residuals(c, x, *_fields(p)[:-1])  # the UNWEIGHTED pixel residuals
            sq.append(torch.sum(r_px * r_px, dim=(1, 2)))
            n_valid.append(p.mask.sum(1))
        rmse = torch.sqrt(self.reduce(sq)[0] / torch.clamp(self.reduce(n_valid)[0], min=1))
        home = self.cam[0].device
        pts = torch.cat([x.to(home) for x in self.pts], dim=1)
        return BAResult(self.cam[0], pts, self.cost, rmse, self.it, self.lam)


def _lm_loop(solves) -> int:
    """The LM loop of every solve: steps ``solves`` (``_BatchSolve``s, one
    per device) in lockstep until no lane of any is active or
    ``max_iters``, with one host read an iteration (the one stepper's flag,
    or every stepper's stacked on the first's device); a stepper whose lanes
    are all done stops stepping. Adds the iterations to ``lm_iterations`` of
    the span it runs in and returns them."""
    running, iterations = list(solves), 0
    while running and iterations < solves[0].config.max_iters:
        flags = [s.step() for s in running]
        iterations += 1
        with trace("decide"):  # the one host read per iteration
            if len(flags) == 1:
                live = [bool(flags[0])]
            else:
                live = torch.stack([f.to(flags[0].device) for f in flags]).tolist()
        running = [s for s, on in zip(running, live) if on]
    span_add("lm_iterations", iterations)
    return iterations


def _solve_one(shards, config: SolverConfig, fix_points: bool = False, init_lambda=None, reduce=_identity) -> BAResult:
    """One problem, given as its point shards (one for :func:`solve_ba`), as
    one lane: a BAResult without the lane axis, ``iterations`` an int, the
    points of every shard in order on the first shard's device."""
    lanes = [BAProblem(*(None if x is None else x[None] for x in p)) for p in shards]
    lm = _BatchSolve(lanes, config, fix_points, init_lambda, reduce)
    iterations = _lm_loop([lm])
    res = lm.result()
    return BAResult(res.cam_params[0], res.points[0], res.cost[0], res.rmse[0], iterations, res.final_lambda[0])


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
    return _solve_one([problem], config, fix_points, init_lambda)


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
    lm = _BatchSolve([problem], config)
    _lm_loop([lm])
    return lm.result()


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
    and stop, as the reference's ``vmap`` of one ``while_loop`` does: each
    is a lane of one camera (``_BatchSolve``), and the loop ends when none
    is left. Folding them into one joint solve would stop them all at the
    same point.
    """
    b, n = obs.shape[:2]
    device = obs.device
    problem = BAProblem(
        cam_params=cam_params[:, None],
        points=points_3d.contiguous(),
        intrinsics=intrinsics.expand(b, 3, 3).contiguous(),
        obs=obs.contiguous(),
        frame_idx=torch.zeros((b, n), dtype=torch.int64, device=device),
        point_idx=torch.arange(n, device=device).repeat(b, 1),
        mask=mask.contiguous(),
    )
    lm = _BatchSolve([problem], config, fix_points=True)
    _lm_loop([lm])
    return lm.cam[0][:, 0]
