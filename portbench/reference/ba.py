"""The plain reference of the global bundle adjustment.

A BA problem is a dict of tensors: ``R`` (F, 3, 3) and ``t`` (F, 3), each
keyframe's world-to-camera rotation and translation, ``points`` (P, 3),
``K`` (3, 3), ``obs`` (N, 2) observed pixels, ``fidx`` and ``pidx`` (N,)
indices, ``weight`` (N,) residual weights. The cost is half the sum of
squared weighted pinhole reprojection residuals (rotate, translate, K,
perspective divide); the reported RMSE is over the unweighted residuals. A
step moves a camera by a small rotation applied on the left, R <- exp(d) R,
and a translation, so no rotation is ever turned back into a vector (near a
half turn that loses digits).

``gain`` is how much of the cost one Levenberg-Marquardt step, computed
here in float64 with the Schur complement over the points, can still take
away from a solution: near 0 at a converged solve, large where a solve
stopped early, skipped observations or never ran. ``solve`` is the
reference's own Levenberg-Marquardt loop, run in a chosen precision: the
control runs it in bfloat16. Plain PyTorch; nothing of the program is
imported.
"""

from __future__ import annotations

import torch
from torch.func import jvp

__all__ = ["rotate", "exp_so3", "project", "residuals", "cost", "rmse", "gain", "solve", "to_dtype"]

# Observations per block when forming the reduced camera system, to bound
# memory on long tracks.
_PAIR_BLOCK = 1 << 18
# The damping factors ``gain`` tries: Marquardt's, scaled by the diagonal.
GAIN_DAMPING = (1e-8, 1e-6, 1e-4, 1e-2, 1.0)


def to_dtype(problem: dict, dtype) -> dict:
    """``problem`` with its float fields in ``dtype``."""
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in problem.items()}


def rotate(points, rvecs):
    """Rodrigues: p + a (r x p) + b (r x (r x p)), a = sin t / t and
    b = (1 - cos t) / t^2 for t = |r|, with their Taylor series near 0 (the
    square root guarded inside, so forward-mode derivatives stay finite)."""
    theta_sq = torch.sum(rvecs * rvecs, dim=-1, keepdim=True)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe)) / safe_sq)
    cross = torch.linalg.cross(rvecs, points, dim=-1)
    return points + a * cross + b * torch.linalg.cross(rvecs, cross, dim=-1)


def project(points, R, t, K):
    """(..., 3) world points seen by cameras (..., 3, 3) R and (..., 3) t
    -> (..., 2) pixels."""
    cam = torch.einsum("...ij,...j->...i", R, points) + t
    homog = torch.einsum("ij,...j->...i", K, cam)
    return homog[..., :2] / homog[..., 2:3]


def residuals(problem: dict, R=None, t=None, points=None, weighted: bool = True):
    R = problem["R"] if R is None else R
    t = problem["t"] if t is None else t
    points = problem["points"] if points is None else points
    fidx = problem["fidx"]
    r = project(points[problem["pidx"]], R[fidx], t[fidx], problem["K"]) - problem["obs"]
    return r * problem["weight"][:, None] if weighted else r


def cost(problem: dict, R=None, t=None, points=None):
    r = residuals(problem, R, t, points)
    return 0.5 * torch.sum(r * r)


def rmse(problem: dict, R=None, t=None, points=None):
    r = residuals(problem, R, t, points, weighted=False)
    return torch.sqrt(torch.sum(r * r) / r.shape[0])


def exp_so3(d):
    """(..., 3) rotation vectors -> (..., 3, 3) rotations (Rodrigues)."""
    eye = torch.eye(3, dtype=d.dtype, device=d.device).expand(d.shape[:-1] + (3, 3))
    return torch.stack([rotate(eye[..., :, j], d) for j in range(3)], dim=-1)


def _jacobians(problem: dict, R, t, points):
    """Per observation: weighted d r / d (left rotation, translation) of its
    camera (N, 2, 6) and d r / d point (N, 2, 3), one forward-mode pass a
    parameter over every observation (each residual depends on its own
    camera and point only)."""
    K = problem["K"]
    fidx = problem["fidx"]
    rx, t_obs, p_obs = torch.einsum("nij,nj->ni", R[fidx], points[problem["pidx"]]), t[fidx], points[problem["pidx"]]
    r_obs = R[fidx]

    def by_camera(d):
        cam = rotate(rx, d[:, :3]) + t_obs + d[:, 3:]
        homog = torch.einsum("ij,nj->ni", K, cam)
        return homog[:, :2] / homog[:, 2:3]

    def by_point(x):
        return project(x, r_obs, t_obs, K)

    def columns(fn, x):
        cols = []
        for k in range(x.shape[-1]):
            tangent = torch.zeros_like(x)
            tangent[:, k] = 1.0
            cols.append(jvp(fn, (x,), (tangent,))[1])
        return torch.stack(cols, dim=-1)

    w = problem["weight"][:, None, None]
    zeros = torch.zeros(rx.shape[0], 6, dtype=rx.dtype, device=rx.device)
    return columns(by_camera, zeros) * w, columns(by_point, p_obs) * w


def _apply(R, t, dc):
    return exp_so3(dc[:, :3]) @ R, t + dc[:, 3:]


def _step(problem: dict, points, r, jc, jp, lam: float):
    """The damped Gauss-Newton step (Marquardt's diagonal scaling) by the
    Schur complement over the points, in the dtype of ``jc`` (linear
    algebra in at least float32). Returns (d cameras (F, 6): a left
    rotation and a translation each, d points)."""
    f, p = problem["R"].shape[0], points.shape[0]
    fidx, pidx = problem["fidx"], problem["pidx"]
    solve_type = torch.promote_types(jc.dtype, torch.float32)
    jc, jp, r = jc.to(solve_type), jp.to(solve_type), r.to(solve_type)
    u = torch.zeros(f, 6, 6, dtype=solve_type, device=jc.device).index_add_(0, fidx, jc.transpose(1, 2) @ jc)
    v = torch.zeros(p, 3, 3, dtype=solve_type, device=jc.device).index_add_(0, pidx, jp.transpose(1, 2) @ jp)
    bc = -torch.zeros(f, 6, dtype=solve_type, device=jc.device).index_add_(0, fidx, (jc.transpose(1, 2) @ r[..., None])[..., 0])
    bp = -torch.zeros(p, 3, dtype=solve_type, device=jc.device).index_add_(0, pidx, (jp.transpose(1, 2) @ r[..., None])[..., 0])
    eye6 = torch.eye(6, dtype=solve_type, device=jc.device)
    eye3 = torch.eye(3, dtype=solve_type, device=jc.device)
    u = u + lam * u * eye6 + 1e-9 * eye6
    v = v + lam * v * eye3 + 1e-9 * eye3
    v_inv = torch.linalg.inv(v)
    w = jc.transpose(1, 2) @ jp  # (N, 6, 3)
    y = w @ v_inv[pidx]  # (N, 6, 3)
    # The reduced camera system: U - sum over observation pairs of one point
    # of Y_i W_j^T, accumulated in blocks of pairs.
    s = torch.zeros(f * f, 6, 6, dtype=solve_type, device=jc.device)
    order = torch.argsort(pidx, stable=True)
    sorted_p = pidx[order]
    counts = torch.bincount(sorted_p, minlength=p)
    starts = torch.cumsum(counts, 0) - counts
    length = int(counts.max()) if counts.numel() else 0
    slot = torch.arange(sorted_p.shape[0], device=jc.device) - starts[sorted_p]
    table = torch.full((p, max(length, 1)), -1, dtype=torch.long, device=jc.device)
    table[sorted_p, slot] = order
    per_block = max(1, _PAIR_BLOCK // max(1, length * length))
    for b0 in range(0, p, per_block):
        t = table[b0 : b0 + per_block]
        a, c = t[:, :, None].expand(-1, -1, t.shape[1]), t[:, None, :].expand(-1, t.shape[1], -1)
        ok = (a >= 0) & (c >= 0)
        a, c = a[ok], c[ok]
        s.index_add_(0, fidx[a] * f + fidx[c], y[a] @ w[c].transpose(1, 2))
    s = -s.reshape(f, f, 6, 6)
    s[torch.arange(f), torch.arange(f)] += u
    s = s.permute(0, 2, 1, 3).reshape(6 * f, 6 * f)
    rhs = bc - torch.zeros(f, 6, dtype=solve_type, device=jc.device).index_add_(
        0, fidx, (y @ bp[pidx][..., None])[..., 0]
    )
    dc = torch.linalg.solve(s, rhs.reshape(-1)).reshape(f, 6)
    wt_dc = torch.zeros(p, 3, dtype=solve_type, device=jc.device).index_add_(
        0, pidx, (w.transpose(1, 2) @ dc[fidx][..., None])[..., 0]
    )
    dp = (v_inv @ (bp - wt_dc)[..., None])[..., 0]
    return dc.to(points.dtype), dp.to(points.dtype)


def gain(problem: dict) -> float:
    """The largest share of the cost at ``problem``'s cameras and points
    that one float64 damped Gauss-Newton step removes, over the dampings
    ``GAIN_DAMPING`` (0 where none lowers it)."""
    problem = to_dtype(problem, torch.float64)
    R, t, points = problem["R"], problem["t"], problem["points"]
    c0 = float(cost(problem))
    r = residuals(problem)
    jc, jp = _jacobians(problem, R, t, points)
    best = c0
    for lam in GAIN_DAMPING:
        dc, dp = _step(problem, points, r, jc, jp, lam)
        c = float(cost(problem, *_apply(R, t, dc), points + dp))
        if c == c:
            best = min(best, c)
    return (c0 - best) / max(c0, 1e-300)


def solve(problem: dict, dtype, max_iters: int = 50, ftol: float = 1e-4, lam: float = 1e-3):
    """Levenberg-Marquardt from ``problem``'s cameras and points with the
    state, residuals, Jacobians and costs in ``dtype`` (the linear solves in
    at least float32): accept a step that lowers the cost and quarter the
    damping, else multiply it by 16; stop when an accepted step takes less
    than ``ftol`` of the cost. Returns (R, t, points, rmse) in ``dtype``."""
    problem = to_dtype(problem, dtype)
    R, t, points = problem["R"], problem["t"], problem["points"]
    c = cost(problem)
    for _ in range(max_iters):
        r = residuals(problem, R, t, points)
        jc, jp = _jacobians(problem, R, t, points)
        dc, dp = _step(problem, points, r, jc, jp, lam)
        new_r, new_t = _apply(R, t, dc)
        new_points = points + dp
        c_new = cost(problem, new_r, new_t, new_points)
        if bool(c_new < c):
            done = bool((c - c_new) < ftol * c)
            R, t, points, c, lam = new_r, new_t, new_points, c_new, lam / 4.0
            if done:
                break
        else:
            lam *= 16.0
            if lam > 1e10:
                break
    return R, t, points, rmse(problem, R, t, points)
