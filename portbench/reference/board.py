"""The plain reference of the board geometry: sub-pixel corners, then the
focal length and the keyframes' board poses.

Corners: the orthogonality iteration of ``cv2.cornerSubPix``. Around a
corner q, every pixel p of a ``win`` x ``win`` window (bilinear samples of
the edge-padded image, central-difference gradients g, a Gaussian taper w)
asks that g be orthogonal to p - q; the step is
``(sum w g g^T)^-1 sum w g g^T (p - q)``, frozen once it is under ``eps``.
``subpix_step`` is the step one more float64 iteration would take from a
refined corner: near 0 where refinement converged.

Focal and poses: the pinhole reprojection of the board's inner corners
(the X-Z plane, x fastest, ``side`` apart) with one focal length, the
principal point at the image centre and no distortion, as the configuration
states; the cost is half the sum of squared residuals against the refined
corners. ``gain`` is the share of that cost one float64 damped Gauss-Newton
step over the focal length and every pose still removes: near 0 where
calibration and pose refinement converged. ``solve`` is the reference's own
Levenberg-Marquardt loop in a chosen precision, for the control.

Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ba import exp_so3

__all__ = ["subpix", "subpix_step", "board_points", "cost", "gain", "solve"]

GAIN_DAMPING = (1e-8, 1e-6, 1e-4, 1e-2, 1.0)


def _windows(img_p, q, win: int, pad: int):
    """(B, N, win, win) gradients of bilinear (win+2)^2 windows around q
    (B, N, 2) in the padded images (B, Hp, Wp)."""
    size = win + 2
    half = (size - 1) / 2.0
    hp, wp = img_p.shape[-2:]
    tl = q - half + pad
    t0 = torch.floor(tl)
    fx = (tl[..., 0] - t0[..., 0])[..., None, None]
    fy = (tl[..., 1] - t0[..., 1])[..., None, None]
    x0 = torch.clamp(t0[..., 0].to(torch.int64), 0, wp - size - 1)
    y0 = torch.clamp(t0[..., 1].to(torch.int64), 0, hp - size - 1)
    ar = torch.arange(size + 1, device=img_p.device)
    b = torch.arange(img_p.shape[0], device=img_p.device)[:, None, None, None]
    big = img_p[b, (y0[..., None] + ar)[..., :, None], (x0[..., None] + ar)[..., None, :]]
    v = (big[..., :-1, :-1] * (1 - fy) * (1 - fx) + big[..., :-1, 1:] * (1 - fy) * fx
         + big[..., 1:, :-1] * fy * (1 - fx) + big[..., 1:, 1:] * fy * fx)
    return (v[..., 1:-1, 2:] - v[..., 1:-1, :-2]) * 0.5, (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) * 0.5


def _step(img_p, q, win: int, pad: int):
    """The orthogonality step (B, N, 2) at corners q and whether the
    window's gradient matrix is invertible."""
    half = win // 2
    d = torch.arange(-half, half + 1, dtype=q.dtype, device=q.device)
    taper = torch.exp(-((d / (half + 1.0)) ** 2) * 2.0)
    w = taper[:, None] * taper[None, :]
    ox, oy = d[None, :].expand(win, win), d[:, None].expand(win, win)
    gx, gy = _windows(img_p, q, win, pad)
    gxx, gxy, gyy = (w * gx * gx).sum((-2, -1)), (w * gx * gy).sum((-2, -1)), (w * gy * gy).sum((-2, -1))
    bx = (w * (gx * gx * ox + gx * gy * oy)).sum((-2, -1))
    by = (w * (gx * gy * ox + gy * gy * oy)).sum((-2, -1))
    det = gxx * gyy - gxy * gxy
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    return torch.stack([(gyy * bx - gxy * by) * inv, (gxx * by - gxy * bx) * inv], dim=-1), ok


def _padded(img, win: int, dtype):
    pad = win + 3
    pad_type = torch.float32 if dtype == torch.bfloat16 else dtype
    return F.pad(img.to(pad_type)[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0].to(dtype), pad


def subpix(img, corners, win: int, iters: int, eps: float, dtype):
    """Refine (B, N, 2) corners on (B, H, W) images in ``dtype``."""
    img_p, pad = _padded(img, win, dtype)
    q = corners.to(dtype)
    for _ in range(iters):
        delta, ok = _step(img_p, q, win, pad)
        small = (delta * delta).sum(-1) < eps * eps
        q = torch.where((small | ~ok)[..., None], q, q + delta)
    return q


def subpix_step(img, corners, win: int):
    """(B, N) length in px of the step one more float64 iteration takes
    from ``corners``."""
    img_p, pad = _padded(img, win, torch.float64)
    delta, ok = _step(img_p, corners.to(torch.float64), win, pad)
    return torch.where(ok, delta.norm(dim=-1), torch.zeros_like(delta[..., 0]))


def board_points(pattern, side: float, dtype=torch.float64, device=None):
    """(N, 3) inner corners in the X-Z plane, x fastest."""
    x, y = pattern
    gz, gx = torch.meshgrid(torch.arange(y, dtype=dtype, device=device), torch.arange(x, dtype=dtype, device=device),
                            indexing="ij")
    grid = torch.stack([gx.reshape(-1), torch.zeros(x * y, dtype=dtype, device=device), gz.reshape(-1)], dim=-1)
    return grid * side


def _project(board, R, t, focal, centre):
    """(B, N, 2) pixels of the board seen by (B, 3, 3) R and (B, 3) t."""
    cam = torch.einsum("bij,nj->bni", R, board) + t[:, None, :]
    return focal * cam[..., :2] / cam[..., 2:3] + centre


def cost(problem: dict, R=None, t=None, focal=None):
    R = problem["R"] if R is None else R
    t = problem["t"] if t is None else t
    focal = problem["focal"] if focal is None else focal
    r = _project(problem["board"], R, t, focal, problem["centre"]) - problem["corners"]
    return 0.5 * torch.sum(r * r)


def _normal(problem: dict, R, t, focal):
    """The residuals (B*N*2,) and the Jacobian (B*N*2, 6B + 1) over each
    pose's left rotation and translation and the focal length."""
    board, centre, corners = problem["board"], problem["centre"], problem["corners"]
    bsz, n = corners.shape[:2]
    cam = torch.einsum("bij,nj->bni", R, board) + t[:, None, :]
    r = (focal * cam[..., :2] / cam[..., 2:3] + centre - corners).reshape(-1)
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    # d pixel / d camera point, (B, N, 2, 3).
    dp = torch.zeros(bsz, n, 2, 3, dtype=cam.dtype, device=cam.device)
    dp[..., 0, 0] = focal / z
    dp[..., 0, 2] = -focal * x / (z * z)
    dp[..., 1, 1] = focal / z
    dp[..., 1, 2] = -focal * y / (z * z)
    # d camera point / d (left rotation d, translation): [-[Rp]x, I].
    rp = cam - t[:, None, :]
    skew = torch.zeros(bsz, n, 3, 3, dtype=cam.dtype, device=cam.device)
    skew[..., 0, 1], skew[..., 0, 2] = rp[..., 2], -rp[..., 1]
    skew[..., 1, 0], skew[..., 1, 2] = -rp[..., 2], rp[..., 0]
    skew[..., 2, 0], skew[..., 2, 1] = rp[..., 1], -rp[..., 0]
    eye = torch.eye(3, dtype=cam.dtype, device=cam.device).expand(bsz, n, 3, 3)
    jpose = dp @ torch.cat([skew, eye], dim=-1)  # (B, N, 2, 6)
    jac = torch.zeros(bsz, n, 2, 6 * bsz + 1, dtype=cam.dtype, device=cam.device)
    for b in range(bsz):
        jac[b, :, :, 6 * b : 6 * b + 6] = jpose[b]
    jac[..., 0, -1] = x / z
    jac[..., 1, -1] = y / z
    return r, jac.reshape(-1, 6 * bsz + 1)


def _apply(R, t, focal, delta):
    d = delta[:-1].reshape(-1, 6)
    return exp_so3(d[:, :3]) @ R, t + d[:, 3:], focal + delta[-1]


def _solve_step(r, jac, lam: float):
    solve_type = torch.promote_types(jac.dtype, torch.float32)
    jac, r = jac.to(solve_type), r.to(solve_type)
    jtj = jac.T @ jac
    a = jtj + lam * torch.diag(torch.diagonal(jtj)) + 1e-12 * torch.eye(jtj.shape[0], dtype=solve_type,
                                                                          device=jtj.device)
    return -torch.linalg.solve(a, jac.T @ r)


def gain(problem: dict) -> float:
    """The largest share of the cost at ``problem``'s poses and focal
    length that one float64 damped Gauss-Newton step removes, over the
    dampings ``GAIN_DAMPING`` (0 where none lowers it)."""
    problem = {k: v.to(torch.float64) if torch.is_tensor(v) else v for k, v in problem.items()}
    R, t, focal = problem["R"], problem["t"], problem["focal"]
    c0 = float(cost(problem))
    r, jac = _normal(problem, R, t, focal)
    best = c0
    for lam in GAIN_DAMPING:
        c = float(cost(problem, *_apply(R, t, focal, _solve_step(r, jac, lam))))
        if c == c:
            best = min(best, c)
    return (c0 - best) / max(c0, 1e-300)


def solve(problem: dict, dtype, max_iters: int = 100, ftol: float = 1e-7, lam: float = 1e-3):
    """Levenberg-Marquardt over the poses and the focal length from
    ``problem``'s, with the state, residuals and Jacobian in ``dtype`` (the
    linear solve in at least float32): accept a step that lowers the cost and
    quarter the damping, else multiply it by 16; stop when an accepted step
    takes less than ``ftol`` of the cost. Returns (R, t, focal) in
    ``dtype``."""
    problem = {k: v.to(dtype) if torch.is_tensor(v) else v for k, v in problem.items()}
    R, t, focal = problem["R"], problem["t"], problem["focal"]
    c = cost(problem)
    for _ in range(max_iters):
        r, jac = _normal(problem, R, t, focal)
        new = _apply(R, t, focal, _solve_step(r, jac, lam).to(dtype))
        c_new = cost(problem, *new)
        if bool(c_new < c):
            done = bool((c - c_new) < ftol * c)
            (R, t, focal), c, lam = new, c_new, lam / 4.0
            if done:
                break
        else:
            lam *= 16.0
            if lam > 1e10:
                break
    return R, t, focal
