"""Camera calibration from planar chessboard views: Zhang init + joint LM
(torch twin of ``meatmodeler_tpu/geometry/calibration.py``).

The joint LM (:func:`run_lm`) is one launch of the hand-written kernel
``csrc/calib.cu`` on the card (``calibration_cuda``): every iteration and
both damping trials, the Jacobian's arrowhead blocks and the Schur solve,
nothing read back until it ends. On the CPU it is the plain version
(:func:`run_lm_reference`): a Python loop that reads one flag back per
iteration, the Jacobian of the joint residual from ``torch.func``
forward-mode AD, as ``jax.jacfwd`` serves the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from meatmodeler_tpu_torch.geometry import calibration_cuda
from meatmodeler_tpu_torch.geometry import distortion as distortion_mod
from meatmodeler_tpu_torch.geometry import pnp, projection, so3
from meatmodeler_tpu_torch.geometry.homography import find_homography
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.utils.numerics import nanmedian, one_thread_at_a_time

__all__ = ["chessboard_object_points", "calibrate", "CalibrationResult", "initial_theta", "run_lm", "run_lm_reference"]


class CalibrationResult(NamedTuple):
    intrinsics: torch.Tensor  # (3, 3)
    dist: torch.Tensor  # (5,) [k1, k2, p1, p2, k3]
    poses: torch.Tensor  # (F, 6) per-view [rvec, tvec]
    rms: torch.Tensor  # scalar reprojection RMS in pixels


def chessboard_object_points(
    pattern: Tuple[int, int], dtype=torch.float32, device=None
) -> torch.Tensor:
    """Planar (z = 0) grid, x fastest then y, unit squares: (x*y, 3)."""
    x, y = pattern
    gx, gy = torch.meshgrid(
        torch.arange(x, dtype=dtype, device=device),
        torch.arange(y, dtype=dtype, device=device),
        indexing="xy",
    )
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return torch.cat([grid, torch.zeros((x * y, 1), dtype=dtype, device=device)], dim=-1)


def _k_matrix(fx, fy, cx, cy):
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack(
        [torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]), torch.stack([zero, zero, one])]
    )


def _intrinsics_from_homographies(homs: torch.Tensor, view_mask=None) -> torch.Tensor:
    """Closed-form K from >= 3 plane homographies (Zhang's B-matrix solve)."""

    def v_ij(h, i, j):
        return torch.stack(
            [
                h[:, 0, i] * h[:, 0, j],
                h[:, 0, i] * h[:, 1, j] + h[:, 1, i] * h[:, 0, j],
                h[:, 1, i] * h[:, 1, j],
                h[:, 2, i] * h[:, 0, j] + h[:, 0, i] * h[:, 2, j],
                h[:, 2, i] * h[:, 1, j] + h[:, 1, i] * h[:, 2, j],
                h[:, 2, i] * h[:, 2, j],
            ],
            dim=-1,
        )

    v = torch.stack([v_ij(homs, 0, 1), v_ij(homs, 0, 0) - v_ij(homs, 1, 1)], dim=1)
    if view_mask is not None:
        v = v * view_mask.to(v.dtype)[:, None, None]
    v = v.reshape(-1, 6)
    _, vecs = torch.linalg.eigh(v.T @ v)
    b11, b12, b22, b13, b23, b33 = vecs[:, 0].unbind(0)
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = torch.sqrt(torch.abs(lam / b11))
    fy = torch.sqrt(torch.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    return _k_matrix(fx, fy, cx, cy)


def _pose_from_homography(h: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) z=0-plane homographies -> (F, 6) extrinsic inits."""
    m = torch.linalg.solve(intrinsics, h)
    scale = 0.5 * (torch.linalg.norm(m[..., :, 0], dim=-1) + torch.linalg.norm(m[..., :, 1], dim=-1))
    m = m / torch.clamp(scale, min=1e-12)[..., None, None]
    m = m * torch.where(m[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    r1, r2, tvec = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    rot = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1)
    return torch.cat([so3.log(pnp._orthonormalize(rot)), tvec], dim=-1)


def _project_distorted(obj_pts, poses, intrinsics, dist):
    """(N, 3) board points through (F, 6) poses with distortion -> (F, N, 2)."""
    cam = projection.rotate_points(obj_pts[None], poses[:, None, :3]) + poses[:, None, 3:6]
    xy = cam[..., :2] / cam[..., 2:3]
    xyd = distortion_mod.distort_normalized(xy, dist)
    f = torch.stack([intrinsics[0, 0], intrinsics[1, 1]])
    c = torch.stack([intrinsics[0, 2], intrinsics[1, 2]])
    return xyd * f + c


def _single_focal_init(homs: torch.Tensor, cx, cy, view_mask=None) -> torch.Tensor:
    """Closed-form focal with a known principal point and zero skew."""
    dtype, device = homs.dtype, homs.device
    c_mat = torch.tensor(
        [[1.0, 0.0, -cx], [0.0, 1.0, -cy], [-cx, -cy, cx * cx + cy * cy]],
        dtype=dtype, device=device,
    )
    e_mat = torch.zeros((3, 3), dtype=dtype, device=device)
    e_mat[2, 2] = 1.0
    h1, h2 = homs[:, :, 0], homs[:, :, 1]

    def quad(u, m, v):
        return torch.einsum("fi,ij,fj->f", u, m, v)

    a = torch.stack([quad(h1, c_mat, h2), quad(h1, c_mat, h1) - quad(h2, c_mat, h2)], dim=1)
    b = torch.stack([quad(h1, e_mat, h2), quad(h1, e_mat, h1) - quad(h2, e_mat, h2)], dim=1)
    if view_mask is not None:
        vm = view_mask.to(dtype)[:, None]
        a = a * vm
        b = b * vm
    x = -torch.sum(a * b) / torch.clamp(torch.sum(a * a), min=1e-12)
    return 1.0 / torch.sqrt(torch.clamp(x, 1e-12, 1e2))


def calibrate(
    img_points: torch.Tensor,
    obj_points: torch.Tensor,
    image_size: Tuple[float, float],
    num_dist: int = 5,
    max_iters: int = 30,
    fix_principal_point: bool = False,
    single_focal: bool = False,
    view_mask: Optional[torch.Tensor] = None,
) -> CalibrationResult:
    """Calibrate from F planar views.

    img_points (F, N, 2) corner pixels, obj_points (N, 3) with z = 0,
    image_size (w, h). ``view_mask`` (F,) bool marks real views: masked
    views contribute nothing to K, dist or rms. Returns
    CalibrationResult(K, dist5, per-view poses, RMS).
    """
    f, n = img_points.shape[0], img_points.shape[1]
    plane = obj_points[:, :2]
    w, h = float(image_size[0]), float(image_size[1])
    n_intr = (1 if single_focal else 2) + (0 if fix_principal_point else 2) + num_dist
    layout = dict(image_size=(w, h), num_dist=num_dist, fix_principal_point=fix_principal_point,
                  single_focal=single_focal)
    lm = dict(layout, max_iters=max_iters, view_mask=view_mask)

    def residual(theta):
        return _residual(theta, img_points, obj_points, view_mask=view_mask, **layout)

    theta0 = initial_theta(img_points, obj_points, view_mask=view_mask, **layout)
    theta, cost = run_lm(theta0, img_points, obj_points, **lm)

    # Second pass: re-initialise only the outlier views (wrong basin of the
    # planar two-fold ambiguity) with two-candidate planar PnP under the
    # current intrinsics, and keep the re-run if it is better.
    intr1, dist1, poses1 = _unpack(theta, f, **layout)
    und = distortion_mod.undistort_pixels(img_points, intr1, dist1)
    res1 = residual(theta).reshape(f, n, 2)
    frame_err = torch.sqrt(torch.sum(res1**2, dim=-1)).mean(dim=1)
    if view_mask is None:
        bad_frame = frame_err > 3.0 * nanmedian(frame_err) + 0.5
    else:
        med_err = nanmedian(torch.where(view_mask, frame_err, torch.nan))
        bad_frame = view_mask & (frame_err > 3.0 * med_err + 0.5)
    poses_pnp = pnp.solve_pnp_batch(plane, (0, 1), obj_points, und, intr1)
    poses_mix = torch.where(bad_frame[:, None], poses_pnp, poses1)
    theta2, cost2 = run_lm(torch.cat([theta[:n_intr], poses_mix.reshape(-1)]), img_points, obj_points, **lm)
    better = cost2 < cost
    theta = torch.where(better, theta2, theta)
    cost = torch.where(better, cost2, cost)

    intr, dist, poses = _unpack(theta, f, **layout)
    n_real = f if view_mask is None else torch.clamp(view_mask.sum(), min=1)
    rms = torch.sqrt(2.0 * cost / (n_real * n))
    return CalibrationResult(intr, dist, poses, rms)


def initial_theta(
    img_points: torch.Tensor,
    obj_points: torch.Tensor,
    image_size: Tuple[float, float],
    num_dist: int,
    fix_principal_point: bool,
    single_focal: bool,
    view_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The LM's start in :func:`_unpack`'s layout: Zhang's closed-form K (or
    the single-focal one with the principal point at the image centre),
    zero distortion, and each view's pose from its homography."""
    dtype, device = img_points.dtype, img_points.device
    w, h = float(image_size[0]), float(image_size[1])
    homs = find_homography(obj_points[:, :2], img_points)

    if fix_principal_point or single_focal:
        cx0, cy0 = 0.5 * w, 0.5 * h
        f0 = _single_focal_init(homs, cx0, cy0, view_mask)
        f0 = torch.where(torch.isfinite(f0), f0, torch.full_like(f0, 1.2 * w))
        k_init = _k_matrix(f0, f0, torch.full_like(f0, cx0), torch.full_like(f0, cy0))
    else:
        k_init = _intrinsics_from_homographies(homs, view_mask)
        k_fallback = torch.tensor(
            [[1.2 * w, 0.0, 0.5 * w], [0.0, 1.2 * w, 0.5 * h], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device,
        )
        k_init = torch.where(torch.all(torch.isfinite(k_init)), k_init, k_fallback)

    poses0 = _pose_from_homography(homs, k_init)
    intr0 = [k_init[0, 0]] if single_focal else [k_init[0, 0], k_init[1, 1]]
    if not fix_principal_point:
        intr0 += [k_init[0, 2], k_init[1, 2]]
    return torch.cat([torch.stack(intr0), torch.zeros(num_dist, dtype=dtype, device=device), poses0.reshape(-1)])


def _unpack(theta, f: int, image_size, num_dist: int, fix_principal_point: bool, single_focal: bool):
    """LM parameters [focal(s), principal point unless fixed at the image
    centre, num_dist distortion coefficients, 6 per view] -> (K, dist (5,),
    poses (F, 6))."""
    w, h = float(image_size[0]), float(image_size[1])
    n_focal = 1 if single_focal else 2
    n_pp = 0 if fix_principal_point else 2
    n_intr = n_focal + n_pp + num_dist
    fx = theta[0]
    fy = theta[0] if single_focal else theta[1]
    if fix_principal_point:
        cx, cy = torch.full_like(fx, 0.5 * w), torch.full_like(fx, 0.5 * h)
    else:
        cx, cy = theta[n_focal], theta[n_focal + 1]
    intr = _k_matrix(fx, fy, cx, cy)
    dist = torch.cat(
        [theta[n_focal + n_pp : n_intr], torch.zeros(5 - num_dist, dtype=theta.dtype, device=theta.device)]
    )
    return intr, dist, theta[n_intr:].reshape(f, 6)


def _residual(theta, img_points, obj_points, image_size, num_dist, fix_principal_point, single_focal, view_mask=None):
    """The joint residual (2NF,) of ``theta``; masked views give zeros."""
    intr, dist, poses = _unpack(theta, img_points.shape[0], image_size, num_dist, fix_principal_point, single_focal)
    r = _project_distorted(obj_points, poses, intr, dist) - img_points
    if view_mask is not None:
        r = r * view_mask.to(r.dtype)[:, None, None]
    return r.reshape(-1)


def run_lm(
    theta0: torch.Tensor,
    img_points: torch.Tensor,
    obj_points: torch.Tensor,
    image_size: Tuple[float, float],
    num_dist: int,
    max_iters: int,
    fix_principal_point: bool,
    single_focal: bool,
    view_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``calibrate``'s joint Levenberg-Marquardt from ``theta0`` (the
    layout of :func:`_unpack`): returns (theta, cost = 0.5 sum r^2). One
    launch of the CUDA kernel (``calibration_cuda``) for tensors on the
    card, the plain version for tensors on the CPU."""
    args = (theta0, img_points, obj_points, image_size, num_dist, max_iters, fix_principal_point, single_focal,
            view_mask)
    if cuda_build.on_card(img_points):
        theta, cost, _ = calibration_cuda.calib_lm(*args)
        return theta, cost
    return run_lm_reference(*args)


def run_lm_reference(
    theta0: torch.Tensor,
    img_points: torch.Tensor,
    obj_points: torch.Tensor,
    image_size: Tuple[float, float],
    num_dist: int,
    max_iters: int,
    fix_principal_point: bool,
    single_focal: bool,
    view_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`run_lm`: the dense Jacobian by
    ``jacfwd`` behind the forward-AD lock, the dense damped solve of both
    trials, and one flag read back per iteration."""
    dtype, device = theta0.dtype, theta0.device
    layout = dict(image_size=image_size, num_dist=num_dist, fix_principal_point=fix_principal_point,
                  single_focal=single_focal, view_mask=view_mask)

    def residual(theta):
        return _residual(theta, img_points, obj_points, **layout)

    def cost_of(theta):
        return 0.5 * torch.sum(residual(theta) ** 2)

    jac_fn = one_thread_at_a_time(jacfwd(residual))
    theta, lam, cost = theta0, torch.tensor(1e-3, dtype=dtype, device=device), cost_of(theta0)
    for _ in range(max_iters):
        r = residual(theta)
        jac = jac_fn(theta)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        diag = torch.diag(torch.clamp(torch.diagonal(jtj), min=1e-12))

        def try_lambda(lam_try):
            new_theta = theta - torch.linalg.solve(jtj + lam_try * diag, jtr)
            return new_theta, cost_of(new_theta)

        t1, c1 = try_lambda(lam)
        t2, c2 = try_lambda(lam * 10.0)
        use1 = c1 <= c2
        cand_theta = torch.where(use1, t1, t2)
        cand_cost = torch.where(use1, c1, c2)
        cand_lam = torch.where(use1, lam * 0.5, lam * 10.0)
        improved = cand_cost < cost
        new_cost = torch.where(improved, cand_cost, cost)
        done = (~improved & (lam > 1e8)) | (torch.abs(cost - new_cost) / torch.clamp(cost, min=1e-12) < 1e-10)
        theta = torch.where(improved, cand_theta, theta)
        lam = torch.where(improved, cand_lam, lam * 10.0)
        cost = new_cost
        if bool(done):
            break
    return theta, cost
