"""The plain reference of the odometry's tracking and relative pose.

Tracking: pyramidal Lucas-Kanade (a 5-tap Gaussian pyramid with replicate
borders, bilinear windows from an edge-padded image, central-difference
template gradients, an update frozen once it is under ``eps``; a point is
tracked where its template is well conditioned at every level and it ends
inside the image), over one image pair or a stack of pairs at once, and
``lk_update``, the Gauss-Newton update that one more iteration at full
resolution would make from a tracked position: near 0 where tracking
converged.

Scale: ``depth_scale``, one step of the chaining of the monocular scale by
the median ratio of a point's depths in two consecutive pairs, each pair
triangulated linearly with unit translation.

Relative pose: the pixel-scaled Sampson error of (R, t) over point pairs,
robustly weighted by a Cauchy kernel whose scale follows the residuals'
median absolute deviation (floored at 0.05 px), and ``pose_gain``, the
share of that weighted cost one float64 damped Gauss-Newton step on (rvec,
unit t) still removes, the weights held at the pose judged.

Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import jvp

__all__ = ["pyramid", "track", "lk_update", "triangulate", "depth_scale", "sampson_px", "pose_gain", "refine_pose"]

_GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(img):
    """The 5-tap blur of (..., H, W) images, replicate borders."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, 1, h, w)
    pad_y = F.pad(flat, (0, 0, 2, 2), mode="replicate")
    tmp = sum(_GAUSS5[i] * pad_y[:, :, i : i + h] for i in range(5))
    pad_x = F.pad(tmp, (2, 2, 0, 0), mode="replicate")
    return sum(_GAUSS5[i] * pad_x[:, :, :, i : i + w] for i in range(5)).reshape(img.shape)


def pyramid(img: torch.Tensor, levels: int) -> list:
    """Level 0 is ``img`` ((H, W) or a (B, H, W) stack); each next level the
    5-tap blur, every second pixel."""
    out = [img]
    for _ in range(levels - 1):
        out.append(_blur5(out[-1])[..., ::2, ::2].contiguous())
    return out


def _pad(img, pad):
    """Edge-pad (H, W) or (B, H, W) images by ``pad`` on every side."""
    pad_type = torch.float32 if img.dtype == torch.bfloat16 else img.dtype
    stack = img.reshape((-1,) + tuple(img.shape[-2:]))
    out = F.pad(stack[:, None].to(pad_type), (pad, pad, pad, pad), mode="replicate")[:, 0].to(img.dtype)
    return out if img.ndim == 3 else out[0]


def _window(img_p, pad: int, center, win: int, b=None):
    """(N, win, win) bilinear patches around ``center`` (N, 2) (x, y) of the
    image padded by ``pad`` (or of image ``b`` (N,) of a padded stack),
    clamped inside the padded image."""
    half = (win - 1) / 2.0
    hp, wp = img_p.shape[-2:]
    tl = center - half + pad
    t0 = torch.floor(tl)
    fx = (tl[:, 0] - t0[:, 0])[:, None, None]
    fy = (tl[:, 1] - t0[:, 1])[:, None, None]
    x0 = torch.clamp(t0[:, 0].to(torch.int64), 0, wp - win - 1)
    y0 = torch.clamp(t0[:, 1].to(torch.int64), 0, hp - win - 1)
    ar = torch.arange(win + 1, device=img_p.device)
    rows, cols = (y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]
    big = img_p[rows, cols] if b is None else img_p[b[:, None, None], rows, cols]
    return (big[:, :-1, :-1] * (1 - fy) * (1 - fx) + big[:, :-1, 1:] * (1 - fy) * fx
            + big[:, 1:, :-1] * fy * (1 - fx) + big[:, 1:, 1:] * fy * fx)


def _template(prev_img, prev_pt, win: int, b=None):
    pad = win + 3
    patch = _window(_pad(prev_img, pad), pad, prev_pt, win + 2, b)
    ix = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
    iy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5
    gxx, gxy, gyy = (ix * ix).sum((1, 2)), (ix * iy).sum((1, 2)), (iy * iy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-7
    den = torch.where(ok, det, torch.ones_like(det))
    return patch[:, 1:-1, 1:-1], ix, iy, (gyy / den, -gxy / den, gxx / den), ok


def _delta(tmpl, ix, iy, inv, curr_p, pad, pt, win, b=None):
    diff = tmpl - _window(curr_p, pad, pt, win, b)
    b0, b1 = (diff * ix).sum((1, 2)), (diff * iy).sum((1, 2))
    i00, i01, i11 = inv
    return torch.stack([i00 * b0 + i01 * b1, i01 * b0 + i11 * b1], dim=-1)


def track(prev_pyr, curr_pyr, points, win: int, max_iters: int, eps: float, b=None):
    """Pyramidal Lucas-Kanade of ``points`` (N, 2) from the previous to the
    current pyramid, in the pyramids' dtype; with ``b`` (N,), point i goes
    from image ``b[i]`` of a stack of previous pyramids to the same image of
    the current ones. Returns (tracked (N, 2), status (N,)): a point is
    tracked where its template is well conditioned (``det > 1e-7``) at every
    level and it ends inside the image."""
    points = points.to(prev_pyr[0].dtype)
    d = torch.zeros_like(points)
    status = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    for lvl in range(len(prev_pyr) - 1, -1, -1):
        pt = points / 2.0**lvl
        tmpl, ix, iy, inv, ok = _template(prev_pyr[lvl], pt, win, b)
        status &= ok
        pad = win + 1
        curr_p = _pad(curr_pyr[lvl], pad)
        for _ in range(max_iters):
            delta = _delta(tmpl, ix, iy, inv, curr_p, pad, pt + d, win, b)
            small = (delta * delta).sum(-1) < eps * eps
            d = torch.where((small | ~ok)[:, None], d, d + delta)
        if lvl > 0:
            d = d * 2.0
    out = points + d
    h, w = prev_pyr[0].shape[-2:]
    inside = (out[:, 0] >= 0) & (out[:, 0] < w) & (out[:, 1] >= 0) & (out[:, 1] < h)
    return out, status & inside


def lk_update(prev_img, curr_img, points, tracked, win: int, b=None) -> torch.Tensor:
    """|update| (N,) in px that one more full-resolution Lucas-Kanade
    iteration would make at ``tracked``, in float64 (of images ``b`` of
    stacks where ``b`` is given)."""
    prev_img, curr_img = prev_img.double(), curr_img.double()
    tmpl, ix, iy, inv, ok = _template(prev_img, points.double(), win, b)
    pad = win + 1
    delta = _delta(tmpl, ix, iy, inv, _pad(curr_img, pad), pad, tracked.double(), win, b)
    return torch.where(ok, delta.norm(dim=-1), torch.zeros_like(delta[:, 0]))


def triangulate(K, R, t, pts1, pts2):
    """Two-view linear triangulation (the unit null vector of the 4x4
    normal matrix of the four DLT rows) of pixel pairs ``pts1`` (camera
    [I | 0]) and ``pts2`` (camera [R | t]). The rows are formed in the
    inputs' dtype and solved in at least float32. Returns (N, 3) points in
    the first camera."""
    eye = torch.eye(3, 4, dtype=K.dtype, device=K.device)
    p1, p2 = K @ eye, K @ torch.cat([R, t[:, None]], dim=1)

    def rows(p, x):
        return torch.stack([x[:, 0:1] * p[2] - p[0], x[:, 1:2] * p[2] - p[1]], dim=1)

    design = torch.cat([rows(p1, pts1), rows(p2, pts2)], dim=1)
    solve_type = torch.promote_types(design.dtype, torch.float32)
    design = design.to(solve_type)
    vecs = torch.linalg.eigh(design.transpose(1, 2) @ design).eigenvectors[:, :, 0]
    return (vecs[:, :3] / vecs[:, 3:4]).to(pts1.dtype)


def depth_scale(K, R, t, pts1, pts2, inliers, prev_depth, prev_scale: float, dtype):
    """One step of the monocular scale chaining, in ``dtype``: triangulate
    the step's pairs with unit translation and take the median (the mean of
    the two middle values for an even count) of the previous step's depths
    over these depths, on the pairs that are inliers with a finite depth
    above 1e-3 in both steps, where there are 8 or more (else keep
    ``prev_scale``). Returns (scale, each pair's unscaled depth in the second
    camera, NaN where it is no inlier in front of the first)."""
    K, R, t = K.to(dtype), R.to(dtype), t.to(dtype)
    x = triangulate(K, R, t, pts1.to(dtype), pts2.to(dtype))
    depth = x[:, 2]
    ok = inliers & torch.isfinite(depth) & (depth > 1e-3)
    both = ok & torch.isfinite(prev_depth)
    if int(both.sum()) >= 8:
        ratios = torch.sort((prev_depth.to(dtype)[both] / depth[both]).double()).values
        n = ratios.shape[0]
        scale = float(0.5 * (ratios[(n - 1) // 2] + ratios[n // 2]))
    else:
        scale = float(prev_scale)
    cam_z = (x @ R.T + t)[:, 2]
    return scale, torch.where(ok, cam_z, torch.full_like(cam_z, float("nan")))


def _hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def _rotation(rvec):
    theta_sq = (rvec * rvec).sum(-1)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe)) / safe_sq)
    k = _hat(rvec)
    return torch.eye(3, dtype=rvec.dtype, device=rvec.device) + a * k + b * (k @ k)


def sampson_px(params, x1, x2, focal):
    """Pixel-scaled Sampson error (N,) of pose ``params`` (6,) [rvec, t]
    over homogeneous normalized rays ``x1``, ``x2`` (N, 3)."""
    t = params[3:] / torch.linalg.norm(params[3:])
    e = _hat(t) @ _rotation(params[:3])
    ex1 = x1 @ e.T
    etx2 = x2 @ e
    num = (x2 * ex1).sum(-1)
    den = torch.sqrt(torch.clamp(ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2, min=1e-12))
    return focal * num / den


def _rays(pts, K):
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _weights(r):
    med = torch.median(r.abs())
    c2 = torch.clamp((3.0 * 1.4826 * med) ** 2, min=0.05**2)
    return 1.0 / (1.0 + r * r / c2)


def _jacobian(params, x1, x2, focal):
    """d Sampson error / d params (N, 6), one forward-mode pass a column."""
    eye = torch.eye(6, dtype=params.dtype, device=params.device)
    cols = [jvp(lambda p: sampson_px(p, x1, x2, focal), (params,), (eye[k],))[1] for k in range(6)]
    return torch.stack(cols, -1)


def _gn_step(params, x1, x2, focal, w, lam, jac=None):
    """The damped Gauss-Newton step from ``params`` (its Jacobian ``jac``
    where already formed), the translation kept a unit vector."""
    r = sampson_px(params, x1, x2, focal)
    j = (_jacobian(params, x1, x2, focal) if jac is None else jac) * torch.sqrt(w)[:, None]
    jtj = j.T @ j
    g = j.T @ (r * torch.sqrt(w))
    solve_type = torch.promote_types(jtj.dtype, torch.float32)
    damp = lam * (torch.trace(jtj).to(solve_type) / 6.0 + 1e-12)
    step = torch.linalg.solve(jtj.to(solve_type) + damp * torch.eye(6, dtype=solve_type, device=jtj.device),
                              g.to(solve_type)).to(params.dtype)
    cand = params - step
    return torch.cat([cand[:3], cand[3:] / torch.linalg.norm(cand[3:])])


def pose_gain(rvec, tvec, pts1, pts2, K) -> float:
    """The share of the Cauchy-weighted Sampson cost at (rvec, tvec) over
    the pairs ``pts1`` -> ``pts2`` that one float64 Gauss-Newton step
    removes, over dampings 1e-8 .. 1 (0 where none lowers it)."""
    K = K.double()
    x1, x2 = _rays(pts1.double(), K), _rays(pts2.double(), K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    params = torch.cat([rvec.double(), tvec.double() / torch.linalg.norm(tvec.double())])
    r = sampson_px(params, x1, x2, focal)
    w = _weights(r)
    c0 = float((w * r * r).sum())
    best = c0
    jac = _jacobian(params, x1, x2, focal)
    for lam in (1e-8, 1e-6, 1e-4, 1e-2, 1.0):
        cand = _gn_step(params, x1, x2, focal, w, lam, jac)
        c = float((w * sampson_px(cand, x1, x2, focal) ** 2).sum())
        if c == c:
            best = min(best, c)
    return (c0 - best) / max(c0, 1e-300)


def refine_pose(rvec, tvec, pts1, pts2, K, dtype, iters: int = 15):
    """The reference's robust refinement of (rvec, tvec) in ``dtype``:
    re-weight, take a damped Gauss-Newton step when it lowers the weighted
    cost, ``iters`` times. Returns (rvec, unit tvec) in ``dtype``."""
    K = K.to(dtype)
    x1, x2 = _rays(pts1.to(dtype), K), _rays(pts2.to(dtype), K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    params = torch.cat([rvec.to(dtype), tvec.to(dtype) / torch.linalg.norm(tvec.to(dtype))])
    lam = 1e-4
    for _ in range(iters):
        r = sampson_px(params, x1, x2, focal)
        w = _weights(r)
        cand = _gn_step(params, x1, x2, focal, w, lam)
        if bool((w * sampson_px(cand, x1, x2, focal) ** 2).sum() < (w * r * r).sum()):
            params, lam = cand, max(lam * 0.3, 1e-8)
        else:
            lam *= 10.0
    return params[:3], params[3:]
