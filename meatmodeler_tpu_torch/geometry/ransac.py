"""Batched RANSAC for two-view geometry (torch twin of
``meatmodeler_tpu/geometry/ransac.py``).

Same algorithms as the reference: thousands of 8-point (or 4-point
homography) hypotheses solved at once, all scored against all matches, the
best picked by ``argmax``; the LO-RANSAC relative pose decomposes its top
candidates and the homography's 8 decompositions, refines them as one batch
and re-scores them.

On the card ``estimate_relative_pose`` runs as hand-written CUDA kernels
with no host read: the essential hypotheses and their consensus counts
(:func:`essential_hypotheses`), the homography's hypotheses and its polish
and decomposition (:func:`homography_hypotheses`,
:func:`homography_polish`), the cheirality vote (:func:`recover_pose`) and
the candidates' scores (:func:`score_candidates`) launch ``ransac_hyp_cuda``
(``csrc/relpose_hyp.cu``), the refinement (:func:`refine_relative_pose`)
``ransac_cuda`` (``csrc/relpose.cu``). On the CPU each is its plain version,
the function of the same name with ``_reference`` appended. The draws, the
top-k sort and the final ordered argmax are torch operations on either.

Every hypothesis draw goes through :func:`sample_subsets`, which draws
uniformly among the valid entries, with replacement, from an explicit
``torch.Generator`` on the tensors' device. It stands for the reference's
``jax.random.categorical`` over a masked logit row (the threefry stream
cannot be reproduced in torch), so tests hand both packages the same
hypotheses by replacing this one function.

``find_fundamental``, ``find_essential`` and the plain versions use batched
``torch.linalg`` eigen and SVD solves, which on CUDA synchronize with the
host to check their results (PyTorch's doing, not a readback of this
module).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from meatmodeler_tpu_torch.geometry import ransac_cuda, ransac_hyp_cuda, so3
from meatmodeler_tpu_torch.geometry.homography import find_homography
from meatmodeler_tpu_torch.utils.numerics import nanmedian, one_thread_at_a_time

__all__ = [
    "RansacResult",
    "sample_subsets",
    "find_fundamental",
    "find_essential",
    "recover_pose",
    "recover_pose_reference",
    "refine_relative_pose",
    "refine_relative_pose_reference",
    "estimate_relative_pose",
    "essential_hypotheses",
    "essential_hypotheses_reference",
    "find_homography_ransac",
    "homography_hypotheses",
    "homography_hypotheses_reference",
    "homography_polish",
    "homography_polish_reference",
    "score_candidates",
    "score_candidates_reference",
]


class RansacResult(NamedTuple):
    matrix: torch.Tensor  # (3, 3) best F, E or H
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # scalar int
    residuals: torch.Tensor  # (N,) residuals under the best model (inf where masked)


def sample_subsets(
    mask: torch.Tensor, num_hypotheses: int, size: int, generator: torch.Generator
) -> torch.Tensor:
    """(num_hypotheses, size) int64 indices drawn uniformly among the True
    entries of ``mask``, with replacement (duplicates only make a
    degenerate hypothesis that scores poorly). An all-False mask yields
    index N - 1 everywhere, a hypothesis no valid point supports."""
    counts = torch.cumsum(mask.to(torch.int64), 0)
    n_valid = torch.clamp(counts[-1], min=1).to(torch.float64)
    u = torch.rand((num_hypotheses, size), generator=generator, device=mask.device, dtype=torch.float64)
    rank = torch.clamp(torch.floor(u * n_valid).to(torch.int64), max=counts.shape[0] - 1)
    idx = torch.searchsorted(counts, rank, right=True)
    return torch.clamp(idx, max=mask.shape[0] - 1)


def default_generator(device) -> torch.Generator:
    """The draws' generator when the caller gives none: seed 0 on ``device``
    (the reference's ``PRNGKey(0)``)."""
    return torch.Generator(device=device).manual_seed(0)


def _homog(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the valid points only."""
    n = torch.clamp(mask.sum(), min=1).to(pts.dtype)
    centroid = torch.sum(torch.where(mask[:, None], pts, torch.zeros_like(pts)), dim=0) / n
    centered = pts - centroid
    dist = torch.where(mask, torch.linalg.norm(centered, dim=1), torch.zeros_like(centered[:, 0]))
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(dist) / n, min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack(
        [
            torch.stack([scale, zero, -scale * centroid[0]]),
            torch.stack([zero, scale, -scale * centroid[1]]),
            torch.stack([zero, zero, one]),
        ]
    )
    return centered * scale, t


def _design_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The 8-point system's rows (..., N, 9) of (..., N, 2) correspondences."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)


def _finite_batch(a: torch.Tensor):
    """(matrices with every non-finite one replaced by the identity, (...)
    mask of the finite ones). ``torch.linalg`` raises on a NaN or infinite
    matrix where the reference's solvers return NaN (a hypothesis drawn
    from an empty mask, say); its callers put NaN back where the mask is
    False."""
    ok = torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(ok[..., None, None], a, eye), ok


def _nan_where_not(ok: torch.Tensor, x: torch.Tensor, event_dims: int) -> torch.Tensor:
    return torch.where(ok.reshape(ok.shape + (1,) * event_dims), x, torch.full_like(x, torch.nan))


def _eigh(a: torch.Tensor):
    a, ok = _finite_batch(a)
    vals, vecs = torch.linalg.eigh(a)
    return _nan_where_not(ok, vals, 1), _nan_where_not(ok, vecs, 2)


def _svd(a: torch.Tensor):
    a, ok = _finite_batch(a)
    u, s, vt = torch.linalg.svd(a)
    return _nan_where_not(ok, u, 2), _nan_where_not(ok, s, 1), _nan_where_not(ok, vt, 2)


def _smallest_eigvec(ata: torch.Tensor) -> torch.Tensor:
    """(..., 9, 9) symmetric -> (..., 3, 3) eigenvector of the least eigenvalue."""
    _, vecs = _eigh(ata)
    return vecs[..., :, 0].reshape(ata.shape[:-2] + (3, 3))


def _rank2(f: torch.Tensor) -> torch.Tensor:
    u, s, vt = _svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ torch.diag_embed(s) @ vt


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point solve, batched: (..., 8, 2) x 2 -> (..., 3, 3),
    rank 2 enforced by SVD."""
    a = _design_rows(p1, p2)
    return _rank2(_smallest_eigvec(a.transpose(-1, -2) @ a))


def _sampson(f: torch.Tensor, p1h: torch.Tensor, p2h: torch.Tensor) -> torch.Tensor:
    """Sampson distance of each correspondence under F: (..., 3, 3) with
    (N, 3) homogeneous points -> (..., N)."""
    fp1 = torch.einsum("...ij,nj->...ni", f, p1h)  # F @ p1
    ftp2 = torch.einsum("...ji,nj->...ni", f, p2h)  # F^T @ p2
    num = torch.sum(p2h * fp1, dim=-1) ** 2
    den = fp1[..., 0] ** 2 + fp1[..., 1] ** 2 + ftp2[..., 0] ** 2 + ftp2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _keep_if_better(better, new, old):
    return tuple(torch.where(better, a, b) for a, b in zip(new, old))


def find_fundamental(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
) -> RansacResult:
    """Batched-RANSAC fundamental matrix; ``matrix`` maps pts1 to epipolar
    lines in image 2. ``threshold`` is the inlier Sampson distance (px)."""
    generator = generator or default_generator(pts1.device)
    n1, t1 = _normalize(pts1, mask)
    n2, t2 = _normalize(pts2, mask)
    idx = sample_subsets(mask, num_hypotheses, 8, generator)
    fs_px = t2.T @ _eight_point(n1[idx], n2[idx]) @ t1  # (H, 3, 3)
    p1px, p2px = _homog(pts1), _homog(pts2)
    thr2 = threshold * threshold
    counts = torch.sum((_sampson(fs_px, p1px, p2px) < thr2) & mask, dim=1)
    f_best = fs_px[torch.argmax(counts)]
    res = _sampson(f_best, p1px, p2px)
    inliers = (res < thr2) & mask

    # Polish: the 8-point system over all inliers, kept while consensus
    # does not shrink.
    a_all = _design_rows(n1, n2)
    for _ in range(2):
        aw = a_all * inliers.to(a_all.dtype)[:, None]
        f_ref = t2.T @ _rank2(_smallest_eigvec(aw.T @ aw)) @ t1
        res_ref = _sampson(f_ref, p1px, p2px)
        inl_ref = (res_ref < thr2) & mask
        better = inl_ref.sum() >= inliers.sum()
        f_best, res, inliers = _keep_if_better(better, (f_ref, res_ref, inl_ref), (f_best, res, inliers))
    f22 = f_best[2, 2]
    return RansacResult(
        matrix=f_best / torch.where(torch.abs(f22) > 1e-12, f22, torch.ones_like(f22)),
        inliers=inliers,
        num_inliers=inliers.sum(),
        residuals=torch.where(mask, res, torch.full_like(res, torch.inf)),
    )


def _project_to_essential(f: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix, batched: singular values -> (s, s, 0), unit norm."""
    u, s, vt = _svd(f)
    s_mean = 0.5 * (s[..., 0] + s[..., 1])
    diag = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    e = u @ torch.diag_embed(diag) @ vt
    return e / torch.clamp(torch.linalg.norm(e, dim=(-2, -1), keepdim=True), min=1e-12)


def _rays(pts: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image coordinates under K."""
    f = torch.stack([intrinsics[0, 0], intrinsics[1, 1]])
    c = torch.stack([intrinsics[0, 2], intrinsics[1, 2]])
    return (pts - c) / f


def find_essential(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
) -> RansacResult:
    """Essential matrix via batched RANSAC on normalized rays: every
    hypothesis is projected onto the essential manifold before scoring, and
    the winner polished by a Cauchy-IRLS re-solve (see the reference)."""
    generator = generator or default_generator(pts1.device)
    n1, n2 = _rays(pts1, intrinsics), _rays(pts2, intrinsics)
    thr = threshold / (0.5 * (intrinsics[0, 0] + intrinsics[1, 1]))
    thr2 = thr * thr
    idx = sample_subsets(mask, num_hypotheses, 8, generator)
    n1h, t1 = _normalize(n1, mask)
    n2h, t2 = _normalize(n2, mask)
    es = _project_to_essential(t2.T @ _eight_point(n1h[idx], n2h[idx]) @ t1)

    x1, x2 = _homog(n1), _homog(n2)
    counts = torch.sum((_sampson(es, x1, x2) < thr2) & mask, dim=1)
    e_best = es[torch.argmax(counts)]
    res = _sampson(e_best, x1, x2)
    inliers = (res < thr2) & mask

    a_all = _design_rows(n1h, n2h)
    for _ in range(3):
        # MAD-adaptive Cauchy scale.
        med2 = nanmedian(torch.where(inliers, res, torch.full_like(res, torch.nan)))
        c2 = torch.minimum(torch.clamp((3.0 * 1.4826) ** 2 * med2, min=1e-12), thr2)
        w = inliers.to(a_all.dtype) / (1.0 + res / c2)
        aw = a_all * w[:, None]
        e_ref = _project_to_essential(t2.T @ _smallest_eigvec(aw.T @ aw) @ t1)
        res_ref = _sampson(e_ref, x1, x2)
        inl_ref = (res_ref < thr2) & mask
        better = inl_ref.sum() >= inliers.sum()
        e_best, res, inliers = _keep_if_better(better, (e_ref, res_ref, inl_ref), (e_best, res, inliers))
    return RansacResult(
        matrix=e_best,
        inliers=inliers,
        num_inliers=inliers.sum(),
        residuals=torch.where(mask, res, torch.full_like(res, torch.inf)),
    )


def _triangulate_midpoint(rot: torch.Tensor, tvec: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor):
    """Closed-form two-ray midpoint triangulation in normalized coordinates,
    batched over the leading dims of ``rot`` (..., 3, 3) / ``tvec`` (..., 3)
    for (N, 2) rays. Returns (X (..., N, 3) in camera 1, z1 (..., N), z2
    (..., N)); near-parallel rays give z = 0 (cheirality failures)."""
    d1, d2 = _homog(n1), _homog(n2)
    rd1 = torch.einsum("...ij,nj->...ni", rot, d1)  # R d1, per point
    a11 = torch.sum(rd1 * rd1, dim=-1)
    a12 = -torch.sum(rd1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    t = tvec[..., None, :]
    b1 = -torch.sum(rd1 * t, dim=-1)
    b2 = torch.sum(d2 * t, dim=-1)
    det = a11 * a22 - a12 * a12
    bad = torch.abs(det) < 1e-12
    safe_det = torch.where(bad, torch.ones_like(det), det)
    z1 = torch.where(bad, torch.zeros_like(det), (a22 * b1 - a12 * b2) / safe_det)
    z2 = torch.where(bad, torch.zeros_like(det), (a11 * b2 - a12 * b1) / safe_det)
    x1 = z1[..., None] * d1
    x2_in1 = torch.einsum("...nj,...jk->...nk", z2[..., None] * d2 - t, rot)
    return 0.5 * (x1 + x2_in1), z1, z2


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def recover_pose(
    essential: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    thr2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`recover_pose_reference` in one launch of the CUDA kernel
    (``csrc/relpose_hyp.cu``) for tensors on the card, the plain version for
    tensors on the CPU. Arguments and results as the plain version's."""
    if essential.device.type == "cuda":
        batch, n = essential.shape[:-2], pts1.shape[0]
        m = mask if mask.ndim == 1 else mask.expand(batch + (n,)).reshape(-1, n)
        rv, tv, votes = ransac_hyp_cuda.recover_pose(essential.reshape(-1, 3, 3), pts1, pts2, m, intrinsics, thr2)
        return rv.reshape(batch + (3,)), tv.reshape(batch + (3,)), votes.reshape(batch + (4,))
    return recover_pose_reference(essential, pts1, pts2, mask, intrinsics, thr2)


def recover_pose_reference(
    essential: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    thr2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Disambiguate E into (R, t) by cheirality voting (cv2.recoverPose),
    batched over the leading dims of ``essential`` (..., 3, 3) and ``mask``
    (..., N). With ``thr2`` only the slots whose Sampson distance under E
    (in ray units) is below it vote. Returns (rvec (..., 3), unit t (..., 3),
    votes (..., 4))."""
    n1, n2 = _rays(pts1, intrinsics), _rays(pts2, intrinsics)
    if thr2 is not None:
        mask = mask & (_sampson(essential, _homog(n1), _homog(n2)) < thr2)
    u, _, vt = _svd(essential)
    sign = torch.where(torch.linalg.det(u) * torch.linalg.det(vt) < 0, -1.0, 1.0).to(essential.dtype)
    w = torch.tensor(_W, dtype=essential.dtype, device=essential.device)
    r1 = u @ w @ vt * sign[..., None, None]
    r2 = u @ w.T @ vt * sign[..., None, None]
    t = u[..., :, 2]
    rots = torch.stack([r1, r1, r2, r2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    _, z1, z2 = _triangulate_midpoint(rots, ts, n1, n2)
    votes = torch.sum((z1 > 0) & (z2 > 0) & mask[..., None, :], dim=-1)  # (..., 4)
    best = torch.argmax(votes, dim=-1)
    rs = so3.log(rots)
    pick = best[..., None, None].expand(best.shape + (1, 3))
    return torch.gather(rs, -2, pick)[..., 0, :], torch.gather(ts, -2, pick)[..., 0, :], votes


def _essential_of(rv: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for (..., 3) rvec / tvec."""
    return so3.hat(tv) @ so3.exp(rv)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def refine_relative_pose(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    iters: int = 15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`refine_relative_pose_reference` in one launch of the CUDA
    kernel (``csrc/relpose.cu``) for tensors on the card, the plain version
    itself for tensors on the CPU. Arguments and results as the plain
    version's."""
    if rvec.device.type == "cuda":
        batch = rvec.shape[:-1]
        rv, tv = ransac_cuda.refine_relpose(
            rvec.reshape(-1, 3), tvec.reshape(-1, 3), pts1, pts2, mask, intrinsics, iters
        )
        return rv.reshape(batch + (3,)), tv.reshape(batch + (3,))
    return refine_relative_pose_reference(rvec, tvec, pts1, pts2, mask, intrinsics, iters)


def refine_relative_pose_reference(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    iters: int = 15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robust Gauss-Newton (Levenberg-damped) refinement of (R, t) on the
    essential manifold, minimizing the pixel-scaled Sampson error with
    MAD-adaptive Cauchy weights; t renormalized every step. Batched over the
    leading dims of ``rvec`` / ``tvec`` (..., 3), a fixed ``iters`` steps
    with no host reads. Returns the refined (rvec, unit tvec)."""
    n1, n2 = _rays(pts1, intrinsics), _rays(pts2, intrinsics)
    x1, x2 = _homog(n1), _homog(n2)
    w_mask = mask.to(n1.dtype)
    focal = 0.5 * (intrinsics[0, 0] + intrinsics[1, 1])
    c2_floor = 0.05**2  # floor of the adaptive Cauchy scale: 0.05 px

    def raw_residual(params):  # (6,) -> (N,)
        # A (1, 6) row: forward-mode AD through ``torch.where`` on 0-d
        # tensors (so3.exp of one rvec) yields float64 tangents.
        e = _essential_of(params[None, :3], params[None, 3:])[0]
        ex1 = x1 @ e.T
        etx2 = x2 @ e
        num = torch.sum(x2 * ex1, dim=1)
        den = torch.sqrt(torch.clamp(ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2, min=1e-12))
        return focal * num / den

    residual = vmap(raw_residual)
    jacobian = one_thread_at_a_time(vmap(jacfwd(raw_residual)))
    batch = rvec.shape[:-1]
    params = torch.cat([rvec, _unit(tvec)], dim=-1).reshape(-1, 6).to(n1.dtype)
    lam = torch.full(params.shape[:1], 1e-4, dtype=n1.dtype, device=n1.device)
    eye6 = torch.eye(6, dtype=n1.dtype, device=n1.device)
    for _ in range(iters):
        r = residual(params)  # (B, N)
        med = nanmedian(torch.where(mask, torch.abs(r), torch.full_like(r, torch.nan)))
        c2 = torch.clamp((3.0 * 1.4826 * med) ** 2, min=c2_floor)
        w = w_mask / (1.0 + (r * r) / c2[:, None])
        sw = torch.sqrt(w)
        j = jacobian(params) * sw[..., None]  # (B, N, 6)
        rw = r * sw
        jtj = j.transpose(1, 2) @ j
        g = torch.einsum("bni,bn->bi", j, rw)
        # Marquardt scaling: damp relative to the problem's own curvature.
        damp = lam * (torch.einsum("bii->b", jtj) / 6.0 + 1e-12)
        step = torch.linalg.solve_ex(jtj + damp[:, None, None] * eye6, g[..., None])[0][..., 0]
        cand = params - step
        cand = torch.cat([cand[:, :3], _unit(cand[:, 3:])], dim=1)
        better = torch.sum(w * residual(cand) ** 2, 1) < torch.sum(w * r * r, 1)
        params = torch.where(better[:, None], cand, params)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-8), lam * 10.0)
    params = params.reshape(batch + (6,))
    return params[..., :3], params[..., 3:]


def essential_hypotheses(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    idx: torch.Tensor,
    thr2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`essential_hypotheses_reference` in one launch of the CUDA
    kernel for tensors on the card, the plain version on the CPU."""
    if pts1.device.type == "cuda":
        return ransac_hyp_cuda.essential_hypotheses(pts1, pts2, mask, intrinsics, idx, thr2)
    return essential_hypotheses_reference(pts1, pts2, mask, intrinsics, idx, thr2)


def essential_hypotheses_reference(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    idx: torch.Tensor,
    thr2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalized 8-point hypotheses of the (H, 8) slot indices ``idx``,
    each projected onto the essential manifold with unit norm, and their
    consensus: the slots in ``mask`` whose Sampson distance (ray units) is
    below the 0-d ``thr2``. Returns (es (H, 3, 3), int64 counts (H,))."""
    n1, n2 = _rays(pts1, intrinsics), _rays(pts2, intrinsics)
    n1h, t1 = _normalize(n1, mask)
    n2h, t2 = _normalize(n2, mask)
    es = _project_to_essential(t2.T @ _eight_point(n1h[idx], n2h[idx]) @ t1)
    counts = torch.sum((_sampson(es, _homog(n1), _homog(n2)) < thr2) & mask, dim=1)
    return es, counts


def score_candidates(
    rvecs: torch.Tensor,
    tvecs: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    thr2: torch.Tensor,
):
    """:func:`score_candidates_reference` in one launch of the CUDA kernel
    for tensors on the card, the plain version on the CPU."""
    if rvecs.device.type == "cuda":
        return ransac_hyp_cuda.score_candidates(rvecs, tvecs, pts1, pts2, mask, intrinsics, thr2)
    return score_candidates_reference(rvecs, tvecs, pts1, pts2, mask, intrinsics, thr2)


def score_candidates_reference(
    rvecs: torch.Tensor,
    tvecs: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    thr2: torch.Tensor,
):
    """CheckRT-style scores of (C, 3) refined candidates: each one's
    E = [t]_x R (unit norm), its Sampson inliers, the pose its cheirality
    vote picks among E's decompositions, and that pose's triangulated
    reprojection: the slots in front of both cameras within 2x the epipolar
    gate, and the truncated reprojection cost over the mask. Returns (int64
    good counts (C,), costs (C,), rvecs (C, 3), unit tvecs (C, 3), E (C, 3,
    3), Sampson residuals (C, N) with inf out of the mask, inliers (C, N))."""
    n1, n2 = _rays(pts1, intrinsics), _rays(pts2, intrinsics)
    e = _essential_of(rvecs, tvecs)
    e = e / torch.clamp(torch.linalg.norm(e, dim=(-2, -1), keepdim=True), min=1e-12)
    ress = _sampson(e, _homog(n1), _homog(n2))  # (C, N)
    inls = (ress < thr2) & mask
    rvds, tvds, _ = recover_pose_reference(e, pts1, pts2, inls, intrinsics)
    rd = so3.exp(rvds)
    x3, z1, z2 = _triangulate_midpoint(rd, tvds, n1, n2)
    xc2 = torch.einsum("cij,cnj->cni", rd, x3) + tvds[:, None, :]
    safe1 = torch.where(torch.abs(z1) > 1e-9, z1, torch.full_like(z1, 1e-9))
    safe2 = torch.where(torch.abs(z2) > 1e-9, z2, torch.full_like(z2, 1e-9))
    r1 = torch.sum((x3[..., :2] / safe1[..., None] - n1) ** 2, dim=-1)
    r2 = torch.sum((xc2[..., :2] / safe2[..., None] - n2) ** 2, dim=-1)
    rmax = torch.maximum(r1, r2)
    rthr2 = 4.0 * thr2  # reprojection gate: 2x the epipolar gate, squared
    good = torch.sum(mask & (z1 > 1e-6) & (z2 > 1e-6) & (rmax < rthr2), dim=-1)
    msacs = torch.sum(torch.where(mask, torch.minimum(rmax, rthr2), torch.zeros_like(rmax)), dim=-1)
    return good, msacs, rvds, tvds, e, torch.where(mask, ress, torch.full_like(ress, torch.inf)), inls


def estimate_relative_pose(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    intrinsics: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 1.5,
    num_hypotheses: int = 2048,
    top_k: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, RansacResult]:
    """LO-RANSAC relative pose: the top-``top_k`` essential hypotheses by
    consensus and the 8 decompositions of a RANSAC homography (the planar
    escape hatch) are each cheirality-decomposed and refined as one batch,
    then scored by triangulated reprojection (most inliers, truncated cost
    as tie-break). Returns (rvec, unit tvec, RansacResult under the winning
    pose). On the card: five launches of ``csrc/relpose_hyp.cu``'s kernels
    and one of ``csrc/relpose.cu``'s, and no host read."""
    generator = generator or default_generator(pts1.device)
    thr2 = (threshold / (0.5 * (intrinsics[0, 0] + intrinsics[1, 1]))) ** 2

    idx = sample_subsets(mask, num_hypotheses, 8, generator)
    es, counts = essential_hypotheses(pts1, pts2, mask, intrinsics, idx, thr2)
    # lax.top_k order: most consensus first, lower index first on ties.
    top_idx = torch.sort(counts, descending=True, stable=True).indices[:top_k]
    # Each top hypothesis decomposed, voted by its own inliers.
    rvs, tvs, _ = recover_pose(es[top_idx], pts1, pts2, mask, intrinsics, thr2)

    # Planar-degeneracy escape hatch (ORB-SLAM's dual H/F bootstrap).
    _, rv_h, tv_h = _homography_candidates(pts1, pts2, mask, generator, threshold=3.0, intrinsics=intrinsics)
    # Both families refined in one call (one launch on the card): each
    # candidate is refined on its own, and the refinement draws nothing, so
    # the draws keep their order.
    rvs, tvs = refine_relative_pose(
        torch.cat([rvs, torch.nan_to_num(rv_h)]), torch.cat([tvs, torch.nan_to_num(tv_h)]),
        pts1, pts2, mask, intrinsics,
    )

    # Score every candidate by triangulated reprojection (CheckRT-style):
    # the Sampson cost is blind to planar-degenerate impostors.
    good, msacs, rvds, tvds, e, ress, inls = score_candidates(rvs, tvs, pts1, pts2, mask, intrinsics, thr2)
    order = good.to(torch.float32) - msacs / (torch.max(msacs) + 1e-30)
    best = torch.argmax(order).reshape(1)

    def pick(x):  # x[best] by index_select: a 0-d tensor index would read it back to the host
        return x.index_select(0, best)[0]

    inliers = pick(inls)
    result = RansacResult(matrix=pick(e), inliers=inliers, num_inliers=inliers.sum(), residuals=pick(ress))
    return pick(rvds), pick(tvds), result


def _decompose_homography(h: torch.Tensor, intrinsics: torch.Tensor):
    """Faugeras SVD decomposition of a pixel homography into 8 (R, t)
    candidates (invalid ones are culled downstream by cheirality).
    Returns (rvecs (8, 3), unit tvecs (8, 3))."""
    hn = torch.linalg.inv_ex(intrinsics)[0] @ h @ intrinsics
    u, d, vt = _svd(hn)
    d1, d2, d3 = d[0], d[1], d[2]
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    x3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    d2s = torch.clamp(d2, min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rots, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            a1, a3 = e1 * x1, e3 * x3
            # Case d' = +d2: rotation about the y-axis of the V frame.
            sin_t = (d1 - d3) / d2s * a1 * a3
            cos_t = (d1 * a3 * a3 + d3 * a1 * a1) / d2s
            rp = mat([[cos_t, zero, -sin_t], [zero, one, zero], [sin_t, zero, cos_t]])
            rots.append(s * u @ rp @ vt)
            ts.append(u @ (torch.stack([a1, zero, -a3]) * (d1 - d3)))
            # Case d' = -d2: adds a 180-degree flip.
            sin_p = (d1 + d3) / d2s * a1 * a3
            cos_p = (d3 * a1 * a1 - d1 * a3 * a3) / d2s
            rp2 = mat([[cos_p, zero, sin_p], [zero, -one, zero], [sin_p, zero, -cos_p]])
            rots.append(s * u @ rp2 @ vt)
            ts.append(u @ (torch.stack([a1, zero, a3]) * (d1 + d3)))
    return so3.log(torch.stack(rots)), _unit(torch.stack(ts))


def _homography_transfer_sq(h: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer error (squared px) of pts1 <-H-> pts2, batched over
    the leading dims of ``h`` (..., 3, 3) -> (..., N)."""
    p1h, p2h = _homog(pts1), _homog(pts2)

    def dehom(v):
        z = v[..., 2:]
        return v[..., :2] / torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))

    fwd = dehom(torch.einsum("...ij,nj->...ni", h, p1h))
    hinv = torch.linalg.inv_ex(h)[0]
    bwd = dehom(torch.einsum("...ij,nj->...ni", hinv, p2h))
    return torch.sum((fwd - pts2) ** 2, -1) + torch.sum((bwd - pts1) ** 2, -1)


def homography_hypotheses(
    pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`homography_hypotheses_reference` in one launch of the CUDA
    kernel for tensors on the card, the plain version on the CPU."""
    if pts1.device.type == "cuda":
        return ransac_hyp_cuda.homography_hypotheses(pts1, pts2, mask, idx, threshold)
    return homography_hypotheses_reference(pts1, pts2, mask, idx, threshold)


def homography_hypotheses_reference(
    pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalized 4-point DLT homographies of the (H, 4) slot indices
    ``idx`` (pts1 -> pts2) and their consensus: the slots in ``mask`` whose
    symmetric transfer error is below ``threshold`` px. Returns (hs (H, 3,
    3), int64 counts (H,))."""
    hs = find_homography(pts1[idx], pts2[idx])  # (H, 3, 3)
    counts = torch.sum((_homography_transfer_sq(hs, pts1, pts2) < threshold * threshold) & mask, dim=1)
    return hs, counts


def homography_polish(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    hs: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    intrinsics: Optional[torch.Tensor] = None,
):
    """:func:`homography_polish_reference` in one launch of the CUDA kernel
    for tensors on the card, the plain version on the CPU."""
    if pts1.device.type == "cuda":
        return ransac_hyp_cuda.homography_polish(pts1, pts2, mask, hs, counts, threshold, intrinsics)
    return homography_polish_reference(pts1, pts2, mask, hs, counts, threshold, intrinsics)


def homography_polish_reference(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    hs: torch.Tensor,
    counts: torch.Tensor,
    threshold: float,
    intrinsics: Optional[torch.Tensor] = None,
):
    """The first best of ``hs`` by ``counts``, polished twice by an
    inlier-weighted DLT re-solve (kept while consensus does not shrink),
    and with ``intrinsics`` its 8 Faugeras decompositions. Returns (H (3,
    3), symmetric transfer errors (N,) with inf out of the mask, inliers
    (N,), rvecs (8, 3), unit tvecs (8, 3)); without ``intrinsics`` the last
    two are None."""
    thr2 = threshold * threshold
    h_best = hs[torch.argmax(counts)]
    res = _homography_transfer_sq(h_best, pts1, pts2)
    inliers = (res < thr2) & mask

    x, y = pts1[:, 0], pts1[:, 1]
    uu, vv = pts2[:, 0], pts2[:, 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([-x, -y, -one, zero, zero, zero, uu * x, uu * y, uu], dim=-1)
    rows_v = torch.stack([zero, zero, zero, -x, -y, -one, vv * x, vv * y, vv], dim=-1)
    for _ in range(2):
        w = inliers.to(x.dtype)[:, None]
        design = torch.cat([rows_u * w, rows_v * w], dim=0)
        h_ref = _smallest_eigvec(design.T @ design)
        h22 = h_ref[2, 2]
        h_ref = h_ref / torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
        res_ref = _homography_transfer_sq(h_ref, pts1, pts2)
        inl_ref = (res_ref < thr2) & mask
        better = inl_ref.sum() >= inliers.sum()
        h_best, res, inliers = _keep_if_better(better, (h_ref, res_ref, inl_ref), (h_best, res, inliers))
    residuals = torch.where(mask, res, torch.full_like(res, torch.inf))
    if intrinsics is None:
        return h_best, residuals, inliers, None, None
    rv_h, tv_h = _decompose_homography(h_best, intrinsics)
    return h_best, residuals, inliers, rv_h, tv_h


def _homography_candidates(pts1, pts2, mask, generator, threshold=3.0, num_hypotheses=1024, intrinsics=None):
    """A RANSAC homography (its own 4-point draws from ``generator``) and,
    with ``intrinsics``, its 8 decompositions: (RansacResult, rvecs (8, 3),
    unit tvecs (8, 3)), the last two None without."""
    idx = sample_subsets(mask, num_hypotheses, 4, generator)
    hs, counts = homography_hypotheses(pts1, pts2, mask, idx, threshold)
    h, residuals, inliers, rv_h, tv_h = homography_polish(pts1, pts2, mask, hs, counts, threshold, intrinsics)
    return RansacResult(matrix=h, inliers=inliers, num_inliers=inliers.sum(), residuals=residuals), rv_h, tv_h


def find_homography_ransac(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 3.0,
    num_hypotheses: int = 1024,
) -> RansacResult:
    """Batched-RANSAC planar homography (4-point DLT hypotheses), polished by
    an inlier-weighted DLT re-solve; ``residuals`` are symmetric transfer
    errors (squared px). On the card two launches of one CUDA kernel."""
    generator = generator or default_generator(pts1.device)
    return _homography_candidates(pts1, pts2, mask, generator, threshold, num_hypotheses)[0]
