"""Chessboard detection on the device (torch twin of
``meatmodeler_tpu/ops/board_detect.py``).

Two batched stages, no OpenCV:

  1. saddle candidates: the negative Hessian determinant of a smoothed
     image, 7x7 non-max suppression, the exact top ``max_candidates`` with
     parabolic sub-pixel refinement;
  2. grid fit: every ordered 4-tuple of the ``hyp_candidates`` strongest
     candidates (16**4 = 65536 hypotheses) is taken as the grid's outer
     corners; each gives a closed-form homography, the full pattern is
     projected through it and scored by nearest-candidate assignment. All
     hypotheses are scored as (hypotheses, grid points, candidates) tensors
     in chunks; the best full, injective assignment wins.

Orderings of one board that differ only in traversal score the same up to
summation order, so the winning traversal may differ from the reference's;
``chessboard.canonicalize_corners`` plus ``orient_corners_to`` make them one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.ops.features import _conv2

__all__ = ["BoardDetection", "saddle_response", "saddle_candidates", "find_chessboard_device"]


class BoardDetection(NamedTuple):
    corners: torch.Tensor  # (rows*cols, 2) float32 (x, y), row-major over the pattern
    ok: torch.Tensor  # () bool: a full injective grid assignment was found
    residual: torch.Tensor  # () mean |projected grid - matched candidate| (px)


# Hypotheses scored at once: bounds the (chunk, G, K) distance tensors
# (~19 MB each for the (4, 3) pattern and 24 candidates).
_HYP_CHUNK = 16384

_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _smooth(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur (separable, replicate borders), applied twice."""
    kx = torch.tensor([_BINOMIAL5], dtype=img.dtype, device=img.device)
    ky = kx.T.contiguous()
    for _ in range(2):
        img = _conv2(_conv2(img, kx), ky)
    return img


def saddle_response(grey: torch.Tensor) -> torch.Tensor:
    """``Ixy^2 - Ixx*Iyy`` of the smoothed (H, W) or (B, H, W) images:
    > 0 at X-corners, <= 0 on edges and blobs."""
    img = _smooth(grey.to(torch.float32))
    d2 = torch.tensor([[1.0, -2.0, 1.0]], dtype=img.dtype, device=img.device)
    ixx = _conv2(img, d2)
    iyy = _conv2(img, d2.T.contiguous())
    dxy = torch.tensor([[0.25, 0.0, -0.25], [0.0, 0.0, 0.0], [-0.25, 0.0, 0.25]], dtype=img.dtype, device=img.device)
    ixy = _conv2(img, dxy)
    return ixy * ixy - ixx * iyy


class Candidates(NamedTuple):
    xy: torch.Tensor  # (B, K, 2) parabola-refined peak positions
    score: torch.Tensor  # (B, K)
    mask: torch.Tensor  # (B, K) bool


def saddle_candidates(
    grey: torch.Tensor,
    max_candidates: int = 24,
    nms_window: int = 7,
    rel_threshold: float = 0.1,
    exact_topk: bool = False,
) -> Candidates:
    """Top-k saddle points of (H, W) or (B, H, W) images, ranked exactly
    (ties to the lower pixel index, as ``lax.top_k``), with parabolic
    refinement; the outputs carry the input's leading dim. ``exact_topk``
    is accepted for the reference's signature and ignored: the ranking is
    always exact."""
    if grey.ndim == 2:
        return Candidates(*(t[0] for t in saddle_candidates(grey[None], max_candidates, nms_window, rel_threshold)))
    resp = saddle_response(grey)
    bsz, h, w = resp.shape
    dev = resp.device
    neigh = F.max_pool2d(resp[:, None], nms_window, stride=1, padding=nms_window // 2)[:, 0]
    peak = resp.reshape(bsz, -1).amax(dim=1)[:, None, None]
    valid = (resp >= neigh) & (resp > rel_threshold * peak) & (resp > 0)
    margin = 3
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    valid &= (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)
    flat = torch.where(valid, resp, torch.full_like(resp, -torch.inf)).reshape(bsz, -1)
    top_resp, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_resp, top_idx = top_resp[:, :max_candidates], top_idx[:, :max_candidates]
    ys, xs = top_idx // w, top_idx % w
    mask = torch.isfinite(top_resp)
    bidx = torch.arange(bsz, device=dev)[:, None]

    def sample(dy, dx):
        return resp[bidx, torch.clamp(ys + dy, 0, h - 1), torch.clamp(xs + dx, 0, w - 1)]

    def axis_offset(minus, center, plus):
        denom = minus - 2.0 * center + plus
        safe = torch.where(torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (minus - plus) / safe, torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    c0 = sample(0, 0)
    off_x = axis_offset(sample(0, -1), c0, sample(0, 1))
    off_y = axis_offset(sample(-1, 0), c0, sample(1, 0))
    xy = torch.stack([xs.to(torch.float32) + off_x, ys.to(torch.float32) + off_y], dim=-1)
    return Candidates(xy=xy, score=torch.where(mask, top_resp, torch.zeros_like(top_resp)), mask=mask)


def _basis_homography(p: torch.Tensor):
    """Closed-form homographies sending the projective basis e1, e2, e3,
    (1, 1, 1) to the four points ``p`` (..., 4, 2). Returns (H (..., 3, 3),
    ok (...))."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # (..., 4, 3)
    a, b, c = ph[..., 0, :], ph[..., 1, :], ph[..., 2, :]
    adj = torch.stack([torch.linalg.cross(b, c), torch.linalg.cross(c, a), torch.linalg.cross(a, b)], dim=-2)
    det = torch.sum(adj[..., 0, :] * a, dim=-1)
    lam = torch.sum(adj * ph[..., 3, None, :], dim=-1)  # adj @ p4
    ok = (torch.abs(det) > 1e-8) & torch.all(torch.abs(lam) > 1e-8 * torch.abs(det)[..., None], dim=-1)
    m = ph[..., :3, :].transpose(-1, -2)  # columns are p1 p2 p3
    return m * lam[..., None, :], ok


def _grid_constants(pattern: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(inverse basis->domain homography, homogeneous grid points)."""
    cols, rows = pattern
    dom = np.array([[0.0, 0.0], [cols - 1.0, 0.0], [0.0, rows - 1.0], [cols - 1.0, rows - 1.0]])
    ph = np.concatenate([dom, np.ones((4, 1))], axis=1)
    m = ph[:3].T
    lam = np.linalg.solve(m, ph[3])
    h_dom = m * lam[None, :]
    gx, gy = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(cols * rows)], axis=1)
    return np.linalg.inv(h_dom), grid


def _score_hypotheses(idx4, cand_xy, cand_valid, norm_score, inv_dom, grid, tol: float):
    """Objective, residual sum and nearest candidates of (N, 4) hypotheses
    on one image's candidates."""
    k = cand_xy.shape[0]
    g = grid.shape[0]
    park = 1e9 * (1.0 + torch.arange(k, dtype=torch.float32, device=cand_xy.device))[:, None]
    cand_pos = torch.where(cand_valid[:, None], cand_xy, park)
    p4 = cand_pos[idx4]  # (N, 4, 2)
    i0, i1, i2, i3 = idx4.unbind(-1)
    distinct = (i0 != i1) & (i0 != i2) & (i0 != i3) & (i1 != i2) & (i1 != i3) & (i2 != i3)
    usable = distinct & torch.all(cand_valid[idx4], dim=-1)
    hb, hok = _basis_homography(torch.clamp(p4, -1e6, 1e6))
    h = hb @ inv_dom  # grid coords -> image
    proj = torch.einsum("gj,nij->ngi", grid, h)  # (N, G, 3)
    z = proj[..., 2]
    zok = torch.all(torch.abs(z) > 1e-8, dim=-1)
    pts = proj[..., :2] / torch.where(torch.abs(z) > 1e-8, z, torch.ones_like(z))[..., None]
    d2 = torch.sum((pts[:, :, None, :] - cand_pos[None, None]) ** 2, dim=-1)  # (N, G, K)
    md2, nearest = torch.min(d2, dim=-1)  # first minimiser, as argmin
    dmin = torch.sqrt(md2)
    matched = dmin < tol
    full = torch.sum(matched, dim=-1) == g
    # Injective: with every grid point matched, the first minimisers are
    # pairwise distinct (the reference's one-hot count, without the one-hot).
    srt = torch.sort(nearest, dim=-1).values
    injective = torch.all(srt[:, 1:] != srt[:, :-1], dim=-1)
    ok = usable & hok & zok & full & injective
    total = torch.sum(torch.where(matched, dmin, torch.full_like(dmin, tol)), dim=-1)
    strength = torch.sum(torch.where(matched, norm_score[nearest], torch.zeros_like(dmin)), dim=-1)
    objective = total + (g - strength) * (8.0 * tol)
    return torch.where(ok, objective, torch.full_like(objective, torch.inf)), total, nearest


def find_chessboard_device(
    grey: torch.Tensor,
    pattern: Tuple[int, int] = (4, 3),
    max_candidates: int = 24,
    hyp_candidates: int = 16,
    tol: float = 3.0,
    nms_window: int = 7,
    exact_topk: bool = False,
) -> BoardDetection:
    """Detect the full inner-corner grid in an (H, W) or (B, H, W) grey
    stack. ``corners`` are row-major over the pattern (x fastest), taken
    from the matched saddle candidates; the outputs carry the input's
    leading dim. ``exact_topk`` is accepted for the reference's signature
    and ignored: the candidates are always ranked exactly."""
    cols, rows = pattern
    g = cols * rows
    if max_candidates < g:
        raise ValueError(f"max_candidates={max_candidates} cannot cover the {g}-corner pattern")
    hyp_candidates = min(hyp_candidates, max_candidates)
    single = grey.ndim == 2
    stack = grey[None] if single else grey
    dev = stack.device
    cand = saddle_candidates(stack, max_candidates=max_candidates, nms_window=nms_window)
    inv_dom_np, grid_np = _grid_constants(pattern)
    inv_dom = torch.as_tensor(inv_dom_np, dtype=torch.float32, device=dev)
    grid = torch.as_tensor(grid_np, dtype=torch.float32, device=dev)
    m = hyp_candidates
    hyp = torch.arange(m**4, device=dev)
    idx4 = torch.stack([hyp // m**3, (hyp // m**2) % m, (hyp // m) % m, hyp % m], dim=1)
    # Relative saddle strength: the board's inner X-corners are several
    # times stronger than the L-junctions along its boundary.
    norm_score = cand.score / torch.clamp(cand.score.amax(dim=1, keepdim=True), min=1e-12)

    corners, oks, residuals = [], [], []
    for b in range(stack.shape[0]):
        parts = [
            _score_hypotheses(idx4[i : i + _HYP_CHUNK], cand.xy[b], cand.mask[b], norm_score[b], inv_dom, grid, tol)
            for i in range(0, idx4.shape[0], _HYP_CHUNK)
        ]
        objectives, totals, nearests = (torch.cat(p) for p in zip(*parts))
        best = torch.argmin(objectives)
        corners.append(cand.xy[b][nearests[best]])
        oks.append(torch.isfinite(objectives[best]))
        residuals.append(totals[best] / g)
    out = BoardDetection(torch.stack(corners), torch.stack(oks), torch.stack(residuals))
    return BoardDetection(*(t[0] for t in out)) if single else out
