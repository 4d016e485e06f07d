"""Pyramidal Lucas-Kanade optical flow (torch twin of
``meatmodeler_tpu/ops/klt.py``).

:func:`lucas_kanade` tracks CUDA tensors in one launch of the hand-written
kernel (``ops/klt_cuda.py``, ``csrc/klt.cu``) and CPU tensors through
:func:`lucas_kanade_reference`, the plain version, vectorised over points:
every point runs the same fixed number of iterations at every level, and a
point whose update falls below ``eps`` (or whose gradient matrix is
singular) keeps its displacement, as the reference's ``fori_loop`` body
does. Outputs match ``cv2.calcOpticalFlowPyrLK``'s: tracked points, a
status flag and the mean absolute window error (NaN for failed points).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.ops import klt_cuda

__all__ = ["FlowResult", "build_pyramid", "lucas_kanade", "lucas_kanade_reference"]


class FlowResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked (x, y)
    status: torch.Tensor  # (N,) bool
    error: torch.Tensor  # (N,) mean |I_prev - I_curr| over the window


_GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian (cv2's pyrDown kernel) over the last two
    dims with replicate borders, summed in the reference's tap order."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, 1, h, w)
    pad_y = F.pad(flat, (0, 0, 2, 2), mode="replicate")
    tmp = sum(_GAUSS5[i] * pad_y[:, :, i : i + h] for i in range(5))
    pad_x = F.pad(tmp, (2, 2, 0, 0), mode="replicate")
    out = sum(_GAUSS5[i] * pad_x[:, :, :, i : i + w] for i in range(5))
    return out.reshape(img.shape)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Gaussian pyramid of (..., H, W) images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur5(pyr[-1])[..., ::2, ::2].contiguous())
    return pyr


def _bilinear_window(img_p: torch.Tensor, pad: int, center: torch.Tensor, win: int) -> torch.Tensor:
    """(N, win, win) bilinear patches around float ``center`` (N, 2) (x, y)
    from ``img_p``, the image edge-padded by ``pad`` on every side. A
    window that would leave the padded image is clamped inside it, as the
    reference's ``dynamic_slice`` is."""
    half = (win - 1) / 2.0
    hp, wp = img_p.shape
    tl = center - half + pad
    t0 = torch.floor(tl)
    fx = (tl[:, 0] - t0[:, 0])[:, None, None]
    fy = (tl[:, 1] - t0[:, 1])[:, None, None]
    x0 = torch.clamp(t0[:, 0].to(torch.int64), 0, wp - win - 1)
    y0 = torch.clamp(t0[:, 1].to(torch.int64), 0, hp - win - 1)
    ar = torch.arange(win + 1, device=img_p.device)
    big = img_p[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    return (
        big[:, :-1, :-1] * (1 - fy) * (1 - fx)
        + big[:, :-1, 1:] * (1 - fy) * fx
        + big[:, 1:, :-1] * fy * (1 - fx)
        + big[:, 1:, 1:] * fy * fx
    )


def _pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def _lk_level(prev_img, curr_img, prev_pt, guess, win: int, max_iters: int, eps: float):
    """Iterative LK at one pyramid level for all points: (refined
    displacement (N, 2), ok (N,))."""
    pad_t = win + 3  # the (win + 2) template windows' pad
    patch_p = _bilinear_window(_pad(prev_img, pad_t), pad_t, prev_pt, win + 2)
    ix = (patch_p[:, 1:-1, 2:] - patch_p[:, 1:-1, :-2]) * 0.5
    iy = (patch_p[:, 2:, 1:-1] - patch_p[:, :-2, 1:-1]) * 0.5
    tmpl = patch_p[:, 1:-1, 1:-1]

    gxx = torch.sum(ix * ix, dim=(1, 2))
    gxy = torch.sum(ix * iy, dim=(1, 2))
    gyy = torch.sum(iy * iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-7
    den = torch.where(ok, det, torch.ones_like(det))
    i00, i01, i11 = gyy / den, -gxy / den, gxx / den

    pad_c = win + 1
    curr_p = _pad(curr_img, pad_c)
    d = guess
    for _ in range(max_iters):
        diff = tmpl - _bilinear_window(curr_p, pad_c, prev_pt + d, win)
        b0 = torch.sum(diff * ix, dim=(1, 2))
        b1 = torch.sum(diff * iy, dim=(1, 2))
        delta = torch.stack([i00 * b0 + i01 * b1, i01 * b0 + i11 * b1], dim=-1)
        # Freeze once the update is below eps (cv2 TERM_CRITERIA_EPS).
        small = torch.sum(delta * delta, dim=-1) < eps * eps
        d = torch.where((small | ~ok)[:, None], d, d + delta)
    return d, ok


def lucas_kanade(
    prev_pyr: Sequence[torch.Tensor],
    curr_pyr: Sequence[torch.Tensor],
    points: torch.Tensor,
    win: int = 21,
    levels: int = 4,
    max_iters: int = 30,
    eps: float = 0.01,
    point_mask: torch.Tensor | None = None,
    initial_flow: torch.Tensor | None = None,
) -> FlowResult:
    """Track ``points`` (N, 2) (x, y) from the previous to the current frame
    through (H, W) pyramids from :func:`build_pyramid`: one launch of the
    CUDA kernel for pyramids on the card, :func:`lucas_kanade_reference`
    for pyramids on the CPU. Arguments as the plain version's."""
    if prev_pyr[0].device.type == "cuda":
        pts, status, err = klt_cuda.lk_track(
            prev_pyr, curr_pyr, points, win, min(levels, len(prev_pyr)), max_iters, eps,
            point_mask=point_mask, initial_flow=initial_flow,
        )
        return FlowResult(pts, status, err)
    return lucas_kanade_reference(
        prev_pyr, curr_pyr, points, win=win, levels=levels, max_iters=max_iters, eps=eps,
        point_mask=point_mask, initial_flow=initial_flow,
    )


def lucas_kanade_reference(
    prev_pyr: Sequence[torch.Tensor],
    curr_pyr: Sequence[torch.Tensor],
    points: torch.Tensor,
    win: int = 21,
    levels: int = 4,
    max_iters: int = 30,
    eps: float = 0.01,
    point_mask: torch.Tensor | None = None,
    initial_flow: torch.Tensor | None = None,
) -> FlowResult:
    """Track ``points`` (N, 2) (x, y) from the previous to the current frame
    through (H, W) pyramids from :func:`build_pyramid`; ``point_mask``
    marks padding entries (they are tracked but never succeed).
    ``initial_flow``: optional (N, 2) full-resolution displacement guess
    (cv2's OPTFLOW_USE_INITIAL_FLOW), e.g. descriptor-match offsets that LK
    polishes to sub-pixel."""
    points = points.to(prev_pyr[0].dtype)
    if point_mask is None:
        point_mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    levels = min(levels, len(prev_pyr))
    if initial_flow is None:
        d = torch.zeros_like(points)
    else:
        d = initial_flow.to(points.dtype) / 2.0 ** (levels - 1)
    ok_all = point_mask
    for lvl in range(levels - 1, -1, -1):
        d, ok = _lk_level(prev_pyr[lvl], curr_pyr[lvl], points / 2.0**lvl, d, win, max_iters, eps)
        ok_all = ok_all & ok
        if lvl > 0:
            d = d * 2.0
    new_pts = points + d
    h, w = prev_pyr[0].shape
    in_bounds = (new_pts[:, 0] >= 0) & (new_pts[:, 0] < w) & (new_pts[:, 1] >= 0) & (new_pts[:, 1] < h)
    pad = win + 1
    tmpl = _bilinear_window(_pad(prev_pyr[0], pad), pad, points, win)
    curr = _bilinear_window(_pad(curr_pyr[0], pad), pad, new_pts, win)
    err = torch.mean(torch.abs(tmpl - curr), dim=(1, 2))
    status = ok_all & in_bounds
    return FlowResult(new_pts, status, torch.where(status, err, torch.full_like(err, torch.nan)))
