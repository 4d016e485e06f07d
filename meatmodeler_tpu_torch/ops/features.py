"""Sobel gradients, windowed structure tensor, Harris and Shi-Tomasi
responses and ``good_features`` (torch twin of
``meatmodeler_tpu/ops/features.py``).

Filters run as ``conv2d`` on replicate-padded (B, 1, H, W) stacks. cuDNN
would run a float32 convolution in TF32 on the card; ``pipeline.process``
turns TF32 off, so these stay full float32 like the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Corners", "sobel", "structure_tensor", "min_eig_response", "harris_response", "good_features"]

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Same-size 2-D correlation of (H, W) or (B, H, W) with replicate
    borders."""
    if img.ndim == 2:
        return _conv2(img[None], kernel)[0]
    kh, kw = kernel.shape
    x = F.pad(img[:, None], (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    return F.conv2d(x, kernel[None, None].to(img.dtype))[:, 0]


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel derivatives (Ix, Iy) of (H, W) or (B, H, W) images."""
    kx = torch.tensor(_SOBEL_X, dtype=img.dtype, device=img.device)
    return _conv2(img, kx), _conv2(img, kx.T.contiguous())


def _box(img: torch.Tensor, size: int) -> torch.Tensor:
    """Unnormalized box sum over a size x size window."""
    return _conv2(img, torch.ones((size, size), dtype=img.dtype, device=img.device))


def structure_tensor(img: torch.Tensor, block_size: int = 7):
    """Box-windowed (Ix^2, IxIy, Iy^2) of (H, W) or (B, H, W) images."""
    ix, iy = sobel(img)
    return _box(ix * ix, block_size), _box(ix * iy, block_size), _box(iy * iy, block_size)


def min_eig_response(img: torch.Tensor, block_size: int = 7) -> torch.Tensor:
    """Shi-Tomasi: the smaller eigenvalue of the windowed structure tensor
    (cv2.cornerMinEigenVal scaling)."""
    a, b, c = structure_tensor(img, block_size)
    scale = 1.0 / (4.0 * 255.0 * block_size) ** 2
    half_tr = 0.5 * (a + c)
    rad = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    return (half_tr - rad) * scale


def harris_response(img: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Harris cornerness det - k*trace^2 (cv2.cornerHarris scaling)."""
    a, b, c = structure_tensor(img, block_size)
    scale = 1.0 / (4.0 * 255.0 * block_size) ** 2
    det = a * c - b * b
    tr = a + c
    return (det - k * tr * tr) * scale * scale


class Corners(NamedTuple):
    xy: torch.Tensor  # (..., K, 2) float32 (x, y)
    response: torch.Tensor  # (..., K)
    mask: torch.Tensor  # (..., K) bool


def good_features(
    img: torch.Tensor,
    max_corners: int = 512,
    quality_level: float = 0.01,
    min_distance: int = 7,
    block_size: int = 7,
    exact_topk: bool = False,
) -> Corners:
    """cv2.goodFeaturesToTrack with a static output shape, on (H, W) or
    (B, H, W) images (each image on its own): Shi-Tomasi response, 3x3
    non-max suppression, relative quality threshold, border margin, the
    strongest corner per (min_distance x min_distance) cell, then the
    exact top ``max_corners`` by response (ties to the lower pixel index,
    as ``lax.top_k``; the reference's ``approx_max_k`` is exact off TPU).
    ``exact_topk`` is accepted for the reference's signature and ignored:
    the ranking is always exact."""
    single = img.ndim == 2
    img = (img[None] if single else img).to(torch.float32)
    bsz, h, w = img.shape
    dev = img.device
    resp = min_eig_response(img, block_size)
    # max_pool2d pads with -inf, like reduce_window's init.
    neigh = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    thresh = quality_level * resp.reshape(bsz, -1).amax(dim=1)
    valid = (resp >= neigh) & (resp > thresh[:, None, None])
    margin = max(block_size // 2, 3)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    valid &= (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)

    cell = min_distance if min_distance > 0 else 1
    n_cells = -(-h // cell) * -(-w // cell)
    cell_id = ((yy // cell) * -(-w // cell) + (xx // cell)).reshape(-1)
    neg_inf = torch.full_like(resp, -torch.inf)
    masked = torch.where(valid, resp, neg_inf).reshape(bsz, -1)
    cell_max = torch.full((bsz, n_cells), -torch.inf, device=dev).scatter_reduce(
        1, cell_id.expand(bsz, -1), masked, "amax", include_self=False
    )
    valid = valid.reshape(bsz, -1) & (masked >= cell_max[:, cell_id]) & torch.isfinite(masked)

    flat = torch.where(valid, resp.reshape(bsz, -1), neg_inf.reshape(bsz, -1))
    k_eff = min(max_corners, h * w)
    top_resp, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_resp, top_idx = top_resp[:, :k_eff], top_idx[:, :k_eff]
    if k_eff < max_corners:
        top_resp = F.pad(top_resp, (0, max_corners - k_eff), value=-torch.inf)
        top_idx = F.pad(top_idx, (0, max_corners - k_eff))
    xy = torch.stack([(top_idx % w).to(torch.float32), (top_idx // w).to(torch.float32)], dim=-1)
    mask = torch.isfinite(top_resp)
    out = Corners(xy=xy, response=torch.where(mask, top_resp, torch.zeros_like(top_resp)), mask=mask)
    return Corners(*(t[0] for t in out)) if single else out
