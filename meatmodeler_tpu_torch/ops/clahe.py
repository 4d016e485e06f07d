"""CLAHE — contrast-limited adaptive histogram equalization (torch twin of
``meatmodeler_tpu/ops/clahe.py``).

``clahe(img)`` dispatches on the tensor's device, the counterpart of the
reference's backend dispatch (``LAST_PATH``): a CUDA tensor goes to the
hand-written kernels in ``clahe_cuda`` (which count their launches), a CPU
tensor to ``clahe_reference``, the plain PyTorch version of ``clahe_xla``.
There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.ops import color

__all__ = [
    "clahe", "clahe_reference", "lut_reference", "apply_reference", "tile_geometry",
    "enhance_contrast_bgr", "enhanced_grey",
]


def tile_geometry(h: int, w: int, tiles: Tuple[int, int]):
    """(th, tw): tile size after reflect-padding (h, w) up to the grid."""
    ty, tx = tiles
    return -(-h // ty), -(-w // tx)


def clahe(img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on (..., H, W) images with values in [0, 255]; float32 out."""
    if img.is_cuda:
        from meatmodeler_tpu_torch.ops import clahe_cuda

        return clahe_cuda.clahe_cuda(img, clip_limit=clip_limit, tiles=tiles)
    if img.device.type != "cpu":
        raise ValueError(f"clahe: unsupported device {img.device}")
    return clahe_reference(img, clip_limit=clip_limit, tiles=tiles)


def _tile_luts(vals: torch.Tensor, clip_limit: float, tiles, th: int, tw: int) -> torch.Tensor:
    """(B, Hp, Wp) integer bins of the padded image -> (B, ty*tx, 256) LUTs,
    with OpenCV's integer clip + redistribution rule (see ``clahe_xla``)."""
    b = vals.shape[0]
    ty, tx = tiles
    dev = vals.device
    tile_row = torch.arange(th * ty, device=dev) // th
    tile_col = torch.arange(tw * tx, device=dev) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]
    flat = (torch.arange(b, device=dev)[:, None, None] * (ty * tx) + tile_id) * 256 + vals
    hist = torch.bincount(flat.reshape(-1), minlength=b * ty * tx * 256)
    hist = hist.reshape(b, ty * tx, 256).to(torch.float32)

    area = float(th * tw)
    clip = max(1.0, float(int(clip_limit * area / 256.0)))
    excess = torch.clamp(hist - clip, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip)
    redist = torch.floor(excess / 256.0)
    residual = excess - redist * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)), min=1.0)
    bins = torch.arange(256, dtype=torch.float32, device=dev)
    bonus = ((torch.remainder(bins, step) == 0) & (bins / step < residual)).to(torch.float32)
    cdf = torch.cumsum(hist + redist + bonus, dim=-1)
    # An explicit f32 scale: the product is the same IEEE f32 multiply as
    # the reference's and the CUDA kernel's, so the rounding never differs.
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=dev)
    return torch.clamp(torch.round(cdf * scale), 0.0, 255.0)


def _interp_coords(n: int, t: int, n_tiles: int, device):
    """Per-pixel (lower tile, upper tile, upper weight) along one axis:
    f = x / t - 0.5, clamped to the tile grid (border tiles take the
    out-of-range weight)."""
    f = torch.arange(n, dtype=torch.float32, device=device) / t - 0.5
    i0 = torch.floor(f)
    wgt = f - i0
    i0 = i0.to(torch.int64)
    return torch.clamp(i0, 0, n_tiles - 1), torch.clamp(i0 + 1, 0, n_tiles - 1), wgt


def lut_reference(img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Plain version of ``clahe_lut_kernel``: (B, H, W) -> (B, ty*tx, 256)
    tile LUTs of the reflect-padded image, histograms by ``bincount``."""
    h, w = img.shape[-2:]
    ty, tx = tiles
    th, tw = tile_geometry(h, w, tiles)
    padded = F.pad(img[:, None], (0, tw * tx - w, 0, th * ty - h), mode="reflect")[:, 0]
    vals = torch.round(torch.clamp(padded, 0.0, 255.0)).to(torch.int64)
    return _tile_luts(vals, clip_limit, tiles, th, tw)


def apply_reference(img: torch.Tensor, lut: torch.Tensor, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Plain version of ``clahe_apply_kernel``: blend each pixel's value
    through the LUTs of its 2x2 neighbouring tiles (a direct gather, no
    one-hot matmul)."""
    h, w = img.shape[-2:]
    ty, tx = tiles
    th, tw = tile_geometry(h, w, tiles)
    v = torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.int64)
    y0, y1, wy = _interp_coords(h, th, ty, img.device)
    x0, x1, wx = _interp_coords(w, tw, tx, img.device)
    bidx = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def lookup(ti, tj):
        return lut[bidx, (ti[:, None] * tx + tj[None, :])[None], v]

    wy = wy[None, :, None]
    wx = wx[None, None, :]
    return (1.0 - wy) * ((1.0 - wx) * lookup(y0, x0) + wx * lookup(y0, x1)) + wy * (
        (1.0 - wx) * lookup(y1, x0) + wx * lookup(y1, x1)
    )


def clahe_reference(
    img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)
) -> torch.Tensor:
    """Plain PyTorch CLAHE: the twin of ``clahe_xla`` and the oracle the
    CUDA kernels are held to."""
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(-1, h, w).to(torch.float32)
    out = apply_reference(flat, lut_reference(flat, clip_limit, tiles), tiles)
    return out.reshape(*batch_shape, h, w)


def enhance_contrast_bgr(bgr: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """The reference's ``increaseContrast``: CLAHE on the L channel of LAB,
    back to BGR. (..., H, W, 3) in, float32 (..., H, W, 3) out."""
    lab = color.bgr_to_lab(bgr)
    l_eq = clahe(lab[..., 0].contiguous(), clip_limit=clip_limit, tiles=tiles)
    return color.lab_to_bgr(torch.cat([l_eq[..., None], lab[..., 1:]], dim=-1))


def enhanced_grey(bgr: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """``increaseContrast`` then BT.601 grey: the pass-2 ``bgr_lab`` enhance."""
    return color.bgr_to_grey(enhance_contrast_bgr(bgr, clip_limit, tiles))
