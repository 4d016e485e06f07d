"""The plain reference of pass 2's enhanced keyframes.

From the raw uint8 frames the benchmark made, it forms a keyframe as pass 2
takes it and enhances it: grey keyframes are the BT.601 luma in 8.8 fixed
point of every ``scale``-th pixel, then CLAHE; colour keyframes are every
``scale``-th BGR pixel, CLAHE on the L of CIE LAB, back to BGR, then the
BT.601 luma (OpenCV's ``increaseContrast`` and ``cvtColor``). CLAHE uses
OpenCV's integer clip-and-redistribute rule on the tile histograms of the
reflect-padded image and blends each pixel through its 2x2 neighbouring
tiles' lookup tables.

``dtype`` is the float type of the arithmetic: the configuration's float32
for the judgement, bfloat16 for the control. Plain PyTorch; nothing of the
program is imported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["keyframe", "grey_keyframe", "colour_keyframe", "clahe", "enhanced_grey", "enhance"]


def grey_keyframe(frame: np.ndarray, scale: int) -> np.ndarray:
    """(H, W, 3) BGR or (H, W) grey uint8 -> (H // scale, W // scale) uint8:
    ``(29 B + 150 G + 77 R) >> 8`` of every ``scale``-th pixel."""
    frame = np.asarray(frame)
    if frame.ndim == 2:
        frame = np.repeat(frame[..., None], 3, axis=-1)
    oh, ow = frame.shape[0] // scale, frame.shape[1] // scale
    small = frame[: oh * scale : scale, : ow * scale : scale].astype(np.int32)
    return ((29 * small[..., 0] + 150 * small[..., 1] + 77 * small[..., 2]) >> 8).astype(np.uint8)


def colour_keyframe(frame: np.ndarray, scale: int) -> np.ndarray:
    """(H, W, 3) BGR or (H, W) grey uint8 -> every ``scale``-th pixel, BGR."""
    frame = np.asarray(frame)
    if frame.ndim == 2:
        frame = np.repeat(frame[..., None], 3, axis=-1)
    oh, ow = frame.shape[0] // scale, frame.shape[1] // scale
    return np.ascontiguousarray(frame[: oh * scale : scale, : ow * scale : scale])


def keyframe(frame: np.ndarray, scale: int, grey: bool) -> np.ndarray:
    return grey_keyframe(frame, scale) if grey else colour_keyframe(frame, scale)


def _tile_luts(vals, clip_limit, tiles, th, tw, dtype):
    """(B, Hp, Wp) integer bins -> (B, ty*tx, 256) lookup tables."""
    b = vals.shape[0]
    ty, tx = tiles
    dev = vals.device
    tile_row = torch.arange(th * ty, device=dev) // th
    tile_col = torch.arange(tw * tx, device=dev) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]
    flat = (torch.arange(b, device=dev)[:, None, None] * (ty * tx) + tile_id) * 256 + vals
    hist = torch.bincount(flat.reshape(-1), minlength=b * ty * tx * 256).reshape(b, ty * tx, 256).to(dtype)
    area = float(th * tw)
    clip = max(1.0, float(int(clip_limit * area / 256.0)))
    excess = torch.clamp(hist - clip, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip)
    redist = torch.floor(excess / 256.0)
    residual = excess - redist * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)), min=1.0)
    bins = torch.arange(256, dtype=dtype, device=dev)
    bonus = ((torch.remainder(bins, step) == 0) & (bins / step < residual)).to(dtype)
    cdf = torch.cumsum(hist + redist + bonus, dim=-1)
    return torch.clamp(torch.round(cdf * torch.tensor(255.0 / area, dtype=dtype, device=dev)), 0.0, 255.0)


def _interp(n: int, t: int, n_tiles: int, device, dtype):
    """Per pixel along one axis: (lower tile, upper tile, upper weight)."""
    f = torch.arange(n, dtype=dtype, device=device) / t - 0.5
    i0 = torch.floor(f)
    wgt = f - i0
    i0 = i0.to(torch.int64)
    return torch.clamp(i0, 0, n_tiles - 1), torch.clamp(i0 + 1, 0, n_tiles - 1), wgt


def clahe(img: torch.Tensor, clip_limit: float = 3.5, tiles: Tuple[int, int] = (8, 8), dtype=torch.float32):
    """CLAHE of (B, H, W) values in [0, 255], in ``dtype``."""
    img = img.to(dtype)
    h, w = img.shape[-2:]
    ty, tx = tiles
    th, tw = -(-h // ty), -(-w // tx)
    # Reflect padding only moves values: it runs in float32 where the
    # device has no bfloat16 padding.
    pad_type = torch.float32 if dtype == torch.bfloat16 else dtype
    padded = F.pad(img[:, None].to(pad_type), (0, tw * tx - w, 0, th * ty - h), mode="reflect")[:, 0]
    vals = torch.round(torch.clamp(padded, 0.0, 255.0)).to(torch.int64)
    lut = _tile_luts(vals, clip_limit, tiles, th, tw, dtype)
    v = torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.int64)
    y0, y1, wy = _interp(h, th, ty, img.device, dtype)
    x0, x1, wx = _interp(w, tw, tx, img.device, dtype)
    bidx = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def lookup(ti, tj):
        return lut[bidx, (ti[:, None] * tx + tj[None, :])[None], v]

    wy = wy[None, :, None]
    wx = wx[None, None, :]
    return (1.0 - wy) * ((1.0 - wx) * lookup(y0, x0) + wx * lookup(y0, x1)) + wy * (
        (1.0 - wx) * lookup(y1, x0) + wx * lookup(y1, x1)
    )


# sRGB (D65) <-> XYZ and the D65 white point, as in OpenCV's Lab conversion.
_RGB2XYZ = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169), (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556), (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)


def _matvec3(m, v):
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[i][0] * c0 + m[i][1] * c1 + m[i][2] * c2 for i in range(3)], dim=-1)


def _bgr_to_lab(bgr):
    """cv2.COLOR_BGR2LAB for 8-bit images: L in [0, 255], a and b offset by
    128."""
    v = bgr.flip(-1) / 255.0
    rgb = torch.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)
    xyz = _matvec3(_RGB2XYZ, rgb)

    def f(t):
        return torch.where(t > 0.008856, torch.clamp(t, min=0.0) ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xyz[..., 0] / _WHITE[0]), f(xyz[..., 1] / _WHITE[1]), f(xyz[..., 2] / _WHITE[2])
    return torch.stack([(116.0 * fy - 16.0) * (255.0 / 100.0), 500.0 * (fx - fy) + 128.0,
                        200.0 * (fy - fz) + 128.0], dim=-1)


def _lab_to_bgr(lab):
    l_star = lab[..., 0] * (100.0 / 255.0)
    fy = (l_star + 16.0) / 116.0
    fx = fy + (lab[..., 1] - 128.0) / 500.0
    fz = fy - (lab[..., 2] - 128.0) / 200.0

    def f_inv(f):
        t = f * f * f
        return torch.where(t > 0.008856, t, (f - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([f_inv(fx) * _WHITE[0], f_inv(fy) * _WHITE[1], f_inv(fz) * _WHITE[2]], dim=-1)
    v = torch.clamp(_matvec3(_XYZ2RGB, xyz), min=0.0)
    rgb = torch.where(v > 0.0031308, 1.055 * v ** (1.0 / 2.4) - 0.055, 12.92 * v)
    return torch.clamp(rgb.flip(-1) * 255.0, 0.0, 255.0)


def enhanced_grey(bgr: torch.Tensor, clip_limit: float = 3.5, tiles=(8, 8), dtype=torch.float32):
    """(B, H, W, 3) BGR -> CLAHE on L of LAB, back to BGR, BT.601 luma."""
    lab = _bgr_to_lab(bgr.to(dtype))
    l_eq = clahe(lab[..., 0].contiguous(), clip_limit, tiles, dtype)
    out = _lab_to_bgr(torch.cat([l_eq[..., None], lab[..., 1:]], dim=-1))
    return 0.114 * out[..., 0] + 0.587 * out[..., 1] + 0.299 * out[..., 2]


def enhance(keyframes: np.ndarray, clip_limit: float, tiles, device, dtype=torch.float32) -> torch.Tensor:
    """Pass 2's enhance of a stack of keyframes from :func:`keyframe`: grey
    (B, H, W) through CLAHE, BGR (B, H, W, 3) through :func:`enhanced_grey`."""
    x = torch.from_numpy(np.ascontiguousarray(keyframes)).to(device)
    if x.ndim == 3:
        return clahe(x, clip_limit, tuple(tiles), dtype)
    return enhanced_grey(x, clip_limit, tuple(tiles), dtype)
